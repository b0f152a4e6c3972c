"""A random sweep of the H.264 test-stream writer's options, each stream
decoded by the port and by cv2.VideoCapture and compared bit for bit, with
cv2's frame count, fps and size.

Where FFmpeg departs from the standard, only its frames tell, and the named
feature sets of tests/test_torch_h264.py hold two seeds each: this draws
configurations (B pictures, direct modes, weights, MMCOs, slices, ctts, VUI
reorder, ...) from a seed and prints one line a stream, then the count of
mismatches. Run on the CPU:

    python tools/h264_sweep.py --seed 1 --configs 200
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from monohair_tpu_torch.io.h264_streams import write_random  # noqa: E402
from monohair_tpu_torch.io.video import VideoReader, video_info  # noqa: E402


def cv2_frames(path: str):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS),
             int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return frames, props


def draw(rnd: random.Random) -> tuple:
    """(size, frames, writer options) of one configuration."""
    f = dict(bframes=rnd.choice([0, 1, 2, 3]), pyramid=rnd.choice([0, 1]),
             refs=rnd.choice([2, 3, 4]), cabac=rnd.choice([0, 1]),
             direct=rnd.choice(["spatial", "temporal", "mixed"]), direct8x8=rnd.choice([0, 1, 1]),
             bipred_idc=rnd.choice([0, 1, 2]))
    n = rnd.choice([10, 16])
    for share, extra in ((0.3, dict(t8=1)), (0.3, dict(mmco=1)), (0.3, dict(slices=4, deblock=1)),
                         (0.3, dict(pslices=0.3, bslices=0.3)), (0.3, dict(weighted=1)),
                         (0.2, dict(ctts=0)), (0.2, dict(ctts_version=1)), (0.2, dict(nonref=0.3)),
                         (0.2, dict(idr_period=rnd.choice([5, 7]))),
                         (0.2, dict(reorder=rnd.choice([1, 2, 3]))),
                         (0.2, dict(constrained_intra=1))):
        if rnd.random() < share:
            f.update(extra)
    size = rnd.choice([(96, 64), (64, 48), (32, 32), (112, 80)])
    return size, n, f


def check(path: str, size, n: int, seed: int, features: dict) -> bool:
    write_random(path, size, n, seed=seed, **features)
    want, props = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
    same = (len(got) == len(want) and video_info(path) == props
            and all(np.array_equal(a, b) for a, b in zip(got, want)))
    print(f"{'OK ' if same else 'BAD'} seed {seed} {size} {n} frames, {len(got)} decoded, "
          f"{len(want)} by cv2: {features}", flush=True)
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="draws the configurations")
    ap.add_argument("--configs", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=2, help="streams a configuration")
    args = ap.parse_args(argv)
    rnd = random.Random(args.seed)
    bad = 0
    with tempfile.TemporaryDirectory(prefix="h264_sweep_") as tmp:
        path = os.path.join(tmp, "s.mp4")
        for k in range(args.configs):
            size, n, features = draw(rnd)
            for j in range(args.seeds):
                bad += not check(path, size, n, 10 * k + j, features)
    print(f"{bad} of {args.configs * args.seeds} streams differ from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
