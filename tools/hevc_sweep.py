"""A random sweep of the HEVC test-stream writer's options, each stream
decoded by the port and by cv2.VideoCapture and compared bit for bit, with
cv2's frame count, fps and size.

Where FFmpeg departs from the standard, only its frames tell, and the named
feature sets of tests/test_torch_hevc.py hold two seeds each: this draws
configurations (CTB and coding block sizes, POCs out of decode order, IRAP
kinds, slices, deblocking and SAO, weights, list modification, TMVP, the
residual tools, ...) from a seed, on top of the writer's own per-stream
draws, and prints one line a stream, then the count of mismatches. Run on
the CPU:

    python tools/hevc_sweep.py --seed 1 --configs 100
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

from monohair_tpu_torch.io.hevc_streams import write_random  # noqa: E402
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
    f = dict(ctb=rnd.choice([16, 32, 64]), refs=rnd.choice([1, 2, 3, 4]),
             group=rnd.choice([1, 1, 2, 3, 4]))
    n = rnd.choice([6, 10])
    for share, extra in ((0.3, dict(slices=rnd.choice([2, 4, 6]))), (0.3, dict(deblock=1)),
                         (0.3, dict(sao=1)), (0.2, dict(min_cb=16)), (0.3, dict(amp=1)),
                         (0.2, dict(weighted=1)), (0.3, dict(list_mod=1, mod_share=0.8)),
                         (0.3, dict(tmvp=1)), (0.2, dict(gop=rnd.choice([3, 4]))),
                         (0.2, dict(cra=rnd.choice([1, 2, 3]))), (0.2, dict(nonref=0.3)),
                         (0.2, dict(output_flag=1)), (0.2, dict(no_output_prior=0.5)),
                         (0.2, dict(scaling=1)), (0.2, dict(pcm=1, pcm_share=0.1)),
                         (0.2, dict(bypass=1)), (0.2, dict(cu_qp_delta=1)),
                         (0.2, dict(transform_skip=1, sign_hiding=1)),
                         (0.2, dict(chroma_offsets=1)), (0.1, dict(intra_only=1)),
                         (0.2, dict(sps_rps=rnd.choice([0, 2, 4]))), (0.1, dict(hev1=1)),
                         (0.1, dict(poc_bits=4))):
        if rnd.random() < share:
            f.update(extra)
    size = rnd.choice([(72, 40), (64, 48), (32, 32), (136, 72), (96, 64)])
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
    with tempfile.TemporaryDirectory(prefix="hevc_sweep_") as tmp:
        path = os.path.join(tmp, "s.mp4")
        for k in range(args.configs):
            size, n, features = draw(rnd)
            for j in range(args.seeds):
                bad += not check(path, size, n, 10 * k + j, features)
    print(f"{bad} of {args.configs * args.seeds} streams differ from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
