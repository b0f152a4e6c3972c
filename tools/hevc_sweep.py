"""A random sweep of the HEVC test-stream writer's options, each stream
decoded by the port and by cv2.VideoCapture and compared bit for bit, with
cv2's frame count, fps and size.

Where FFmpeg departs from the standard, only its frames tell, and the named
feature sets of tests/test_torch_hevc.py hold two seeds each: this draws
configurations (CTB and coding block sizes, POCs out of decode order, IRAP
kinds, RASL/RADL leading pictures, B slices with their list 1, mvd_l1_zero
and collocated list, slices, deblocking and SAO, weights and bi-prediction
weights, list modification, TMVP, the residual tools, WPP or tiles and
dependent slice segments, the bit depth (8, 9 or 10) and the chroma
location, ...) from a seed, on
top of the writer's own per-stream draws, and the colours from a generator
of their own (the BT.709 or BT.2020 matrix and primaries, the transfers 1,
6, 14 and 18, the range, an alternative transfer characteristics SEI in
some access units, Dolby Vision 8.4's RPU units and dvvC box), and prints
one line a stream, then the count of mismatches and of the streams that
used WPP, tiles, dependent slice segments, 9 or 10 bits, colour
management and the SEI. A stream whose substreams do not start where its entry points say
counts as a mismatch too. Run on the CPU:

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


def draw_colour(rnd: random.Random) -> dict:
    """The colours of one configuration: BT.709 or BT.2020 matrix and
    primaries, an SDR transfer or HLG, an SEI naming HLG or an SDR transfer,
    Dolby Vision 8.4's signalling."""
    f = {}
    if rnd.random() < 0.6:
        f.update(matrix=rnd.choice([1, 9]), primaries=rnd.choice([1, 9]),
                 transfer=rnd.choice([1, 6, 14, 18]), full_range=int(rnd.random() < 0.3))
    if rnd.random() < 0.3:
        f.update(atc_sei=rnd.choice([18, 18, 14, 1]),
                 atc_aus=rnd.choice(["first", "all", "irap", str(rnd.randrange(4))]))
    if rnd.random() < 0.2:
        f.update(dv_rpu=1, dvcc=8)
    return f


def draw(rnd: random.Random) -> tuple:
    """(size, frames, writer options) of one configuration."""
    f = dict(ctb=rnd.choice([16, 32, 64]), refs=rnd.choice([1, 2, 3, 4]),
             group=rnd.choice([1, 1, 2, 3, 4]))
    n = rnd.choice([6, 10])
    for share, extra in ((0.3, dict(slices=rnd.choice([2, 4, 6]))), (0.3, dict(deblock=1)),
                         (0.3, dict(sao=1)), (0.2, dict(min_cb=16)), (0.3, dict(amp=1)),
                         (0.2, dict(weighted=1)), (0.3, dict(list_mod=1, mod_share=0.8)),
                         (0.3, dict(tmvp=1)), (0.2, dict(gop=rnd.choice([3, 4]))),
                         (0.2, dict(cra=rnd.choice([1, 2, 3, 4]))), (0.2, dict(nonref=0.3)),
                         (0.2, dict(output_flag=1)), (0.2, dict(no_output_prior=0.5)),
                         (0.2, dict(scaling=1)), (0.2, dict(pcm=1, pcm_share=0.1)),
                         (0.2, dict(bypass=1)), (0.2, dict(cu_qp_delta=1)),
                         (0.2, dict(transform_skip=1, sign_hiding=1)),
                         (0.2, dict(chroma_offsets=1)), (0.1, dict(intra_only=1)),
                         (0.2, dict(sps_rps=rnd.choice([0, 2, 4]))), (0.1, dict(hev1=1)),
                         (0.1, dict(poc_bits=4)),
                         (0.5, dict(bslices=rnd.choice([0.3, 0.6, 1.0]))),
                         (0.3, dict(mvd_l1_zero=0.5)), (0.3, dict(col_l1=0.8)),
                         (0.2, dict(chroma_loc_type=rnd.choice(range(7)))),
                         (0.2, dict(weighted_bipred=1)),
                         (0.3, dict(leading=rnd.choice([1, 2, 3]))),
                         (0.3, dict(dependent=rnd.choice([0.3, 0.6, 1.0]),
                                    slices=rnd.choice([3, 6, 10])))):
        if rnd.random() < share:
            f.update(extra)
    size = rnd.choice([(72, 40), (64, 48), (32, 32), (136, 72), (96, 64)])
    # WPP or tiles (the decoder refuses both in one PPS; tiles need two CTBs)
    tool, ctbs = rnd.random(), -(-size[0] // f["ctb"]) * -(-size[1] // f["ctb"])
    if tool < 0.3:
        f.update(wpp=1)
    elif tool < 0.6 and ctbs > 1:
        f.update(tiles=1)
    depth = rnd.random()
    if depth < 0.4:
        f.update(bit_depth=10 if depth < 0.25 else 9)
    return size, n, f


TOOLS = {"wpp": "wpp_pictures", "tiles": "tile_pictures", "dependent": "dependent_slice_segments",
         "9 bits": "pictures_9bit", "10 bits": "pictures_10bit",
         "colour management": "colour_managed_pictures", "the SEI": "alternative_transfer_seis"}


def check(path: str, size, n: int, seed: int, features: dict) -> tuple:
    """Whether the stream decodes as cv2 decodes it, and the tools it used."""
    write_random(path, size, n, seed=seed, **features)
    want, props = cv2_frames(path)
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    same = (len(got) == len(want) and video_info(path) == props
            and all(np.array_equal(a, b) for a, b in zip(got, want))
            and not stats["entry_point_mismatches"])
    print(f"{'OK ' if same else 'BAD'} seed {seed} {size} {n} frames, {len(got)} decoded, "
          f"{len(want)} by cv2: {features}", flush=True)
    return same, {tool for tool, key in TOOLS.items() if stats[key]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="draws the configurations")
    ap.add_argument("--configs", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=2, help="streams a configuration")
    args = ap.parse_args(argv)
    rnd = random.Random(args.seed)
    rnd_colour = random.Random(args.seed ^ 0x5EED)
    bad = 0
    used = dict.fromkeys(TOOLS, 0)
    with tempfile.TemporaryDirectory(prefix="hevc_sweep_") as tmp:
        path = os.path.join(tmp, "s.mp4")
        for k in range(args.configs):
            size, n, features = draw(rnd)
            features.update(draw_colour(rnd_colour))
            for j in range(args.seeds):
                same, tools = check(path, size, n, 10 * k + j, features)
                bad += not same
                for tool in tools:
                    used[tool] += 1
    print(f"{bad} of {args.configs * args.seeds} streams differ from cv2; "
          + ", ".join(f"{v} used {k}" for k, v in used.items()))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
