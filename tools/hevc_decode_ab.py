"""The host decode's ms a frame of chip_smoke.py's phase-14e HEVC streams with
and without the parallel tools, in turns in one process: the HEVC_FRAMES of
1920x1080 I/P/B in x265's GOP shape with WPP (chip_smoke.HEVC_B) and without
it, and the first 10 as I/P in 4x3 tiles with dependent slice segments
(chip_smoke.HEVC_TILES) and without them. Each stream is decoded --repeats
times; prints each run, the best of each stream and the ratios of the bests.
The frames are rendered on --device (14b's orbit); the decode is host C++:

    python tools/hevc_decode_ab.py --device cuda --repeats 5
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from monohair_tpu_torch.io import hevc_streams  # noqa: E402
from monohair_tpu_torch.io import video as video_io  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    H, W = c.CODEC_SIZES[0]
    frames, _ = c.sharp_orbit_frames(torch.device(args.device), H, W)
    b_plain = {k: v for k, v in c.HEVC_B.items() if k != "wpp"}
    streams = {"ipb": (c.HEVC_FRAMES, b_plain), "ipb_wpp": (c.HEVC_FRAMES, c.HEVC_B),
               "ip": (c.HEVC_TILES_FRAMES, {}), "ip_tiles": (c.HEVC_TILES_FRAMES, c.HEVC_TILES)}
    best = {}
    with tempfile.TemporaryDirectory(prefix="hevc_ab_") as tmp:
        for name, (n, features) in streams.items():
            hevc_streams.write_frames(os.path.join(tmp, name + ".mp4"), frames[:n], fps=c.VIDEO_FPS,
                                      qp=c.HEVC_QP, ctb=c.HEVC_CTB, **features)
        runs = {name: [] for name in streams}
        for _ in range(args.repeats):
            for name, (n, _) in streams.items():
                t = time.perf_counter()
                with video_io.VideoReader(os.path.join(tmp, name + ".mp4")) as reader:
                    got = sum(1 for _ in reader)
                runs[name].append((time.perf_counter() - t) / got * 1e3)
                if got != n:
                    raise AssertionError(f"{name}: {got} frames decoded of {n}")
    for name, ms in runs.items():
        best[name] = min(ms)
        print(f"{name}: ms a frame {' '.join(f'{v:.3f}' for v in ms)}; best {best[name]:.3f}")
    print(f"WPP / without: {best['ipb_wpp'] / best['ipb']:.4f}; "
          f"tiles / without: {best['ip_tiles'] / best['ip']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
