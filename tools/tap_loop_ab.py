#!/usr/bin/env python3
"""Time this checkout's tap-loop kernel against another checkout's, in turns on one card.

    python3 tools/tap_loop_ab.py OTHER_CHECKOUT

Builds OTHER_CHECKOUT/monohair_tpu_torch/csrc/patch_kernels.cu with this
checkout's nvcc flags, loads both libraries and runs their patch_min_loss on
the same inputs: chip_smoke.py's random windows (S=90 with tied windows, as
the kernel table is timed, and S=90 and S=1 with tied and near-tie windows)
and the 8 tap-loop calls of one 8192-point pmvo_forward chunk of
chip_smoke.py's head scene. On each input the two kernels must agree (counts
exact, sums within rtol 1e-5/atol 1e-6); then each is timed with CUDA events
in the order other, this, this, other. Prints the card's name and power limit
and one JSON line of milliseconds per call. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from monohair_tpu_torch.ops import _build  # noqa: E402
from monohair_tpu_torch.ops import patch_kernels as pk  # noqa: E402
from monohair_tpu_torch.pmvo import solver  # noqa: E402
from monohair_tpu_torch.pmvo.driver import auto_chunk, filter_raw_points  # noqa: E402


def build_other(checkout: str) -> ctypes.CDLL:
    src = os.path.join(checkout, "monohair_tpu_torch", "csrc", pk.SOURCE)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "patch_kernels-other.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  other ptxas {line.strip()}", flush=True)
    other = ctypes.CDLL(str(lib))
    mine = pk._lib()
    other.patch_min_loss.argtypes = mine.patch_min_loss.argtypes
    other.patch_min_loss.restype = mine.patch_min_loss.restype
    return other


def launcher(lib: ctypes.CDLL):
    """patch_min_loss through `lib`, with the wrapper's C call and no checks."""
    def run(prj, ori, conf, vis, thr):
        V, N, S, _ = prj.shape
        out = [torch.empty((N, S), device=prj.device) for _ in range(3)]
        err = lib.patch_min_loss(prj.data_ptr(), ori.data_ptr(), conf.data_ptr(),
                                 vis.data_ptr(), float(thr),
                                 *(t.data_ptr() for t in out), V, N, S, ori.shape[2],
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"patch_min_loss launch failed: CUDA error {err}")
        return out
    return run


def compare(calls, other, this, what: str) -> dict:
    for args in calls:
        a, b = other(*args), this(*args)
        torch.cuda.synchronize()
        for x, y in zip(a[:2], b[:2]):
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{what}: the kernels disagree: {m}")
        if not torch.equal(a[2], b[2]):
            raise AssertionError(f"{what}: the kernels' counts differ")

    def timed(fn):
        return cs.cuda_time_ms(lambda: [fn(*args) for args in calls]) / len(calls)

    o1, t1, t2, o2 = (timed(f) for f in (other, this, this, other))
    cs.log(f"{what}: other {o1:.4f} / {o2:.4f} ms, this {t1:.4f} / {t2:.4f} ms per call")
    return dict(other_ms=[o1, o2], this_ms=[t1, t2])


def scene_calls(dev: torch.device) -> list:
    """The tap-loop arguments of one 8192-point line-search chunk of the head scene."""
    maps, points = cs.head_scene(dev, cs.FULL_WIDTH_POINTS // 4, 1920, 1080, 16)
    surface, _ = filter_raw_points(maps, points, cs.PATCH, cs.CONF_THR, cs.VIS_THR)
    chunk = torch.as_tensor(points[surface][:auto_chunk(16)], device=dev)
    with cs.recorded_min_loss_calls() as calls:
        solver.pmvo_forward(maps, chunk, cs.PATCH, cs.CONF_THR)
    return calls


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    device = cs.phase_device()
    dev = torch.device("cuda", 0)
    other, this = launcher(build_other(sys.argv[1])), launcher(pk._lib())
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    times = {}
    V, N, S, P = cs.MIN_LOSS_SHAPES[0]
    times[f"random S={S}"] = compare([cs.min_loss_inputs(g, V, N, S, P, near_ties=False)],
                                     other, this, f"random, tied V={V} N={N} S={S} P={P}")
    for (V, N, S, P) in cs.MIN_LOSS_SHAPES:
        times[f"near ties S={S}"] = compare([cs.min_loss_inputs(g, V, N, S, P)], other, this,
                                            f"random, tied, near-tie V={V} N={N} S={S} P={P}")
    times["head scene S=90"] = compare(scene_calls(dev), other, this,
                                       "head scene, 8 calls of one chunk")
    print(json.dumps({"device": device, "tap_loop_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
