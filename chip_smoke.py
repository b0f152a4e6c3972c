#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage 2 (PMVO) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing a line when it starts and when it ends:
  1. device   the card's name, count and power limit (exits non-zero without CUDA)
  2. build    nvcc of monohair_tpu_torch/csrc/patch_kernels.cu, its seconds and
              its -Xptxas -v lines
  3. kernels  each CUDA kernel against its plain PyTorch version on the card at
              the full-width shapes of the stage (the tap loop on random, tied
              and near-tie windows), with CUDA-event times
  4. stage    a synthetic case (128x128, 24 views, patch 3) written to a temp
              directory with the port's writers, then run_pmvo on cuda; the
              refine/{Occ3D,Ori3D}.mat grids are checked against the known wig
  5. width    16 views at 1920x1080, patch 7, through filter_raw_points ->
              optimize_points -> refine_and_voxelize on cuda; the first chunk of
              pmvo_forward is held against the same call with the plain versions;
              the tap loop is held and timed on one chunk's captured inputs

Before the last line it prints one JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}, printed only when every phase passed.
Imports only the standard library, numpy, scipy, torch and monohair_tpu_torch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from monohair_tpu_torch.io.mat_io import load_occ_mat, load_ori_mat
from monohair_tpu_torch.ops import _build
from monohair_tpu_torch.ops import patch_kernels as pk
from monohair_tpu_torch.pipeline.common import case_paths
from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
from monohair_tpu_torch.pmvo import solver
from monohair_tpu_torch.pmvo.driver import (auto_chunk, filter_raw_points,
                                            optimize_points, refine_and_voxelize)
from monohair_tpu_torch.synthetic import (analytic_head_maps, cameras_numpy,
                                          head_camera_list, shell_points,
                                          swirl_direction, write_synthwig_case)

# Phase 5 point count: a quarter of big_wavy1's 2.1 M raw points.
FULL_WIDTH_POINTS = 524_288
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM data sheet

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"phase {self.name}: {status} in {time.perf_counter() - self.t:.2f}s")
        return False


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(f"device: {name}, count {count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return {"platform": "gpu", "kind": name, "count": count}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_build() -> None:
    pk._lib()
    info = _build.BUILD_INFO[pk.SOURCE]
    log(f"nvcc {pk.SOURCE}: {info['seconds']:.2f}s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas {line.strip()}", flush=True)


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def gather_bound(padded: torch.Tensor, rc: torch.Tensor, patch: int):
    """(bound_ms, bound_by): unique map pixels the windows touch read once,
    centres read once, windows written once, over the HBM rate."""
    V, Hp, Wp, C = padded.shape
    offs = torch.arange(patch, device=rc.device)
    rows = rc[..., 0:1].long() + offs.repeat_interleave(patch)
    cols = rc[..., 1:2].long() + offs.repeat(patch)
    flat = (torch.arange(V, device=rc.device)[:, None, None] * Hp + rows) * Wp + cols
    touched = int(torch.unique(flat).numel())
    out_bytes = rc.shape[0] * rc.shape[1] * patch * patch * C * 4
    nbytes = touched * C * 4 + rc.numel() * 4 + out_bytes
    return nbytes / H100_BYTES_PER_S * 1e3, "bytes"


def min_loss_bound(V: int, N: int, S: int, P: int):
    """(bound_ms, bound_by) of the tap loop: inputs read once, outputs written
    once; 9 f32 operations per (v, n, s, tap) (dot 3, |o||d| 1, max 1, abs 1,
    divide 1, 1-x 1, compare 1), 4 per (v, n, tap) for |o|, 7 per (v, n, s)
    for |d| and the three sums."""
    nbytes = 4 * (V * N * S * 2 + V * N * P * 2 + V * N * P + V * N + 3 * N * S)
    ops = 9 * V * N * S * P + 4 * V * N * P + 7 * V * N * S
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nudge_ulps(x: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """x with each element moved 1-3 ulps up or down."""
    steps = torch.randint(1, 4, x.shape, generator=g, device=x.device)
    toward = torch.where(torch.rand(x.shape, generator=g, device=x.device) > 0.5,
                         math.inf, -math.inf)
    for i in range(3):
        x = torch.where(steps > i, torch.nextafter(x, toward), x)
    return x


# the tap loop as pmvo_forward calls it and as the refine pass does
MIN_LOSS_SHAPES = [(16, 8192, 90, 49), (16, 65536, 1, 49)]


def min_loss_inputs(g: torch.Generator, V: int, N: int, S: int, P: int,
                    near_ties: bool = True) -> tuple:
    """Random tap-loop arguments on g's device, with tied windows and, unless
    near_ties is False (the inputs the kernel table is timed on), near-tie
    windows."""
    dev = g.device
    prj = torch.randn((V, N, S, 2), generator=g, device=dev)
    ori = torch.randn((V, N, P, 2), generator=g, device=dev)
    conf = torch.rand((V, N, P), generator=g, device=dev)
    # tied taps: every 7th point repeats tap 0 across its window
    ori[:, ::7] = ori[:, ::7, :1]
    # near ties: the taps of the points 3 past those are tap 0 moved by
    # 1-3 ulps, so rounded quotients tie where the exact ones do not
    if near_ties:
        ori[:, 3::7, 1:] = nudge_ulps(ori[:, 3::7, :1].expand(-1, -1, P - 1, -1), g)
    vis = torch.where(torch.rand((V, N), generator=g, device=dev) > 0.3,
                      torch.rand((V, N), generator=g, device=dev), -1.0)
    vis[:, ::11] = -1.0                       # points seen by no view
    return prj, ori, conf, vis, 0.15


def check_min_loss(args, what: str) -> float:
    """The tap-loop kernel against its plain version on the same inputs:
    num and den within rtol 1e-5/atol 1e-6 (view sums in another order),
    counts exact. Returns the largest absolute error."""
    k = pk.patch_min_loss(*args)
    p = pk.patch_min_loss_plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("num", "den"), k, p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   msg=lambda m, name=name: f"patch_min_loss {name} ({what}): {m}")
        worst = max(worst, (a - b).abs().max().item())
    if not torch.equal(k[2], p[2]):
        raise AssertionError(f"patch_min_loss ({what}): positive counts differ")
    return worst


def phase_kernels(dev: torch.device) -> dict:
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    results = {}

    # patch_gather at the stage's full width: 16 views of 1920x1080, patch 7
    V, H, W, patch, N = 16, 1920, 1080, 7, 8192
    half = patch // 2
    padded = torch.randn((V, H + 2 * half, W + 2 * half, 8), generator=g, device=dev)
    rc = torch.stack([torch.randint(0, H, (V, N), generator=g, device=dev),
                      torch.randint(0, W, (V, N), generator=g, device=dev)], -1)
    rc[:, :4] = torch.tensor([[0, 0], [H - 1, W - 1], [0, W - 1], [H - 1, 0]],
                             device=dev)
    rc = rc.to(torch.int32).contiguous()
    out_k = pk.patch_gather(padded, rc, patch)
    out_p = pk.patch_gather_plain(padded, rc, patch)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        bad = (out_k != out_p).sum().item()
        raise AssertionError(f"patch_gather: {bad} elements differ from the plain version")
    ms = cuda_time_ms(lambda: pk.patch_gather(padded, rc, patch))
    plain_ms = cuda_time_ms(lambda: pk.patch_gather_plain(padded, rc, patch))
    bound_ms, bound_by = gather_bound(padded, rc, patch)
    log(f"patch_gather V={V} N={N} p={patch}: bit-exact; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    results["patch_gather"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
    del padded, out_k, out_p

    # checked on random, tied and near-tie windows; the table's time is the
    # forward's (S=90) on random and tied windows
    worst = 0.0
    for (V, N, S, P) in MIN_LOSS_SHAPES:
        args = min_loss_inputs(g, V, N, S, P)
        worst = max(worst, check_min_loss(args, f"S={S}"))
        near_ms = cuda_time_ms(lambda: pk.patch_min_loss(*args))
        log(f"patch_min_loss V={V} N={N} S={S} P={P} (random, tied, near-tie windows): "
            f"within rtol 1e-5/atol 1e-6, counts exact, max abs err {worst:.3g}; "
            f"kernel {near_ms:.4f} ms")
        del args
        if S == 90:
            args = min_loss_inputs(g, V, N, S, P, near_ties=False)
            worst = max(worst, check_min_loss(args, f"S={S}, no near ties"))
            ms = cuda_time_ms(lambda: pk.patch_min_loss(*args))
            plain_ms = cuda_time_ms(lambda: pk.patch_min_loss_plain(*args), iters=20)
            bound_ms, bound_by = min_loss_bound(V, N, S, P)
            log(f"patch_min_loss timed (random, tied windows): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            results["patch_min_loss"] = dict(ms=ms, plain_ms=plain_ms,
                                             bound_ms=bound_ms, bound_by=bound_by)
            del args
    results["patch_min_loss"]["max_abs_err"] = worst
    log(f"launch counts during the comparisons: {dict(pk.LAUNCHES)}")
    return results


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

WIG_DIRECTION = np.array([0.0, -1.0, 0.0])


def phase_stage(device: str, num_views: int = 24) -> dict:
    """Write the synthwig case with the port's writers and run the stage CLI's
    run_pmvo on it; check the written grids against the known wig direction."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_case_") as tmp:
        cfg = case_paths(write_synthwig_case(tmp, num_views=num_views))
        log(f"synthwig case: {num_views} views of 128x128, patch "
            f"{cfg.PMVO.patch_size}, written to {cfg.data.root}")
        pk.reset_launch_counts()
        steps = run_pmvo(cfg, device=device)
        launches = dict(pk.LAUNCHES)
        refine = os.path.join(cfg.output_path, "refine")
        occ = load_occ_mat(os.path.join(refine, "Occ3D.mat"))
        ori = load_ori_mat(os.path.join(refine, "Ori3D.mat"))
    if occ.shape != (256, 256, 192) or ori.shape != (256, 256, 192, 3):
        raise AssertionError(f"grid shapes {occ.shape} {ori.shape}")
    if not (np.isfinite(occ).all() and np.isfinite(ori).all()):
        raise AssertionError("non-finite values in the written grids")
    occupied = occ > 0
    med = float(np.median(np.abs(ori[occupied] @ WIG_DIRECTION))) if occupied.any() else 0.0
    log(f"synthwig: {int(occupied.sum())} occupied voxels, median |cos| to (0,-1,0) "
        f"{med:.6f}, launches {launches}, steps {steps}")
    if occupied.sum() < 100 or med <= 0.95:
        raise AssertionError(f"synthwig grids wrong: {int(occupied.sum())} voxels, "
                             f"median |cos| {med}")
    if device != "cpu" and min(launches.values()) == 0:
        raise AssertionError(f"the stage did not launch every kernel: {launches}")
    return dict(occupied=int(occupied.sum()), median_cos=med, launches=launches,
                steps=steps)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions():
    """Route the solver through the plain PyTorch versions (a comparison on the
    card; the package itself has no such switch)."""
    saved = solver.patch_gather, solver.patch_min_loss_kernel
    solver.patch_gather = pk.patch_gather_plain
    solver.patch_min_loss_kernel = pk.patch_min_loss_plain
    try:
        yield
    finally:
        solver.patch_gather, solver.patch_min_loss_kernel = saved


@contextlib.contextmanager
def recorded_min_loss_calls():
    """Record the arguments of every tap-loop call the solver makes."""
    calls, saved = [], solver.patch_min_loss_kernel

    def record(*args):
        calls.append(args)
        return saved(*args)

    solver.patch_min_loss_kernel = record
    try:
        yield calls
    finally:
        solver.patch_min_loss_kernel = saved


PATCH, CONF_THR, VIS_THR, THRESHOLD = 7, 0.15, 1.0, 0.025   # bench.py's stage 2


def head_scene(dev: torch.device, n_points: int, H: int, W: int, views: int):
    """bench.py's stage-2 scene: (maps on dev, raw shell points)."""
    t = time.perf_counter()
    ndc, w2c = cameras_numpy(head_camera_list(views))
    maps = solver.PMVOMaps.from_numpy(ndc, w2c, *analytic_head_maps(ndc, w2c, H, W), dev)
    points = shell_points(np.random.default_rng(0), n_points)
    log(f"head scene: {views} views of {H}x{W}, {n_points} shell points, "
        f"chunk {auto_chunk(views)}; made in {time.perf_counter() - t:.2f}s")
    return maps, points


def chunk_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds of fn() between two device synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def phase_full_width(dev: torch.device, n_points: int = FULL_WIDTH_POINTS,
                     H: int = 1920, W: int = 1080, views: int = 16) -> dict:
    patch, conf_thr, vis_thr, threshold = PATCH, CONF_THR, VIS_THR, THRESHOLD
    maps, points = head_scene(dev, n_points, H, W, views)

    on_card = dev.type == "cuda"    # the CPU takes the plain versions (rehearsals)
    pk.reset_launch_counts()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    steps = {}
    t = time.perf_counter()
    surface, filt = filter_raw_points(maps, points, patch, conf_thr, vis_thr)
    steps["filter"] = time.perf_counter() - t
    t = time.perf_counter()
    pts, ori, loss, _ = optimize_points(maps, points[surface], patch, conf_thr)
    steps["optimize"] = time.perf_counter() - t
    t = time.perf_counter()
    occ, ori_grid = refine_and_voxelize(maps, pts, ori, loss, points[filt], patch,
                                        conf_thr, vis_thr, threshold)
    if on_card:
        torch.cuda.synchronize(dev)
    steps["refine"] = time.perf_counter() - t
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    total = sum(steps.values())
    n_surf = int(surface.sum())
    log(f"full width: {n_surf} surface + {int(filt.sum())} near-surface of {n_points}; "
        f"steps {json.dumps({k: round(v, 4) for k, v in steps.items()})}")
    log(f"full width: optimize {n_surf / steps['optimize']:.1f} points/s, "
        f"whole stage {n_points / total:.1f} raw points/s, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {launches}")
    if n_surf == 0 or not np.isfinite(ori).all() or not np.isfinite(loss).all():
        raise AssertionError("full width: no surface points or non-finite results")
    occupied = occ > 0
    if occupied.sum() == 0 or not np.isfinite(ori_grid).all():
        raise AssertionError("full width: empty or non-finite grids")
    swirl = float(np.median(np.abs(np.sum(ori * swirl_direction(pts), -1))))
    log(f"full width: {int(occupied.sum())} occupied voxels; median |cos| of the "
        f"optimized directions to the scene's swirl field {swirl:.4f}")
    if swirl < 0.8:
        raise AssertionError(f"full width: directions do not follow the scene ({swirl})")
    if on_card and min(launches.values()) == 0:
        raise AssertionError(f"the full-width path did not launch every kernel: {launches}")

    # the first 2048 surface points through pmvo_forward, kernels vs plain
    first = torch.as_tensor(pts[:2048], device=dev)
    k_out = solver.pmvo_forward(maps, first, patch, conf_thr)
    with plain_versions():
        p_out = solver.pmvo_forward(maps, first, patch, conf_thr)
    cos = torch.abs(torch.sum(k_out[1] * p_out[1], -1))
    agree = cos > 0.999
    share = agree.float().mean().item()
    loss_err = (k_out[2] - p_out[2]).abs()[agree].max().item() if agree.any() else math.inf
    log(f"full width: pmvo_forward kernels vs plain on {first.shape[0]} points: "
        f"{share * 100:.3f}% with |cos| > 0.999, max |min_loss diff| {loss_err:.3g} there")
    if share < 0.99 or loss_err > 1e-5:
        raise AssertionError("full width: kernels and plain versions disagree")
    result = dict(steps=steps, launches=launches, peak_bytes=peak, surface=n_surf)
    if on_card:
        # one line-search chunk end to end, kernels and plain versions in turns
        chunk = torch.as_tensor(pts[:auto_chunk(views)], device=dev)

        def forward():
            solver.pmvo_forward(maps, chunk, patch, conf_thr)

        def forward_plain():
            with plain_versions():
                forward()

        forward(), forward_plain()
        k1, p1, p2, k2 = (chunk_ms(f) for f in (forward, forward_plain, forward_plain,
                                                 forward))
        log(f"full width: pmvo_forward on {chunk.shape[0]} points: kernels "
            f"{k1:.3f} / {k2:.3f} ms, plain versions {p1:.3f} / {p2:.3f} ms "
            f"(host clock between synchronisations, 3 calls each)")

        # the tap loop on the scene's own inputs: the kernel's work depends on
        # the data (taps skipped, exact paths taken), so time it there too
        with recorded_min_loss_calls() as calls:
            forward()
        err = max(check_min_loss(args, "head scene") for args in calls)
        scene_ms = cuda_time_ms(lambda: [pk.patch_min_loss(*args) for args in calls],
                                iters=10) / len(calls)
        shape = tuple(calls[0][0].shape[:3]) + (calls[0][1].shape[2],)
        log(f"full width: patch_min_loss on the {len(calls)} calls of one "
            f"{chunk.shape[0]}-point chunk (V, N, S, P = {shape}): within rtol 1e-5/"
            f"atol 1e-6, counts exact, max abs err {err:.3g}; kernel {scene_ms:.4f} ms "
            f"per call")
        result["scene_ms"] = scene_ms
    return result


def profile_line_search(dev: torch.device, chunks: int = 4) -> None:
    """Trace `chunks` full-width line-search chunks: device time by kernel and
    the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    maps, points = head_scene(dev, FULL_WIDTH_POINTS // 4, 1920, 1080, 16)
    surface, _ = filter_raw_points(maps, points, PATCH, CONF_THR, VIS_THR)
    n = auto_chunk(16)
    pts = points[surface][:chunks * n]
    optimize_points(maps, pts[:n], PATCH, CONF_THR)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        optimize_points(maps, pts, PATCH, CONF_THR)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    log(f"profile: {len(pts)} points in {chunks} chunks, wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms {e.count:6d} calls  {e.key[:90]}", flush=True)


KERNEL_META = {
    "patch_gather": dict(route="cuda", source="monohair_tpu_torch/csrc/patch_kernels.cu",
                         replaces="monohair_tpu/ops/pallas_kernels.py:188"),
    "patch_min_loss": dict(route="cuda", source="monohair_tpu_torch/csrc/patch_kernels.cu",
                           replaces="monohair_tpu/ops/pallas_kernels.py:63"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the full-width line search with torch.profiler "
                         "and print where the device time goes")
    opts = ap.parse_args(argv)

    with Phase("1 device"):
        device = phase_device()
    dev = torch.device("cuda", 0)
    with Phase("2 build"):
        phase_build()
    with Phase("3 kernels"):
        kernels = phase_kernels(dev)
    with Phase("4 stage"):
        phase_stage("cuda")
    with Phase("5 full width"):
        width = phase_full_width(dev)
    launches = width["launches"]
    kernels["patch_min_loss"]["scene_ms"] = width["scene_ms"]
    if opts.profile:
        with Phase("profile"):
            profile_line_search(dev)
    line = [dict(name=name, **KERNEL_META[name], launches=launches[name],
                 library_ms=None, **kernels[name]) for name in KERNEL_META]
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
