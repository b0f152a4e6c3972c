"""Stage 2 — PMVO exterior optimization (port of
monohair_tpu/pipeline/pmvo_stage.py; reference PMVO.py main :805-880)."""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..io.mat_io import save_occ_ori_mat
from ..pmvo.driver import filter_raw_points, optimize_points, refine_and_voxelize
from ..pmvo.points import load_colmap_points
from .common import load_bust_and_scalp, load_pmvo_maps


def _no_points_error(what: str, args: Config) -> RuntimeError:
    return RuntimeError(
        f"PMVO {what} 0 points — every candidate failed the mask/confidence "
        "visibility test, or the coarse mesh "
        f"({args.data.raw_points_path}) is empty. Almost always this means the "
        f"hair masks ({args.data.mask_path}/) are empty or wrong (check the "
        "segmentation checkpoints against these capture images) or conf/ is all "
        f"below conf_threshold={args.PMVO.conf_threshold}.")


def run_pmvo(args: Config, device="cuda", mesh=None) -> Dict[str, float]:
    """optimize=True: full line search + refine -> refine/{Occ3D,Ori3D}.mat;
    optimize=False & infer_inner=True: fuse coarse interior -> full/*.mat.

    Runs on `device` (the card unless the caller asks for "cpu"); each chunk
    of points is sharded over `mesh` (a tuple of devices) when given. Returns
    the wall seconds of each step.
    """
    t0 = time.monotonic()
    steps: Dict[str, float] = {}

    def step(name: str, t: float) -> float:
        now = time.monotonic()
        steps[name] = now - t
        print(f"[pmvo] {name}: {steps[name]:.2f}s", flush=True)
        return now

    maps, _ = load_pmvo_maps(args, device)
    if args.PMVO.get("bf16_maps"):
        maps = maps.astype(torch.bfloat16)
    _, scalp_v, _ = load_bust_and_scalp(args)
    t = step("load", t0)
    root = args.data.root
    out = args.output_path
    save_root = os.path.join(out, "optimize")
    patch = args.PMVO.patch_size
    conf_thr = args.PMVO.conf_threshold
    vis_thr = args.PMVO.visible_threshold

    if args.PMVO.optimize:
        points = load_colmap_points(os.path.join(root, args.data.raw_points_path),
                                    num_per_grid=args.PMVO.num_sample_per_grid)
        print(f"total points: {points.shape[0]}")
        if points.shape[0] == 0:
            raise _no_points_error("loaded", args)
        # this run's near-surface points, never a file an earlier run left
        filter_unvisible = None
        if args.PMVO.filter_point:
            surface, filt = filter_raw_points(maps, points, patch, conf_thr, vis_thr,
                                              mesh=mesh)
            os.makedirs(save_root, exist_ok=True)
            np.save(os.path.join(save_root, "surface.npy"), points[surface])
            filter_unvisible = points[filt]
            np.save(os.path.join(save_root, "filter_unvisible.npy"), filter_unvisible)
            points = points[surface]
        print(f"process points: {points.shape[0]}")
        if points.shape[0] == 0:
            raise _no_points_error("selected", args)
        t = step("filter", t)
        pts, ori, loss, _ = optimize_points(maps, points, patch, conf_thr, mesh=mesh,
                                            save_root=save_root)
        t = step("optimize", t)
        occ, ori_grid = refine_and_voxelize(
            maps, pts, ori, loss, filter_unvisible, patch, conf_thr, vis_thr,
            args.PMVO.threshold, scalp_points=scalp_v,
            save_root=os.path.join(out, "refine"), mesh=mesh)
        t = step("refine", t)
        save_occ_ori_mat(os.path.join(out, "refine"), occ, ori_grid)
    else:
        pts = np.load(os.path.join(save_root, "select_p.npy"))
        ori = np.load(os.path.join(save_root, "select_o.npy"))
        loss = np.load(os.path.join(save_root, "min_loss.npy"))
        # written only by a run with PMVO.filter_point on; the JAX stage
        # loads it unconditionally and crashes without it
        fu_path = os.path.join(save_root, "filter_unvisible.npy")
        filter_unvisible = np.load(fu_path) if os.path.exists(fu_path) else None
        coarse = None
        if args.PMVO.infer_inner:
            # raw.npy = [pts, ori, occ_flag] for every query. As in the JAX
            # package, only the MVS-positive queries are fused (a deliberate
            # departure from PMVO.py:733-751, which ingests every row).
            coarse = np.load(os.path.join(root, "ours/raw.npy"))
            coarse = coarse[coarse[:, 6] > 0.5]
            print(f"[pmvo] fusing {len(coarse)} MVS-positive interior points")
        sub = "full" if args.PMVO.infer_inner else "refine"
        occ, ori_grid = refine_and_voxelize(
            maps, pts, ori, loss, filter_unvisible, patch, conf_thr, vis_thr,
            args.PMVO.threshold, scalp_points=scalp_v, coarse_raw=coarse,
            save_root=os.path.join(out, sub), mesh=mesh)
        t = step("refine", t)
        save_occ_ori_mat(os.path.join(out, sub), occ, ori_grid)
    step("save", t)
    print(f"[pmvo] done in {time.monotonic() - t0:.1f}s")
    return steps
