"""Chunked drivers for the PMVO stage: optimize -> refine -> voxelize
(port of monohair_tpu/pmvo/driver.py).

Mirrors the stage flow of PMVO.py main (:805-880): filter raw samples, run the
line search per chunk, KNN-consensus refine, threshold, voxelize to the
256x256x192 Occ/Ori grids. Artifacts (optimize/select_p.npy etc., refine/*.npy)
keep the reference names so stages are interchangeable.

Points come in and results go out as numpy arrays; each chunk runs on the
maps' device, or, given a mesh (a tuple of devices, parallel/sharding.py), in
one contiguous slice per device against maps replicated once per call, as the
JAX drivers shard a chunk over a device mesh. Every per-point result depends
on that point alone, so the last chunk is not padded and a mesh gives the
unsharded results bit for bit.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..camera import pixel_index_and_validity, project
from ..coords import voxel_indices
from ..ops import exact_f32
from ..ops.grid_sample import gather_pixels
from ..ops.neighbors import build_buckets, neighborhood_consensus_direction
from ..ops.voxelize import canonicalize_down, voxelize_directions
from ..parallel.sharding import Mesh, concat_shards, replicate, shard_batch
from .solver import (PMVOMaps, compute_unvisible_points, filter_points,
                     pmvo_forward, pmvo_refine_loss)


def _dev(x: np.ndarray, maps: PMVOMaps) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=maps.device)


def _sharded(fn, replicas, x: torch.Tensor, mesh, *args) -> list:
    """fn(maps, x_shard, *args_shard) on each shard of x's leading axis (with
    args cut the same way), each on its device; the results (each a tensor or
    a tuple of them) on the host, joined in shard order."""
    cols = [shard_batch(x, mesh)] + [shard_batch(a, mesh) for a in args]
    outs = [fn(m, *parts) for m, *parts in zip(replicas, *cols) if len(parts[0])]
    if isinstance(outs[0], torch.Tensor):
        return concat_shards([(o,) for o in outs])[0]
    return concat_shards(outs)


def auto_chunk(num_views: int, target: int = 8192, base_views: int = 16,
               minimum: int = 2048) -> int:
    """Point-chunk size scaled to the view count: the working set is
    O(V * N * S), so a 150-view capture gets ~1/9 the chunk of the 16-view rig.
    Rounded to a multiple of 1024."""
    n = int(target * base_views / max(num_views, 1))
    return max(minimum, (n // 1024) * 1024)


@torch.no_grad()
def optimize_points(maps: PMVOMaps, points: np.ndarray, patch_size: int,
                    conf_threshold: float, chunk: Optional[int] = None,
                    mesh: Optional[Mesh] = None, save_root: Optional[str] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Run the PMVO line search over all points in fixed-size chunks.

    Returns (points, ori, min_loss, high_conf). Mirror of `optimize`
    (PMVO.py:565-595), chunk auto-sized from the view count when not given,
    each chunk sharded over `mesh` when given.
    """
    exact_f32()
    if chunk is None:
        chunk = auto_chunk(maps.cameras.num_views)
    replicas = replicate(maps, mesh)
    outs = []
    for beg in range(0, points.shape[0], chunk):
        res = _sharded(partial(pmvo_forward, patch_size=patch_size,
                               conf_threshold=conf_threshold),
                       replicas, _dev(points[beg:beg + chunk], maps), mesh)
        outs.append([r.numpy() for r in res])
    if outs:
        points_o, ori, loss, high_conf = (np.concatenate(c) for c in zip(*outs))
    else:
        points_o, ori = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
        loss, high_conf = np.zeros(0, np.float32), np.zeros(0, bool)
    if save_root:
        os.makedirs(save_root, exist_ok=True)
        np.save(os.path.join(save_root, "select_p.npy"), points_o)
        np.save(os.path.join(save_root, "select_o.npy"), ori)
        np.save(os.path.join(save_root, "min_loss.npy"), loss)
        np.save(os.path.join(save_root, "high_conf_index.npy"), high_conf)
    return points_o, ori, loss, high_conf


@torch.no_grad()
def filter_raw_points(maps: PMVOMaps, points: np.ndarray, patch_size: int,
                      conf_threshold: float, visible_threshold: float,
                      chunk: Optional[int] = None, mesh: Optional[Mesh] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked boolean classification of raw samples (PMVO.py:535-557), each
    chunk sharded over `mesh` when given."""
    exact_f32()
    if chunk is None:
        chunk = 8 * auto_chunk(maps.cameras.num_views)  # no S axis here
    replicas = replicate(maps, mesh)
    fn = partial(filter_points, patch_size=patch_size, conf_threshold=conf_threshold,
                 visible_threshold=visible_threshold)
    surf, filt = [np.zeros(0, bool)], [np.zeros(0, bool)]
    for beg in range(0, points.shape[0], chunk):
        s, f = _sharded(fn, replicas, _dev(points[beg:beg + chunk], maps), mesh)
        surf.append(s.numpy())
        filt.append(f.numpy())
    return np.concatenate(surf), np.concatenate(filt)


@torch.no_grad()
def filter_head_points_mask(maps: PMVOMaps, points: torch.Tensor,
                            visible_threshold: float,
                            scalp_points: Optional[np.ndarray] = None,
                            scalp_max_z: Optional[float] = None) -> torch.Tensor:
    """Device part of PMVO.filter_head_points (PMVO.py:96-144): True = drop.

    A point is dropped when at least half of its visible views see it outside
    the hair mask; points within 4 cm of the scalp (and below its top) are
    always kept (host KD-query when scalp_points given).
    """
    H, W = maps.image_size
    uv, z = project(maps.cameras, points)
    rc, _ = pixel_index_and_validity(uv, (H, W))
    d = torch.stack([gather_pixels(maps.depth[v], rc[v]) for v in range(rc.shape[0])])
    m = torch.stack([gather_pixels(maps.mask[v], rc[v]) for v in range(rc.shape[0])])
    m = torch.where(m > 0.2, 1.0, m)
    unvis = torch.where((-z / 2.0 * 255.0) - d >= visible_threshold, 1.0, 0.0)
    vis = 1.0 - unvis
    index = vis * m
    filt = ~((torch.sum(vis, 0) - torch.sum(index, 0)) < torch.sum(vis, 0) * 0.5)

    if scalp_points is not None and len(scalp_points):
        from scipy.spatial import cKDTree
        pts = points.cpu().numpy()
        dist, _ = cKDTree(scalp_points).query(pts, k=1)
        top = scalp_max_z if scalp_max_z is not None else scalp_points[:, 2].max()
        head_top = (dist < 0.04) & (pts[:, 2] < top - 0.01)
        filt = filt & ~torch.as_tensor(head_top, device=filt.device)
    return filt


@torch.no_grad()
def refine_and_voxelize(maps: PMVOMaps, points: np.ndarray, ori: np.ndarray,
                        loss: np.ndarray, filter_unvisible_points: np.ndarray,
                        patch_size: int, conf_threshold: float,
                        visible_threshold: float, threshold: float,
                        scalp_points: Optional[np.ndarray] = None,
                        coarse_raw: Optional[np.ndarray] = None,
                        chunk: int = 65536, save_root: Optional[str] = None,
                        mesh: Optional[Mesh] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Consensus-refine directions, add near-surface/interior points, voxelize.

    Mirror of `refine` (PMVO.py:602-764). Returns numpy (occ (X,Y,Z),
    ori (X,Y,Z,3)); the caller saves via mat_io. With `mesh`, the per-point
    map reads of each chunk (the refine loss, the head filter, the fuse's
    visibility test) are sharded over it; the neighbour consensus stays on the
    maps' device, where its buckets are.

    - consensus: voxel-bucket neighborhood mean (replaces scipy 100-NN)
    - replace a point's direction when its consensus disagrees (cos < 0.95)
    - re-score all directions with the single-sample projection loss
    - select loss < threshold; attach filtered-unvisible points with consensus
      directions; optionally fuse coarse interior points (raw.npy) that are
      invisible in fewer than 3 views
    """
    exact_f32()
    replicas = replicate(maps, mesh)
    pts_t = _dev(points, maps)
    ori_t = _dev(ori, maps)
    buckets = build_buckets(pts_t)

    def refine_loss(m, q, cand):
        l = pmvo_refine_loss(m, q, cand, patch_size, conf_threshold)
        head = filter_head_points_mask(m, q, visible_threshold, scalp_points)
        return torch.where(head, 0.5, l)  # reference sets -1 then maps -1 -> 0.5

    n = points.shape[0]
    new_ori = np.empty((n, 3), np.float32)
    new_loss = np.empty(n, np.float32)
    for beg in range(0, n, chunk):
        end = min(beg + chunk, n)
        q = pts_t[beg:end]
        qd = ori_t[beg:end]
        center = neighborhood_consensus_direction(buckets, ori_t, q, qd)
        sim = torch.abs(torch.sum(center * qd, -1))
        cand = torch.where((sim < 0.95)[:, None], center, qd)
        new_ori[beg:end] = cand.cpu().numpy()
        new_loss[beg:end] = _sharded(refine_loss, replicas, q, mesh, cand).numpy()
    del buckets

    if save_root:
        os.makedirs(save_root, exist_ok=True)
        np.save(os.path.join(save_root, "select_p.npy"), points)
        np.save(os.path.join(save_root, "select_o.npy"), new_ori)
        np.save(os.path.join(save_root, "min_loss.npy"), new_loss)

    keep = new_loss < threshold
    sel_p = points[keep].astype(np.float32)
    sel_o = new_ori[keep]

    # near-surface invisible points inherit the consensus of selected neighbors
    if filter_unvisible_points is not None and len(filter_unvisible_points):
        sel_buckets = build_buckets(_dev(sel_p, maps))
        fu = _dev(filter_unvisible_points, maps)
        down = torch.zeros_like(fu)
        down[:, 1] = -1.0
        fu_dir = neighborhood_consensus_direction(sel_buckets, _dev(sel_o, maps), fu, down)
        del sel_buckets
        keep_fu = ~filter_head_points_mask(maps, fu, visible_threshold, scalp_points)
        fu_np = fu[keep_fu].cpu().numpy()
        fu_dir_np = fu_dir[keep_fu].cpu().numpy()
        if save_root:
            np.save(os.path.join(save_root, "filter_unvisible.npy"), fu_np)
            np.save(os.path.join(save_root, "filter_unvisible_ori.npy"), fu_dir_np)
        sel_p = np.concatenate([sel_p, fu_np], 0)
        sel_o = np.concatenate([sel_o, fu_dir_np], 0)

    sel_o_t = canonicalize_down(_dev(sel_o, maps))
    occ_t, ori_grid_t = voxelize_directions(_dev(sel_p, maps), sel_o_t)
    occ, ori_grid = occ_t.cpu().numpy(), ori_grid_t.cpu().numpy()
    del occ_t, ori_grid_t

    # fuse coarse interior (infer_inner branch, PMVO.py:733-751)
    if coarse_raw is not None and len(coarse_raw):
        c_pts = coarse_raw[:, :3].astype(np.float32)
        c_ori = canonicalize_down(_dev(coarse_raw[:, 3:6], maps)).cpu().numpy()
        unvis = []
        t0 = time.monotonic()
        n_chunks = (len(c_pts) + chunk - 1) // chunk
        for k, beg in enumerate(range(0, len(c_pts), chunk)):
            unvis.append(_sharded(compute_unvisible_points, replicas,
                                  _dev(c_pts[beg:beg + chunk], maps), mesh).numpy())
            if k % 64 == 0:
                print(f"[pmvo] fuse chunk {k + 1}/{n_chunks} "
                      f"({time.monotonic() - t0:.0f}s)", flush=True)
        unvis = np.concatenate(unvis)
        iv = voxel_indices(_dev(c_pts[unvis], maps)).cpu().numpy()
        occ[iv[:, 0], iv[:, 1], iv[:, 2]] = 1
        ori_grid[iv[:, 0], iv[:, 1], iv[:, 2]] = c_ori[unvis]
        if save_root:
            np.save(os.path.join(save_root, "coarse.npy"), c_pts[unvis])
            np.save(os.path.join(save_root, "coarse_ori.npy"), c_ori[unvis])

    return occ, ori_grid
