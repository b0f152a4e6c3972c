"""Core PMVO math on torch tensors (port of monohair_tpu/pmvo/solver.py).

Reference: PMVO.py class PMVO (:13-533). Shapes: V views, N points (a chunk),
S = 90 depth samples, P = patch_size**2 patch taps. Views are a stacked axis;
the 10 candidate base views are a Python loop; the patch fetch and the tap loop
are the two kernels of ``ops/patch_kernels.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..camera import (Cameras, ndc_to_pixel, pixel_index_and_validity,
                      pixel_to_ndc, project)
from ..ops.grid_sample import gather_pixels
from ..ops.patch_kernels import patch_gather, patch_min_loss as patch_min_loss_kernel


@dataclasses.dataclass(frozen=True)
class PMVOMaps:
    """Per-view observation maps, stacked over the view axis, on one device.

    depth: (V, H, W) on the 0..255 disk scale; ori2d: (V, H, W, 2) = (sin, cos);
    conf: (V, H, W) in [0, 1]; mask: (V, H, W) in [0, 1].
    """
    cameras: Cameras
    depth: torch.Tensor
    ori2d: torch.Tensor
    conf: torch.Tensor
    mask: torch.Tensor

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.depth.shape[1], self.depth.shape[2]

    @property
    def device(self) -> torch.device:
        return self.depth.device

    def astype(self, dtype: torch.dtype) -> "PMVOMaps":
        """The maps stored in `dtype` (PMVO.bf16_maps: bf16 halves their
        memory), the cameras as they are. Consumers follow the JAX package's
        promotion: the patch gather upcasts its windows to f32, and a bf16 map
        value meets f32 camera math as f32, so only the stored values round."""
        return dataclasses.replace(self, depth=self.depth.to(dtype),
                                   ori2d=self.ori2d.to(dtype), conf=self.conf.to(dtype),
                                   mask=self.mask.to(dtype))

    @classmethod
    def from_numpy(cls, ndc, w2c, depth, ori2d, conf, mask, device="cuda") -> "PMVOMaps":
        """From numpy arrays (the JAX package's PMVOMaps fields, as numpy)."""
        def t(x):
            return torch.as_tensor(np.array(x, np.float32), device=device)
        return cls(Cameras.from_numpy(ndc, w2c, device), t(depth), t(ori2d), t(conf),
                   t(mask))


def depth_sample_offsets(num_sample: int = 90) -> np.ndarray:
    """The 90 non-uniform depth offsets of the line search (PMVO.py:274-278):
    coarse on [-5, -1]mm and [1, 5]mm, dense on [-1, 1]mm."""
    s1 = np.arange(-0.005, -0.001, 0.004 / (num_sample / 4))
    s2 = np.arange(-0.001, 0.001, 0.002 / (num_sample / 2))
    s3 = np.arange(0.001, 0.005, 0.004 / (num_sample / 4))
    return np.concatenate([s1, s2, s3])[:num_sample].astype(np.float32)


def compute_visible(render_depth: torch.Tensor, z255: torch.Tensor) -> torch.Tensor:
    """Soft visibility in [-1, 1] (PMVO.py:525-529): 1 at the surface, ramping
    to 0 over 0.1 depth units behind it, -1 when occluded."""
    vis = torch.where(z255 - render_depth < 0.1, 1.0 - (z255 - render_depth) / 0.1, -1.0)
    return torch.clamp(vis, -1.0, 1.0)


def pack_padded_maps(maps: PMVOMaps, patch_size: int) -> torch.Tensor:
    """One 8-channel map (ori sin, ori cos, conf, depth, mask, 0, 0, 0),
    edge-padded by patch_size // 2 on each side: (V, H+p-1, W+p-1, 8), in the
    maps' dtype."""
    H, W = maps.image_size
    half = patch_size // 2
    zeros = torch.zeros_like(maps.conf)
    packed = torch.stack([maps.ori2d[..., 0], maps.ori2d[..., 1], maps.conf,
                          maps.depth, maps.mask, zeros, zeros, zeros], -1)
    rows = torch.arange(-half, H + half, device=maps.device).clamp(0, H - 1)
    cols = torch.arange(-half, W + half, device=maps.device).clamp(0, W - 1)
    return packed[:, rows][:, :, cols].contiguous()


def observe_points(maps: PMVOMaps, points: torch.Tensor, patch_size: int
                   ) -> Dict[str, torch.Tensor]:
    """Project (N, 3) points into all views and gather every per-view quantity.

    Mirror of Compute_Visible_and_Ori (PMVO.py:346-376). Returns a dict of
    (V, N, ...) tensors: uv (NDC), z, rc, invalid, depth, visible, ori, conf,
    mask, ori_patch (V,N,P,2), conf_patch (V,N,P), all f32 whatever the maps'
    dtype: the gather upcasts its windows.
    """
    H, W = maps.image_size
    uv, z = project(maps.cameras, points)                     # (V,N,2),(V,N)
    rc, invalid = pixel_index_and_validity(uv, (H, W))
    half = patch_size // 2
    patch = patch_gather(pack_padded_maps(maps, patch_size), rc.contiguous(),
                         patch_size)                          # (V,N,P,8)

    center = patch[:, :, half * patch_size + half, :]         # the (0,0) tap
    d = center[..., 3]
    vis = compute_visible(d, -z / 2.0 * 255.0)
    vis = torch.where(invalid, -1.0, vis)
    return dict(uv=uv, z=z, rc=rc, invalid=invalid, depth=d, visible=vis,
                ori=center[..., 0:2], conf=torch.clamp(center[..., 2], 1e-6, 1.0),
                mask=center[..., 4], ori_patch=patch[..., 0:2],
                conf_patch=torch.clamp(patch[..., 2], 1e-6, 1.0))


def find_base_views(visible: torch.Tensor, conf: torch.Tensor, k: int = 20
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k views per point by visibility-weighted confidence
    (PMVO.py:339-343). Returns (idx (k, N), conf (k, N)).

    A stable descending sort puts the lower view index first among equal
    weights, as jax.lax.top_k does; ties are common, since every occluded
    view weighs 0.
    """
    weighted = torch.where(visible < 1.0, conf * torch.clamp_min(visible, 0.0), conf)
    k = min(k, visible.shape[0])
    vals, idx = torch.sort(weighted.T, dim=-1, descending=True, stable=True)
    return idx[:, :k].T, vals[:, :k].T


def reproject_directions(maps: PMVOMaps, points: torch.Tensor,
                         samples: torch.Tensor) -> torch.Tensor:
    """2D pixel-space direction of the line point->sample in every view.

    points: (N, 3); samples: (N, S, 3) -> (V, N, S, 2) in (d_row, d_col).
    Mirror of compute_reproject_ori (PMVO.py:219-241).
    """
    H, W = maps.image_size
    N, S = samples.shape[:2]
    uv_s, _ = project(maps.cameras, samples.reshape(-1, 3))   # (V, N*S, 2)
    rc_s = ndc_to_pixel(uv_s, (H, W)).reshape(-1, N, S, 2)
    uv_p, _ = project(maps.cameras, points)
    rc_p = ndc_to_pixel(uv_p, (H, W))                         # (V, N, 2)
    return rc_s - rc_p[:, :, None, :]


def patch_min_loss(prj_dir: torch.Tensor, obs: Dict[str, torch.Tensor],
                   conf_threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Aggregate the per-patch orientation agreement into a per-(point, sample)
    loss, then pick the best sample. Mirror of compute_prj_loss (PMVO.py:151-209).

    prj_dir: (V, N, S, 2) reprojected directions. Returns
    (min_loss (N,), best_sample (N,), high_conf (N,) bool). argmin takes the
    first of equal minima, as jnp.argmin does.
    """
    num, sum_w, sum_wp_raw = patch_min_loss_kernel(
        prj_dir.contiguous(), obs["ori_patch"].contiguous(),
        obs["conf_patch"].contiguous(), obs["visible"].contiguous(), conf_threshold)

    sum_wp = torch.clamp_min(sum_wp_raw, 1e-6)
    positive = (sum_w / sum_wp) > conf_threshold              # (N,S)
    low_conf = torch.sum(positive, -1) < 5                    # (N,)

    agg = num / torch.clamp_min(sum_w, 1e-6)                  # (N,S)
    masked = torch.where(positive, agg, 1.0)
    final = torch.where(low_conf[:, None], agg, masked)
    best_sample = torch.argmin(final, -1)
    min_val = torch.take_along_dim(final, best_sample[:, None], -1)[:, 0]
    high_conf = torch.take_along_dim(positive, best_sample[:, None], -1)[:, 0]
    return min_val, best_sample, high_conf


def sample_candidate_positions(maps: PMVOMaps, points: torch.Tensor,
                               base_view: torch.Tensor, offsets: torch.Tensor,
                               ori_lookup: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each point, march 2 px along its base view's 2D orientation and lift
    the target pixel back to 3D at 90 candidate depths around the point's depth.

    Mirror of sample_next_3d_pos (PMVO.py:263-335). base_view: (N,) view index;
    ori_lookup: (V, N, 2) the per-view 2D orientation at each point's pixel.
    Returns (samples (N, S, 3), surface (N, 3)).

    The reference's `surface_points` writes are chained advanced-indexing
    no-ops (PMVO.py:333-334), so its effective surface is the input point; this
    reproduces that (surface = points).
    """
    H, W = maps.image_size
    N = points.shape[0]
    ndc = maps.cameras.ndc[base_view]                         # (N, 4)
    w2c = maps.cameras.w2c[base_view]                         # (N, 4, 4)
    fx, fy, cx, cy = ndc.unbind(-1)
    # project each point in its own base view
    cam = torch.einsum("nij,nj->ni", w2c[:, :3, :3], points) + w2c[:, :3, 3]
    z = cam[:, 2]
    uv = torch.stack([fx * cam[:, 0] / z + cx, fy * cam[:, 1] / z + cy], -1)
    rc = ndc_to_pixel(uv, (H, W))                             # (N,2) (row,col)
    ori = ori_lookup[base_view, torch.arange(N, device=points.device)]  # (N,2)
    # ori is (sin, cos) = (d_row, d_col); march 2 px
    uv_next = pixel_to_ndc(rc + ori * 2.0, (H, W))

    z_samples = z[:, None] + offsets[None, :]                 # (N,S)
    x = ((uv_next[:, 0] - cx) / fx)[:, None] * z_samples
    y = ((uv_next[:, 1] - cy) / fy)[:, None] * z_samples
    cam_s = torch.stack([x, y, z_samples], -1)                # (N,S,3)
    samples = torch.einsum("nji,nsj->nsi", w2c[:, :3, :3],
                           cam_s - w2c[:, None, :3, 3])
    return samples, points


def pmvo_forward(maps: PMVOMaps, points: torch.Tensor, patch_size: int,
                 conf_threshold: float, num_sample: int = 90,
                 num_base_candidates: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One PMVO chunk: best 3D line direction per point.

    Returns (points (N,3), ori (N,3) unit, min_loss (N,), high_conf (N,) bool).
    Mirror of PMVO.forward (PMVO.py:39-78): candidate base views are every other
    entry of the top-20 visibility-weighted-confidence views.
    """
    obs = observe_points(maps, points, patch_size)
    base_idx, base_conf = find_base_views(obs["visible"], obs["conf"])
    offsets = torch.as_tensor(depth_sample_offsets(num_sample), device=points.device)

    num_base = min(num_base_candidates, base_idx.shape[0] // 2)
    cand_idx = base_idx[0:2 * num_base:2]                     # (B, N)
    cand_conf = base_conf[0:2 * num_base:2]

    def evaluate(b_view):
        samples, surface = sample_candidate_positions(maps, points, b_view,
                                                      offsets, obs["ori"])
        prj = reproject_directions(maps, points, samples)
        loss, best_s, high_conf = patch_min_loss(prj, obs, conf_threshold)
        best_pts = torch.take_along_dim(samples, best_s[:, None, None], 1)[:, 0]
        return loss, best_pts, surface, high_conf

    min_loss, best_pts, best_surf, high_conf = evaluate(cand_idx[0])
    for b in range(1, cand_idx.shape[0]):
        loss, pts, surf, hc = evaluate(cand_idx[b])
        take = (loss < min_loss) & (cand_conf[b] > 0)
        min_loss = torch.where(take, loss, min_loss)
        best_pts = torch.where(take[:, None], pts, best_pts)
        best_surf = torch.where(take[:, None], surf, best_surf)
        high_conf = torch.where(take, hc, high_conf)

    line = best_pts - best_surf
    ori = line / torch.linalg.norm(line, dim=-1, keepdim=True).clamp_min(1e-12)
    return points, ori, min_loss, high_conf


def pmvo_refine_loss(maps: PMVOMaps, points: torch.Tensor, ori: torch.Tensor,
                     patch_size: int, conf_threshold: float) -> torch.Tensor:
    """Projection loss of a *given* direction (the KNN-consensus candidate),
    used by the refine pass. Mirror of PMVO.refine (PMVO.py:81-93) minus the
    bust/scalp filtering, which the caller applies (host-side KD-trees)."""
    obs = observe_points(maps, points, patch_size)
    next_points = points + ori * (0.005 / 4.0)
    prj = reproject_directions(maps, points, next_points[:, None, :])
    loss, _, _ = patch_min_loss(prj, obs, conf_threshold)
    return loss


def filter_masks(maps: PMVOMaps, points: torch.Tensor, patch_size: int,
                 conf_threshold: float, visible_threshold: float) -> Dict[str, torch.Tensor]:
    """The per-point tests that PMVO.filter_points (PMVO.py:402-459) combines,
    as boolean masks over the N points: `seen` (visible at the 0.1 depth
    tolerance in more than one view) and `seen_loose` (the same at
    visible_threshold); `low_conf` (low-confidence in more than 4 of the views
    it is seen in); `hair` and `hair_loose` (on the hair mask in at least half
    of the views it is seen in, at either tolerance)."""
    obs = observe_points(maps, points, patch_size)
    z255 = -obs["z"] / 2.0 * 255.0
    d = obs["depth"]
    invalid = obs["invalid"]

    cmax = torch.amax(obs["conf_patch"], -1)
    cmax = torch.where(invalid, 0.0, cmax)
    unvis = torch.where(z255 - d > 0.1, 1.0, 0.0)
    unvis = torch.where(invalid, 1.0, unvis)
    unvis1 = torch.where(z255 - d > visible_threshold, 1.0, 0.0)
    unvis1 = torch.where(invalid, 1.0, unvis1)
    low_c = (cmax < conf_threshold).to(z255.dtype)
    m = torch.where(obs["mask"] > 0.2, 1.0, obs["mask"])

    vis = 1.0 - unvis
    vis1 = 1.0 - unvis1
    return dict(
        seen=torch.sum(vis, 0) > 1,
        seen_loose=torch.sum(vis1, 0) > 1,
        low_conf=torch.sum((1.0 - unvis) * low_c, 0) > 4,
        hair=(torch.sum(vis, 0) - torch.sum(vis * m, 0)) < torch.sum(vis, 0) * 0.5,
        hair_loose=(torch.sum(vis1, 0) - torch.sum(vis1 * m, 0)) < torch.sum(vis1, 0) * 0.5)


def filter_points(maps: PMVOMaps, points: torch.Tensor, patch_size: int,
                  conf_threshold: float, visible_threshold: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classify raw samples into surface candidates vs near-surface-invisible.

    Mirror of PMVO.filter_points (PMVO.py:402-459), from `filter_masks`.
    Returns boolean masks (surface_index, filter_index) over the N points.
    """
    k = filter_masks(maps, points, patch_size, conf_threshold, visible_threshold)
    surface = k["seen"] & ~k["low_conf"] & k["hair"]
    filt = k["seen_loose"] & ~k["seen"] & ~k["low_conf"] & k["hair_loose"]
    return surface, filt


def compute_unvisible_points(maps: PMVOMaps, points: torch.Tensor) -> torch.Tensor:
    """True for points visible in fewer than 3 views at a 0.9 depth tolerance
    (PMVO.py:461-480); used to keep only interior MVS points when fusing."""
    H, W = maps.image_size
    uv, z = project(maps.cameras, points)
    rc, invalid = pixel_index_and_validity(uv, (H, W))
    d = torch.stack([gather_pixels(maps.depth[v], rc[v]) for v in range(rc.shape[0])])
    unvis = torch.where((-z / 2.0 * 255.0) - d > 0.9, 1.0, 0.0)
    unvis = torch.where(invalid, 1.0, unvis)
    visible_count = torch.sum(1.0 - unvis, 0)
    return ~(visible_count > 2)
