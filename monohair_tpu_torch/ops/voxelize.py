"""Scatter-based voxelization of oriented point clouds (port of
monohair_tpu/ops/voxelize.py).

Per voxel, the direction is the principal eigenvector of the orientation matrix
sum(d d^T) (power iteration), the sign-agnostic axis average; stored with
y <= 0 like the reference's pre-voxelize flip (PMVO.py:702-703).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..constants import GRID_RESOLUTION, VOXEL_MIN, VOXEL_SIZE
from ..coords import flat_voxel_id, voxel_indices


def canonicalize_down(dirs: torch.Tensor) -> torch.Tensor:
    """Flip direction vectors so the y component is <= 0 (PMVO.py:702-703)."""
    return torch.where(dirs[..., 1:2] > 0, -dirs, dirs)


def voxelize_directions(points: torch.Tensor, dirs: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        grid_resolution: Tuple[int, int, int] = tuple(
                            int(x) for x in GRID_RESOLUTION),
                        voxel_min=None, voxel_size: float = VOXEL_SIZE
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxelize (N, 3) world points with (N, 3) directions.

    Returns (occ (X,Y,Z) float32 in {0,1}, ori (X,Y,Z,3) unit mean directions).
    ``weights`` (N,) optionally masks out points (0 = ignore). The eigenvector
    is computed for occupied voxels only; empty voxels hold 0, as in the JAX
    package, where the result is multiplied by the occupancy.
    """
    vmin = VOXEL_MIN if voxel_min is None else voxel_min
    ids = flat_voxel_id(voxel_indices(points, vmin, voxel_size, grid_resolution),
                        grid_resolution).long()
    X, Y, Z = (int(r) for r in grid_resolution)
    nvox = X * Y * Z
    dev, dt = points.device, torch.float32

    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    w = torch.ones(points.shape[0], dtype=dt, device=dev) if weights is None else weights
    counts = torch.zeros(nvox, dtype=dt, device=dev).index_add_(0, ids, w)
    # orientation (scatter) matrix: the 6 unique entries of sum(w * d d^T)
    outer = torch.stack([d[:, 0] * d[:, 0], d[:, 1] * d[:, 1], d[:, 2] * d[:, 2],
                         d[:, 0] * d[:, 1], d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]],
                        -1) * w[:, None]
    M6 = torch.zeros((nvox, 6), dtype=dt, device=dev).index_add_(0, ids, outer)

    occ = (counts > 0).to(dt)
    occupied = torch.nonzero(counts > 0)[:, 0]
    ori = torch.zeros((nvox, 3), dtype=dt, device=dev)
    ori[occupied] = canonicalize_down(principal_axis(M6[occupied]))
    return occ.reshape(X, Y, Z), ori.reshape(X, Y, Z, 3)


def principal_axis(M6: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Largest eigenvector of symmetric 3x3 matrices given as (..., 6) packed
    [xx, yy, zz, xy, xz, yz] — power iteration, initialized from the column
    with the largest diagonal entry (never orthogonal to the principal axis)."""
    xx, yy, zz, xy, xz, yz = M6.unbind(-1)
    M = torch.stack([torch.stack([xx, xy, xz], -1),
                     torch.stack([xy, yy, yz], -1),
                     torch.stack([xz, yz, zz], -1)], -2)      # (..., 3, 3)
    start = torch.argmax(torch.stack([xx, yy, zz], -1), -1)
    v = torch.take_along_dim(M, start[..., None, None], -1)[..., 0]
    v = v + 1e-12
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", M, v)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
    return v


def mean_direction(dirs: torch.Tensor) -> torch.Tensor:
    """Sign-agnostic consensus direction of (N, K, 3) neighbour bundles ->
    (N, 3) (the reference's compute_points_similarity, PMVO_utils.py:366-382):
    each member is flipped into the hemisphere of the bundle's first member,
    the mean is taken, and the member with the largest |cos| to the mean is
    returned (the reference returns a member, the medoid)."""
    sgn = torch.sign(torch.sum(dirs * dirs[:, :1], -1, keepdim=True))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    mean = torch.sum(dirs * sgn, 1)
    mean = mean / torch.linalg.norm(mean, dim=-1, keepdim=True).clamp_min(1e-6)
    cos = torch.abs(torch.sum(dirs * mean[:, None], -1)
                    / torch.linalg.norm(dirs, dim=-1).clamp_min(1e-6))
    best = torch.argmax(cos, 1)
    return torch.take_along_dim(dirs, best[:, None, None], 1)[:, 0]
