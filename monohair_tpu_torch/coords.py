"""World <-> voxel coordinate transforms and the NeRF <-> NGP camera-matrix
conversions (port of monohair_tpu/coords.py).

The world->voxel map *negates y and z*, then rescales into grid indices
(reference: PMVO_utils.py:386-421 `p2v`/`points_to_voxel`/`voxel_to_points`,
HairGrow.py:22-36). Functions take and return torch tensors on any device,
in float32 as the JAX package computes them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .constants import GRID_RESOLUTION, VOXEL_MIN, VOXEL_SIZE

_FLIP = (1.0, -1.0, -1.0)


def world_to_voxel(points: torch.Tensor, voxel_min=VOXEL_MIN,
                   voxel_size: float = VOXEL_SIZE) -> torch.Tensor:
    """(..., 3) world points -> continuous voxel coordinates."""
    points = points.float()
    flip = torch.tensor(_FLIP, dtype=points.dtype, device=points.device)
    vmin = torch.as_tensor(voxel_min, dtype=points.dtype, device=points.device)
    return (points * flip - vmin) / voxel_size


def voxel_to_world(voxels: torch.Tensor, voxel_min=VOXEL_MIN,
                   voxel_size: float = VOXEL_SIZE) -> torch.Tensor:
    """(..., 3) continuous voxel coordinates -> world points (PMVO_utils.py:407-413)."""
    voxels = voxels.float()
    flip = torch.tensor(_FLIP, dtype=voxels.dtype, device=voxels.device)
    vmin = torch.as_tensor(voxel_min, dtype=voxels.dtype, device=voxels.device)
    return (voxels * voxel_size + vmin) * flip


def world_dir_to_voxel(dirs: torch.Tensor) -> torch.Tensor:
    """Direction vectors transform with the y/z negation only (HairGrow.py:894)."""
    return dirs * torch.tensor(_FLIP, dtype=dirs.dtype, device=dirs.device)


voxel_dir_to_world = world_dir_to_voxel  # the map is an involution


def voxel_indices(points: torch.Tensor, voxel_min=VOXEL_MIN,
                  voxel_size: float = VOXEL_SIZE,
                  grid_resolution=GRID_RESOLUTION) -> torch.Tensor:
    """(..., 3) world points -> int32 (x, y, z) grid indices, rounded and clamped.

    torch.round rounds half to even, as jnp.round does.
    """
    idx = torch.round(world_to_voxel(points, voxel_min, voxel_size)).to(torch.int32)
    res = torch.as_tensor([int(r) for r in grid_resolution], dtype=torch.int32,
                          device=points.device)
    return torch.minimum(torch.clamp_min(idx, 0), res - 1)


def flat_voxel_id(idx: torch.Tensor, grid_resolution=GRID_RESOLUTION) -> torch.Tensor:
    """(..., 3) integer indices -> flat ids x*(Ry*Rz) + y*Rz + z."""
    ry, rz = int(grid_resolution[1]), int(grid_resolution[2])
    return (idx[..., 0] * ry + idx[..., 1]) * rz + idx[..., 2]


# ---------------------------------------------------------------------------
# NeRF <-> NGP camera-matrix conversions (numpy float64; host-side plumbing)
# ---------------------------------------------------------------------------

_NGP_OFFSET = np.array([0.5, 0.5, 0.5])
_NGP_SCALE = 0.33


def nerf_to_ngp(xf: np.ndarray) -> np.ndarray:
    """4x4 (or 3x4) NeRF c2w matrix -> 3x4 NGP matrix (ingp_utils.py:9-22)."""
    mat = np.array(xf, dtype=np.float64)[:3, :].copy()
    mat[:, 1] *= -1
    mat[:, 2] *= -1
    mat[:, 3] = mat[:, 3] * _NGP_SCALE + _NGP_OFFSET
    return mat[[1, 2, 0], :]


def ngp_to_nerf(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """3x3 rotation + 3 translation in NGP frame -> 4x4 NeRF c2w (ingp_utils.py:35-44)."""
    mat = np.eye(4)
    mat[:3, :3] = rot
    mat[:3, 3] = trans
    mat = mat[[2, 0, 1, 3], :]
    mat[:3, 3] -= _NGP_OFFSET
    mat[:3, 3] /= _NGP_SCALE
    mat[:, 2] *= -1
    mat[:, 1] *= -1
    return mat


def grid_world_bounds() -> Tuple[np.ndarray, np.ndarray]:
    """World-frame AABB covered by the Occ/Ori grid (accounting for y/z flips)."""
    lo_v = VOXEL_MIN
    hi_v = VOXEL_MIN + VOXEL_SIZE * GRID_RESOLUTION.astype(np.float32)
    corners_w = np.array([lo_v, hi_v]) * np.array(_FLIP)
    return corners_w.min(0), corners_w.max(0)
