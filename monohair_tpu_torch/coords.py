"""World <-> voxel coordinate transforms (port of the voxel half of
monohair_tpu/coords.py; the NeRF/NGP converters belong to stage 1).

The world->voxel map *negates y and z*, then rescales into grid indices
(reference: PMVO_utils.py:386-421 `p2v`/`points_to_voxel`/`voxel_to_points`,
HairGrow.py:22-36). Functions take and return torch tensors on any device,
in float32 as the JAX package computes them.
"""

from __future__ import annotations

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
