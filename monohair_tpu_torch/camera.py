"""Batched pinhole/NDC camera math on torch tensors (port of monohair_tpu/camera.py).

A camera *set* is two stacked tensors — NDC intrinsics ``(V, 4)`` and
world-to-camera poses ``(V, 4, 4)`` — and every operation is vectorized over
both the view axis and the point axis.

Conventions (identical to the reference):
- ``ndc`` intrinsics are (fx, fy, cx, cy) in NDC units.
- Projection divides by the *camera z* (not -z): ``u = fx*x/z + cx``; z is
  negative in front of the camera.
- Pixel mapping: col = (-u + 1)/2 * W,   row = (v + 1)/2 * H
- Normalized depth = (-z)/DEPTH_RANGE, stored on disk scaled by 255.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .constants import DEPTH_RANGE, Z_FAR, Z_NEAR


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of V cameras. ``ndc``: (V, 4) = (fx, fy, cx, cy); ``w2c``: (V, 4, 4)."""

    ndc: torch.Tensor
    w2c: torch.Tensor

    @property
    def num_views(self) -> int:
        return self.ndc.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ndc.device

    @classmethod
    def from_numpy(cls, ndc, w2c, device="cuda") -> "Cameras":
        """From (V, 4) intrinsics and (V, 4, 4) world-to-camera arrays."""
        return cls(torch.as_tensor(np.array(ndc, np.float32), device=device),
                   torch.as_tensor(np.array(w2c, np.float32), device=device))

    @classmethod
    def from_json_list(cls, cam_list, device="cuda") -> "Cameras":
        """Build from the `cam_list` entries of cam_params.json.

        The JSON stores camera-to-world poses; they are inverted in float64 on
        the host, then cast to float32 (as the JAX package does).
        """
        ndc = np.array([c["ndc_prj"] for c in cam_list], dtype=np.float64)
        c2w = np.array([c["pose"] for c in cam_list], dtype=np.float64)
        return cls.from_numpy(ndc, np.linalg.inv(c2w), device)

    def __getitem__(self, idx) -> "Cameras":
        if isinstance(idx, np.ndarray):
            idx = torch.as_tensor(idx, device=self.ndc.device)
        ndc = self.ndc[idx]
        w2c = self.w2c[idx]
        if ndc.ndim == 1:  # single camera: keep a view axis
            ndc, w2c = ndc[None], w2c[None]
        return Cameras(ndc, w2c)


def projection_matrix(ndc: torch.Tensor) -> torch.Tensor:
    """(..., 4) NDC intrinsics -> (..., 4, 4) OpenGL projection (Camera_utils.py:19-36)."""
    fx, fy, cx, cy = ndc.unbind(-1)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    m = (-Z_FAR - Z_NEAR) / (Z_FAR - Z_NEAR) * one
    n = -2.0 * Z_FAR * Z_NEAR / (Z_FAR - Z_NEAR) * one
    return torch.stack([torch.stack([fx, zero, cx, zero], -1),
                        torch.stack([zero, fy, cy, zero], -1),
                        torch.stack([zero, zero, m, n], -1),
                        torch.stack([zero, zero, -one, zero], -1)], -2)


def world_to_cam(w2c: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (V, 4, 4) w2c to (N, 3) points -> (V, N, 3) camera-space points."""
    return torch.einsum("vij,nj->vni", w2c[:, :3, :3], pts) + w2c[:, None, :3, 3]


def cam_to_world(w2c: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Inverse of world_to_cam for (V, N, 3) camera points."""
    return torch.einsum("vji,vnj->vni", w2c[:, :3, :3], pts_cam - w2c[:, None, :3, 3])


def project(cameras: Cameras, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project (N, 3) world points into all views.

    Returns ``uv``: (V, N, 2) NDC coords and ``z``: (V, N) camera z.
    """
    cam = world_to_cam(cameras.w2c, pts)
    z = cam[..., 2]
    fx, fy, cx, cy = cameras.ndc.unbind(-1)
    u = fx[:, None] * cam[..., 0] / z + cx[:, None]
    v = fy[:, None] * cam[..., 1] / z + cy[:, None]
    return torch.stack([u, v], -1), z


def ndc_to_pixel(uv: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """NDC (..., 2) -> continuous pixel (row, col). image_size = (H, W)."""
    H, W = image_size
    col = (-uv[..., 0] + 1.0) * 0.5 * W
    row = (uv[..., 1] + 1.0) * 0.5 * H
    return torch.stack([row, col], -1)


def pixel_to_ndc(rc: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """Continuous pixel (row, col) -> NDC (u, v). Inverse of ndc_to_pixel."""
    H, W = image_size
    u = -(rc[..., 1] / W * 2.0 - 1.0)
    v = rc[..., 0] / H * 2.0 - 1.0
    return torch.stack([u, v], -1)


def pixel_index_and_validity(uv: torch.Tensor, image_size: Tuple[int, int]
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round NDC projections to int32 (row, col) indices, clamped, plus an
    out-of-bounds mask (True = outside). Rounds (half to even) *then*
    bounds-checks the unclamped values, then clamps."""
    H, W = image_size
    rc = torch.round(ndc_to_pixel(uv, image_size)).to(torch.int32)
    row, col = rc[..., 0], rc[..., 1]
    invalid = (col > W - 1) | (col < 0) | (row > H - 1) | (row < 0)
    rc = torch.stack([row.clamp(0, H - 1), col.clamp(0, W - 1)], -1)
    return rc, invalid


def unproject(cameras: Cameras, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Lift NDC coords (V, N, 2) at camera depth z (V, N) back to world (V, N, 3)."""
    fx, fy, cx, cy = cameras.ndc.unbind(-1)
    x = (uv[..., 0] - cx[:, None]) / fx[:, None] * z
    y = (uv[..., 1] - cy[:, None]) / fy[:, None] * z
    return cam_to_world(cameras.w2c, torch.stack([x, y, z], -1))


def normalized_depth(z: torch.Tensor) -> torch.Tensor:
    """Camera z -> normalized depth in [0, ~1]: (-z)/DEPTH_RANGE (PMVO.py:392)."""
    return -z / DEPTH_RANGE


def depth_to_z(depth255: torch.Tensor) -> torch.Tensor:
    """Disk depth (0..255 scale) -> camera z (negative): z = -d/255*2 (PMVO.py:313)."""
    return -(depth255 / 255.0) * DEPTH_RANGE
