"""Dense multiscale feature-grid field (port of monohair_tpu/nerf/dense_grid.py).

Each level is stored z-packed as (R, R, R*F): the features of cell
(ix, iy, iz) and of its +z neighbour lie in one contiguous 2F-wide row
starting at (ix, iy, iz*F), so a point reads 4 rows a level. The layout is
the JAX package's, so its weights load unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .ngp import density_from_head, flax_dense, flax_uniform_, sh_encoding_deg4


class DenseGridConfig(NamedTuple):
    resolutions: Tuple[int, ...] = (64, 160, 256)
    features_per_level: int = 4


def grid_encode_level(grid_zf: torch.Tensor, points01: torch.Tensor,
                      features: int) -> torch.Tensor:
    """One level: (R0, R1, R2*F) z-packed grid, (N, 3) points in [0, 1] ->
    (F, N) trilinear features, xy corners summed in (0,0), (0,1), (1,0),
    (1,1) order."""
    F = features
    R = (grid_zf.shape[0], grid_zf.shape[1], grid_zf.shape[2] // F)
    p = points01.float()
    x = p[:, 0] * (R[0] - 1)
    y = p[:, 1] * (R[1] - 1)
    z = p[:, 2] * (R[2] - 1)
    ix = torch.clamp(torch.floor(x), 0, R[0] - 2).long()
    iy = torch.clamp(torch.floor(y), 0, R[1] - 2).long()
    iz = torch.clamp(torch.floor(z), 0, R[2] - 2).long()
    wx, wy, wz = x - ix, y - iy, z - iz
    flat = grid_zf.reshape(-1)
    row = torch.arange(2 * F, device=grid_zf.device)
    out = torch.zeros((F, p.shape[0]), dtype=grid_zf.dtype, device=grid_zf.device)
    for cx, cy in ((0, 0), (0, 1), (1, 0), (1, 1)):
        start = ((ix + cx) * R[1] + (iy + cy)) * grid_zf.shape[2] + iz * F
        rows = flat[start[:, None] + row].T                      # (2F, N): (dz, f)
        wxy = (wx if cx else 1.0 - wx) * (wy if cy else 1.0 - wy)
        out = out + (rows[:F] * (1.0 - wz) + rows[F:] * wz) * wxy
    return out


def grid_encode(grids: Sequence[torch.Tensor], points01: torch.Tensor,
                cfg: DenseGridConfig) -> torch.Tensor:
    """All levels -> (N, L*F) features (hash_encode's output convention)."""
    return torch.cat([grid_encode_level(g, points01, cfg.features_per_level)
                      for g in grids], 0).T


def grid_tv_loss(grids: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean squared finite difference along each axis of every level,
    averaged: the Plenoxels/DVGO smoothness prior."""
    total = 0.0
    for g in grids:
        for ax in range(3):
            d = torch.diff(g, dim=ax)
            total = total + torch.mean(d * d)
    return total / (3 * len(grids))


class DenseGridField(nn.Module):
    """NGPField's heads on dense z-packed grids."""

    def __init__(self, cfg: DenseGridConfig = DenseGridConfig(), hidden: int = 64,
                 geo_feat: int = 15, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        F = cfg.features_per_level
        self.grids = nn.ParameterList([
            nn.Parameter(flax_uniform_(torch.empty((r, r, r * F), device=device), 2e-4,
                                       generator))
            for r in cfg.resolutions])
        kw = dict(generator=generator, device=device)
        self.sigma1 = flax_dense(len(cfg.resolutions) * F, hidden, **kw)
        self.sigma2 = flax_dense(hidden, 1 + geo_feat, **kw)
        self.rgb1 = flax_dense(16 + geo_feat, hidden, **kw)
        self.rgb2 = flax_dense(hidden, hidden, **kw)
        self.rgb3 = flax_dense(hidden, 3, **kw)

    def density(self, points01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = grid_encode(list(self.grids), points01, self.cfg)
        return density_from_head(self.sigma2(torch.relu(self.sigma1(enc))))

    def tv(self) -> torch.Tensor:
        return grid_tv_loss(list(self.grids))

    def forward(self, points01: torch.Tensor, dirs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma, feat = self.density(points01)
        h = torch.cat([sh_encoding_deg4(dirs), feat], -1)
        h = torch.relu(self.rgb1(h))
        h = torch.relu(self.rgb2(h))
        return sigma, torch.sigmoid(self.rgb3(h))
