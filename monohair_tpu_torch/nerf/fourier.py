"""Fourier-feature MLP field: the coarse NeRF of the shipped configuration
(port of monohair_tpu/nerf/fourier.py; ``pipeline.DEFAULT_FIELD``).

A fixed Gaussian frequency matrix B (Tancik et al., "Fourier Features Let
Networks Learn High Frequency Functions", NeurIPS 2020) maps unit-cube points
to sin/cos features, and a wide MLP follows: every op is a matmul or
elementwise. B is the JAX package's draw jax.random.normal(PRNGKey(11),
(3, F)) * freq_scale, read from ``fourier_b.npz`` (written by
tools/export_fourier_b.py): the port cannot draw with JAX.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .ngp import density_from_head, flax_dense, sh_encoding_deg4

B_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fourier_b.npz")


def fourier_normal(num_features: int) -> np.ndarray:
    """(3, num_features) float32: JAX's normal(PRNGKey(11), (3, F)) draw, the
    first 3 * F values of the shipped flat draw."""
    flat = np.load(B_PATH)["normal"]
    if 3 * num_features > flat.size:
        raise ValueError(f"FourierField: num_features {num_features} > "
                         f"{flat.size // 3}, the width of {B_PATH}; rewrite it with "
                         "tools/export_fourier_b.py")
    return flat[:3 * num_features].reshape(3, num_features)


class FourierField(nn.Module):
    """Random-Fourier-feature MLP with the NGPField head layout.

    num_features Gaussian frequencies at scale `freq_scale` (cycles over the
    unit cube); a trunk of `depth` x `hidden` with one skip from the
    features; a sigma head of 1 + geo_feat; a colour head of hidden // 2 -> 3
    on SH(dir) ++ geo_feat. `sparsity_weight` is read by train_nerf: Fourier
    features are a global basis, so photometric training alone leaks density
    into space no ray sees, and a mean(1 - exp(-0.05 sigma)) penalty at 4096
    uniform points a step is the only gradient there.
    """

    def __init__(self, num_features: int = 128, freq_scale: float = 16.0, hidden: int = 128,
                 depth: int = 4, geo_feat: int = 15, sparsity_weight: float = 1e-3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_features, self.freq_scale = num_features, freq_scale
        self.hidden, self.depth, self.geo_feat = hidden, depth, geo_feat
        self.sparsity_weight = sparsity_weight
        b = torch.as_tensor(fourier_normal(num_features), device=device) * freq_scale
        self.register_buffer("B", b.float(), persistent=False)
        enc = 2 * num_features
        kw = dict(generator=generator, device=device)
        self.trunk = nn.ModuleList([flax_dense(enc if i == 0 else hidden, hidden, **kw)
                                    for i in range(depth)])
        # flax creates the skip's kernel only where it is used
        self.skip = flax_dense(enc, hidden, bias=False, **kw) if depth > 2 else None
        self.sigma_head = flax_dense(hidden, 1 + geo_feat, **kw)
        self.rgb1 = flax_dense(16 + geo_feat, hidden // 2, **kw)
        self.rgb2 = flax_dense(hidden // 2, 3, **kw)

    def flops_per_sample(self) -> float:
        """Analytic forward FLOPs a point sample (both heads); the backward
        is about twice this."""
        enc = 2 * self.num_features
        f = 2 * 3 * self.num_features                    # feature matmul
        f += 2 * enc * self.hidden                       # trunk[0]
        f += 2 * (self.depth - 1) * self.hidden ** 2     # trunk[1:]
        f += 2 * enc * self.hidden                       # skip
        f += 2 * self.hidden * (1 + self.geo_feat)       # sigma head
        f += 2 * (16 + self.geo_feat) * (self.hidden // 2)  # rgb1 (SH deg4)
        f += 2 * (self.hidden // 2) * 3                  # rgb2
        return float(f)

    def features(self, points01: torch.Tensor) -> torch.Tensor:
        ang = (2.0 * np.pi) * (points01 @ self.B)
        return torch.cat([torch.sin(ang), torch.cos(ang)], -1)

    def density(self, points01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = self.features(points01)
        h = torch.relu(self.trunk[0](enc))
        for i, layer in enumerate(self.trunk[1:]):
            h = torch.relu(layer(h))
            if i == 0 and self.depth > 2:     # one skip keeps gradients alive
                h = h + self.skip(enc)
        return density_from_head(self.sigma_head(h))

    def forward(self, points01: torch.Tensor, dirs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma, feat = self.density(points01)
        h = torch.relu(self.rgb1(torch.cat([sh_encoding_deg4(dirs), feat], -1)))
        return sigma, torch.sigmoid(self.rgb2(h))
