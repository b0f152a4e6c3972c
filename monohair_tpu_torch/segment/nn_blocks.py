"""Shared building blocks of the segmentation nets (port of
monohair_tpu/segment/nn_blocks.py), as torch modules in NCHW.

Every submodule carries the name of its flax counterpart, so a flax tree
(``segment/convert.py``) and a torch state dict of the same names
(``tests/golden/torch_nets.py``) both load as they are. Eval-mode semantics:
- BatchNorm: running stats, eps 1e-5; train mode is flax's
  (``ops/norm.py::FlaxBatchNorm2d``: the biased batch variance, flax's
  momentum, here 0.9).
- IBNorm's instance half is flax's GroupNorm(num_groups=C): per-sample spatial
  statistics with the variance taken as E[x^2] - E[x]^2 (clamped at 0), as
  flax takes it, and eps 1e-5.
- ReLU6 for MobileNetV2.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import FlaxBatchNorm2d


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """bilinear, align_corners=False (jax.image.resize's half-pixel rule)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """bilinear without antialiasing, as the JAX package resizes."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class InstanceNorm(nn.Module):
    """flax GroupNorm(num_groups=C) with affine scale and bias."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean((2, 3), keepdim=True)
        var = torch.clamp_min((x * x).mean((2, 3), keepdim=True) - mean * mean, 0.0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class IBNorm(nn.Module):
    """MODNet's IBNorm: BatchNorm on the first half of channels, InstanceNorm
    (affine) on the rest."""

    def __init__(self, channels: int):
        super().__init__()
        self.bnorm = FlaxBatchNorm2d(channels // 2, eps=1e-5, momentum=0.9)
        self.inorm = InstanceNorm(channels - channels // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bc = self.bnorm.num_features
        return torch.cat([self.bnorm(x[:, :bc]), self.inorm(x[:, bc:])], 1)


class ConvIBNormRelu(nn.Module):
    """MODNet Conv2dIBNormRelu."""

    def __init__(self, in_ch: int, out_ch: int, ksize: int = 3, stride: int = 1,
                 with_ibn: bool = True, with_relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, ksize, stride, ksize // 2, bias=not with_ibn)
        self.ibn = IBNorm(out_ch) if with_ibn else None
        self.with_relu = with_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.ibn is not None:
            x = self.ibn(x)
        return F.relu(x) if self.with_relu else x


class SEBlock(nn.Module):
    """Squeeze-excitation (MODNet LRBranch se_block)."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = x.mean((2, 3))
        w = torch.sigmoid(self.fc2(F.relu(self.fc1(w))))
        return x * w[:, :, None, None]


class ConvBNReLU(nn.Module):
    """BiSeNet ConvBNReLU (conv without bias + BN + ReLU)."""

    def __init__(self, in_ch: int, out_ch: int, ksize: int = 3, stride: int = 1,
                 with_relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, ksize, stride, ksize // 2, bias=False)
        self.bn = FlaxBatchNorm2d(out_ch, eps=1e-5, momentum=0.9)
        self.with_relu = with_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.with_relu else x
