"""Backbones of the segmentation nets (port of monohair_tpu/segment/backbones.py).

MobileNetV2 is MODNet's encoder, tapped at enc2x (/2), enc4x (/4) and enc32x
(/32). ResNet-18 is BiSeNet's context path, tapped at feat8/feat16/feat32.
A `width` multiplier scales every channel count (1.0 = the published nets).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import FlaxBatchNorm2d
from .nn_blocks import ConvBNReLU


def make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding for width-scaled MobileNetV2."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU6(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, ksize: int = 3, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, ksize, stride, ksize // 2, groups=groups,
                              bias=False)
        self.bn = FlaxBatchNorm2d(out_ch, eps=1e-5, momentum=0.9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int):
        super().__init__()
        hidden = int(round(in_ch * expand))
        self.pw = ConvBNReLU6(in_ch, hidden, 1) if expand != 1 else None
        self.dw = ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden)
        self.pwl = nn.Conv2d(hidden, out_ch, 1, bias=False)
        self.pwl_bn = FlaxBatchNorm2d(out_ch, eps=1e-5, momentum=0.9)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw(x) if self.pw is not None else x
        y = self.pwl_bn(self.pwl(self.dw(y)))
        return x + y if self.residual else y


# (expand t, channels c, repeats n, stride s) — the MobileNetV2 paper table
MBV2_CFG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2(nn.Module):
    def __init__(self, width: float = 1.0):
        super().__init__()
        ch = make_divisible(32 * width)
        self.stem = ConvBNReLU6(3, ch, 3, 2)
        self.taps = {}
        idx = 0
        for t, c, n, s in MBV2_CFG:
            out_ch = make_divisible(c * width)
            for i in range(n):
                self.add_module(f"block{idx}",
                                InvertedResidual(ch, out_ch, s if i == 0 else 1, t))
                ch = out_ch
                idx += 1
            if c in (16, 24):
                self.taps[idx - 1] = "enc2x" if c == 16 else "enc4x"
        self.n_blocks = idx
        # head channel floor keeps narrow test nets functional
        self.head = ConvBNReLU6(ch, max(make_divisible(1280 * width), 32), 1)

    def forward(self, x: torch.Tensor):
        """x (N,3,H,W) -> (enc2x, enc4x, enc32x)."""
        x = self.stem(x)
        taps = {}
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
            if i in self.taps:
                taps[self.taps[i]] = x
        return taps["enc2x"], taps["enc4x"], self.head(x)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBNReLU(in_ch, out_ch, 3, stride)
        self.conv2 = ConvBNReLU(out_ch, out_ch, 3, 1, with_relu=False)
        self.down = (ConvBNReLU(in_ch, out_ch, 1, stride, with_relu=False)
                     if stride != 1 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.down is not None:
            x = self.down(x)
        return F.relu(x + y)


class ResNet18(nn.Module):
    def __init__(self, width: float = 1.0):
        super().__init__()
        ch = int(64 * width)
        self.stem = ConvBNReLU(3, ch, 7, 2)
        for li, (c, s) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            for bi in range(2):
                self.add_module(f"layer{li + 1}_{bi}",
                                BasicBlock(ch, int(c * width), s if bi == 0 else 1))
                ch = int(c * width)

    def forward(self, x: torch.Tensor):
        """x (N,3,H,W) -> (feat8, feat16, feat32)."""
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        feats = []
        for li in range(4):
            for bi in range(2):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
            feats.append(x)
        return feats[1], feats[2], feats[3]
