"""FAN (Face Alignment Network), the 2D landmark detector of the bust fit's
annotations (port of monohair_tpu/segment/fan.py), as torch modules in NCHW.

Bulat & Tzimiropoulos' FAN (2DFAN-4 at its published size: 4 hourglass
modules of depth 4, 256 features, 256x256 crops): stacked hourglasses over
3-branch residual ConvBlocks, 68 heatmaps at 1/4 of the input. Every
submodule carries its flax name, so the JAX package's flax trees load through
``segment/convert.py``; BatchNorm runs on its running statistics in eval
mode and on flax's batch statistics in train mode.

``FAN(x)`` with x (N, 3, 256, 256) in [0, 1] -> list of (N, 68, 64, 64)
heatmaps, one a module (use the last). ``decode_heatmaps`` is face_alignment's
sub-pixel argmax (+-0.25 toward the larger neighbour), on NHWC numpy.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import FlaxBatchNorm2d


def _bn(channels: int) -> FlaxBatchNorm2d:
    """FAN's norms take flax's default momentum, 0.99."""
    return FlaxBatchNorm2d(channels, eps=1e-5, momentum=0.99)


class ConvBlock(nn.Module):
    """FAN's 3-branch residual block: out = cat(c1, c2, c3) + shortcut."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.bn1 = _bn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch // 2, 3, 1, 1, bias=False)
        self.bn2 = _bn(out_ch // 2)
        self.conv2 = nn.Conv2d(out_ch // 2, out_ch // 4, 3, 1, 1, bias=False)
        self.bn3 = _bn(out_ch // 4)
        self.conv3 = nn.Conv2d(out_ch // 4, out_ch // 4, 3, 1, 1, bias=False)
        if in_ch != out_ch:
            self.down_bn = _bn(in_ch)
            self.down_conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        else:
            self.down_bn = self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.conv1(F.relu(self.bn1(x)))
        y2 = self.conv2(F.relu(self.bn2(y1)))
        y3 = self.conv3(F.relu(self.bn3(y2)))
        out = torch.cat([y1, y2, y3], 1)
        if self.down_conv is not None:
            x = self.down_conv(F.relu(self.down_bn(x)))
        return out + x


class HourGlass(nn.Module):
    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        for level in range(1, depth + 1):
            self.add_module(f"b1_{level}", ConvBlock(features, features))
            self.add_module(f"b2_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module(f"b2_plus_{level}", ConvBlock(features, features))
            self.add_module(f"b3_{level}", ConvBlock(features, features))

    def _level(self, level: int, inp: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{level}")(inp)
        low = getattr(self, f"b2_{level}")(F.avg_pool2d(inp, 2, 2))
        if level > 1:
            low = self._level(level - 1, low)
        else:
            low = getattr(self, f"b2_plus_{level}")(low)
        low = getattr(self, f"b3_{level}")(low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class FAN(nn.Module):
    def __init__(self, num_modules: int = 4, depth: int = 4, width: float = 1.0,
                 num_landmarks: int = 68):
        super().__init__()
        f = max(int(256 * width), 16)
        c64 = max(int(64 * width), 8)
        c128 = max(int(128 * width), 8)
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, c64, 7, 2, 3)
        self.bn1 = _bn(c64)
        self.conv2 = ConvBlock(c64, c128)
        self.conv3 = ConvBlock(c128, c128)
        self.conv4 = ConvBlock(c128, f)
        for m in range(num_modules):
            self.add_module(f"m{m}", HourGlass(depth, f))
            self.add_module(f"top_m_{m}", ConvBlock(f, f))
            self.add_module(f"conv_last{m}", nn.Conv2d(f, f, 1))
            self.add_module(f"bn_end{m}", _bn(f))
            self.add_module(f"l{m}", nn.Conv2d(f, num_landmarks, 1))
            if m < num_modules - 1:
                self.add_module(f"bl{m}", nn.Conv2d(f, f, 1))
                self.add_module(f"al{m}", nn.Conv2d(num_landmarks, f, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.avg_pool2d(self.conv2(x), 2, 2)
        x = self.conv4(self.conv3(x))
        outputs = []
        for m in range(self.num_modules):
            ll = getattr(self, f"top_m_{m}")(getattr(self, f"m{m}")(x))
            ll = F.relu(getattr(self, f"bn_end{m}")(getattr(self, f"conv_last{m}")(ll)))
            heat = getattr(self, f"l{m}")(ll)
            outputs.append(heat)
            if m < self.num_modules - 1:
                x = x + getattr(self, f"bl{m}")(ll) + getattr(self, f"al{m}")(heat)
        return outputs


def decode_heatmaps(heat: np.ndarray) -> np.ndarray:
    """(N, Hh, Wh, L) heatmaps -> (N, L, 2) float32 (x, y) in heatmap pixels:
    the first argmax, moved 0.25 toward the larger neighbour along each axis
    (0 on a tie, none on the border), as face_alignment decodes."""
    heat = np.asarray(heat)
    n, hh, wh, L = heat.shape
    idx = np.argmax(heat.reshape(n, hh * wh, L), axis=1)            # (N, L)
    ys, xs = np.divmod(idx, wh)
    i = np.arange(n)[:, None]
    lm = np.arange(L)[None, :]
    out = np.stack([xs, ys], -1).astype(np.float32)
    inner_x = (xs > 0) & (xs < wh - 1)
    inner_y = (ys > 0) & (ys < hh - 1)
    xr, xl = np.clip(xs + 1, 0, wh - 1), np.clip(xs - 1, 0, wh - 1)
    yd, yu = np.clip(ys + 1, 0, hh - 1), np.clip(ys - 1, 0, hh - 1)
    dx = np.sign(heat[i, ys, xr, lm] - heat[i, ys, xl, lm])
    dy = np.sign(heat[i, yd, xs, lm] - heat[i, yu, xs, lm])
    out[..., 0] += np.where(inner_x, np.float32(0.25) * dx, np.float32(0.0))
    out[..., 1] += np.where(inner_y, np.float32(0.25) * dy, np.float32(0.0))
    return out
