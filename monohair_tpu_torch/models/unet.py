"""4-level UNet backbone with multi-scale pixel-aligned feature output
(port of monohair_tpu/models/unet.py; DeepMVSHair UnetSimple.py:63-102).

Channels (16, 32, 64, 128), 5x5 convolutions on the encoder (pifu_attn.py:162)
and 3x3 on the decoder; BatchNorm eps 1e-5, with flax's statistics in train
mode (`ops/norm.py::FlaxBatchNorm2d`, momentum 0.9). Layout is NCHW, and the
module names are the reference's, so its state dict loads as it is.
Returns the four maps [d3 (/8, 128ch), u1 (/4, 64ch), u2 (/2, 32ch),
u3 (/1, 16ch)] whose grid-sampled concat is the 240-dim pixel-aligned feature.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.norm import FlaxBatchNorm2d


class DoubleConv(nn.Module):
    """(Conv, BatchNorm, ReLU) twice; 'same' padding."""

    def __init__(self, cin: int, cout: int, ksize: int = 3):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, ksize, padding=ksize // 2), FlaxBatchNorm2d(cout, eps=1e-5),
            nn.ReLU(),
            nn.Conv2d(cout, cout, ksize, padding=ksize // 2), FlaxBatchNorm2d(cout, eps=1e-5),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int, ksize: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout, ksize))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """2x up-sampling (ConvTranspose2d k3 s2 p1 op1) cropped to the skip's
    size, concatenated after the skip, then a 3x3 DoubleConv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cin // 2, 3, stride=2, padding=1, output_padding=1)
        self.conv = DoubleConv(cin, cout)

    def forward(self, deep: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = self.up(deep)[:, :, :skip.shape[2], :skip.shape[3]]
        return self.conv(torch.cat([skip, y], 1))


class UNetSimple(nn.Module):
    def __init__(self, in_feat: int = 4, ksize: int = 5,
                 num_chan: Sequence[int] = (16, 32, 64, 128)):
        super().__init__()
        c = num_chan
        self.inc = DoubleConv(in_feat, c[0], ksize)
        self.down1 = Down(c[0], c[1], ksize)
        self.down2 = Down(c[1], c[2], ksize)
        self.down3 = Down(c[2], c[3], ksize)
        self.up1 = Up(c[3], c[2])
        self.up2 = Up(c[2], c[1])
        self.up3 = Up(c[1], c[0])
        self.output_feat = sum(c)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (V, C, H, W) -> four NCHW feature maps (coarsest first)."""
        f0 = self.inc(x)
        d1 = self.down1(f0)
        d2 = self.down2(d1)
        d3 = self.down3(d2)
        u1 = self.up1(d3, d2)
        u2 = self.up2(u1, d1)
        u3 = self.up3(u2, f0)
        return d3, u1, u2, u3


class ShallowEncoder(nn.Module):
    """Encoder-only ablation backbone (UnetSimple.py:104-143): three conv
    stages at `ksize`, no decoder; the 112-dim pixel-aligned feature.
    A flax tree loads through models.convert.shallow_encoder_state_from_flax."""

    def __init__(self, in_feat: int = 4, ksize: int = 5, num_chan: Sequence[int] = (16, 32, 64)):
        super().__init__()
        c = num_chan
        self.inc = DoubleConv(in_feat, c[0], ksize)
        self.down1 = Down(c[0], c[1], ksize)
        self.down2 = Down(c[1], c[2], ksize)
        self.output_feat = sum(c)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (V, C, H, W) -> three NCHW feature maps (finest first)."""
        f0 = self.inc(x)
        d1 = self.down1(f0)
        return f0, d1, self.down2(d1)
