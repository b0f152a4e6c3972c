"""MODNet portrait matting network (port of monohair_tpu/segment/modnet.py).

A MobileNetV2 encoder with three decoders: LRBranch (semantic, /8), HRBranch
(detail, /1) and FusionBranch (the matte). Input (N, 3, H, W) normalised to
[-1, 1] with H and W multiples of 32; the matte is (N, 1, H, W) in [0, 1].
Channel widths scale with `width` (1.0 = the published net).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .backbones import MobileNetV2, make_divisible
from .nn_blocks import ConvIBNormRelu, SEBlock, resize_bilinear, upsample2x


class LRBranch(nn.Module):
    def __init__(self, enc32_ch: int, width: float):
        super().__init__()
        c16, c8 = max(int(96 * width), 8), max(int(32 * width), 4)
        self.se_block = SEBlock(enc32_ch)
        self.conv_lr16x = ConvIBNormRelu(enc32_ch, c16, 5)
        self.conv_lr8x = ConvIBNormRelu(c16, c8, 5)
        self.conv_lr = ConvIBNormRelu(c8, 1, 3, with_ibn=False, with_relu=False)

    def forward(self, enc32x):
        x = self.conv_lr16x(upsample2x(self.se_block(enc32x)))
        lr8x = self.conv_lr8x(upsample2x(x))
        return torch.sigmoid(self.conv_lr(lr8x)), lr8x


class HRBranch(nn.Module):
    def __init__(self, enc2_ch: int, enc4_ch: int, lr8_ch: int, width: float):
        super().__init__()
        hr = max(int(32 * width), 4)
        self.tohr_enc2x = ConvIBNormRelu(enc2_ch, hr, 1)
        self.conv_enc2x = ConvIBNormRelu(hr + 3, hr, 3, stride=2)
        self.tohr_enc4x = ConvIBNormRelu(enc4_ch, hr, 1)
        self.conv_enc4x = ConvIBNormRelu(2 * hr, 2 * hr, 3)
        inc = 2 * hr + lr8_ch + 3
        for i, c in enumerate((2 * hr, 2 * hr, hr)):
            self.add_module(f"conv_hr4x_{i}", ConvIBNormRelu(inc, c, 3))
            inc = c
        inc = 2 * hr
        for i, c in enumerate((2 * hr, hr, hr, hr)):
            self.add_module(f"conv_hr2x_{i}", ConvIBNormRelu(inc, c, 3))
            inc = c
        self.conv_hr_0 = ConvIBNormRelu(hr + 3, hr, 3)
        self.conv_hr_1 = ConvIBNormRelu(hr, 1, 1, with_ibn=False, with_relu=False)

    def forward(self, img, enc2x, enc4x, lr8x):
        H, W = img.shape[2:]
        img2x = resize_bilinear(img, (H // 2, W // 2))
        img4x = resize_bilinear(img, (H // 4, W // 4))
        enc2x = self.tohr_enc2x(enc2x)
        hr4x = self.conv_enc2x(torch.cat([img2x, enc2x], 1))
        enc4x = self.tohr_enc4x(enc4x)
        hr4x = self.conv_enc4x(torch.cat([hr4x, enc4x], 1))
        x = torch.cat([hr4x, upsample2x(lr8x), img4x], 1)
        for i in range(3):
            x = getattr(self, f"conv_hr4x_{i}")(x)
        x = torch.cat([upsample2x(x), enc2x], 1)
        for i in range(4):
            x = getattr(self, f"conv_hr2x_{i}")(x)
        hr2x = x
        d = self.conv_hr_0(torch.cat([upsample2x(hr2x), img], 1))
        return torch.sigmoid(self.conv_hr_1(d)), hr2x


class FusionBranch(nn.Module):
    def __init__(self, lr8_ch: int, width: float):
        super().__init__()
        hr = max(int(32 * width), 4)
        self.conv_lr4x = ConvIBNormRelu(lr8_ch, hr, 5)
        self.conv_f2x = ConvIBNormRelu(2 * hr, hr, 3)
        self.conv_f_0 = ConvIBNormRelu(hr + 3, max(hr // 2, 2), 3)
        self.conv_f_1 = ConvIBNormRelu(max(hr // 2, 2), 1, 1, with_ibn=False,
                                       with_relu=False)

    def forward(self, img, lr8x, hr2x):
        lr2x = upsample2x(self.conv_lr4x(upsample2x(lr8x)))
        f2x = self.conv_f2x(torch.cat([lr2x, hr2x], 1))
        f = self.conv_f_0(torch.cat([upsample2x(f2x), img], 1))
        return torch.sigmoid(self.conv_f_1(f))


class MODNet(nn.Module):
    def __init__(self, width: float = 1.0):
        super().__init__()
        self.backbone = MobileNetV2(width)
        lr8 = max(int(32 * width), 4)
        self.lr_branch = LRBranch(max(make_divisible(1280 * width), 32), width)
        self.hr_branch = HRBranch(make_divisible(16 * width), make_divisible(24 * width),
                                  lr8, width)
        self.f_branch = FusionBranch(lr8, width)

    def forward(self, img):
        """img (N,3,H,W) in [-1,1] -> (semantic /8, detail /1, matte /1)."""
        enc2x, enc4x, enc32x = self.backbone(img)
        semantic, lr8x = self.lr_branch(enc32x)
        detail, hr2x = self.hr_branch(img, enc2x, enc4x, lr8x)
        return semantic, detail, self.f_branch(img, lr8x, hr2x)
