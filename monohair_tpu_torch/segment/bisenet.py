"""BiSeNet face/hair parsing network (port of monohair_tpu/segment/bisenet.py).

The face-parsing variant of BiSeNet: a ResNet-18 context path whose feat8
doubles as the spatial stream, attention refinement on feat16/feat32, feature
fusion and three heads. Its CelebAMask-HQ labels include hair (class 17).
Input (N, 3, H, W) ImageNet-normalised; returns (out, out16, out32) logits,
each (N, n_classes, H, W).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import FlaxBatchNorm2d
from .backbones import ResNet18
from .nn_blocks import ConvBNReLU, resize_bilinear


class AttentionRefinement(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, out_ch, 3)
        self.conv_atten = nn.Conv2d(out_ch, out_ch, 1, bias=False)
        self.bn_atten = FlaxBatchNorm2d(out_ch, eps=1e-5, momentum=0.99)   # flax's default

    def forward(self, x):
        feat = self.conv(x)
        att = self.bn_atten(self.conv_atten(feat.mean((2, 3), keepdim=True)))
        return feat * torch.sigmoid(att)


class ContextPath(nn.Module):
    def __init__(self, width: float = 1.0):
        super().__init__()
        mid = max(int(128 * width), 8)
        self.resnet = ResNet18(width)
        c16, c32 = int(256 * width), int(512 * width)
        self.conv_avg = ConvBNReLU(c32, mid, 1)
        self.arm32 = AttentionRefinement(c32, mid)
        self.conv_head32 = ConvBNReLU(mid, mid, 3)
        self.arm16 = AttentionRefinement(c16, mid)
        self.conv_head16 = ConvBNReLU(mid, mid, 3)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean((2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg.expand(-1, -1, *feat32.shape[2:])
        f32_up = self.conv_head32(resize_bilinear(f32, feat16.shape[2:]))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(resize_bilinear(f16, feat8.shape[2:]))
        return feat8, f16_up, f32_up   # spatial, cp8, cp16


class FeatureFusion(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_ch, out_ch, 1)
        self.conv1 = nn.Conv2d(out_ch, out_ch // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(out_ch // 4, out_ch, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        att = feat.mean((2, 3), keepdim=True)
        att = torch.sigmoid(self.conv2(F.relu(self.conv1(att))))
        return feat + feat * att


class SegHead(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, mid_ch, 3)
        self.conv_out = nn.Conv2d(mid_ch, n_classes, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, n_classes: int = 19, width: float = 1.0):
        super().__init__()
        mid = max(int(128 * width), 8)
        fuse = max(int(256 * width), 16)
        head = max(int(64 * width), 8)
        self.cp = ContextPath(width)
        self.ffm = FeatureFusion(int(128 * width) + mid, fuse)
        self.conv_out = SegHead(fuse, fuse, n_classes)
        self.conv_out16 = SegHead(mid, head, n_classes)
        self.conv_out32 = SegHead(mid, head, n_classes)

    def forward(self, img):
        size = img.shape[2:]
        feat_sp, feat_cp8, feat_cp16 = self.cp(img)
        out = self.conv_out(self.ffm(feat_sp, feat_cp8))
        return (resize_bilinear(out, size),
                resize_bilinear(self.conv_out16(feat_cp8), size),
                resize_bilinear(self.conv_out32(feat_cp16), size))


# CelebAMask-HQ label ids (face-parsing.PyTorch ordering)
HAIR_CLASS = 17
