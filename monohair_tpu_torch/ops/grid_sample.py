"""Bilinear grid sampling and clamped integer patch gathers (port of
monohair_tpu/ops/grid_sample.py).

`grid_sample_views` is the pixel-aligned feature lookup of DeepMVSHair
(UnetSimple.py:88, pifu_attn.py:245): torch.nn.functional.grid_sample with
align_corners=False and zero padding, on every device (the JAX package runs it
as plain XLA, outside any Pallas kernel). `grid_sample_2d` is the same
arithmetic written out as four taps, the JAX package's formulation, kept as the
plain version the tests hold the library call against.

`gather_patches` is the clamped integer patch gather of PMVO
(PMVO.py:491-515 get_ori_patch/get_c_patch): for each point it reads a
(patch*patch) window around its pixel, clamping rows/cols independently.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (C, H, W) features at (N, 2) NDC (x, y) coords -> (N, C).

    align_corners=False: pixel = ((coord + 1) * size - 1) / 2 (x -> W, y -> H).
    Out-of-bounds taps contribute zero (padding_mode='zeros').
    """
    C, H, W = feat.shape
    x = ((coords[:, 0] + 1.0) * W - 1.0) * 0.5
    y = ((coords[:, 1] + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(yi, xi, w):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        vals = feat[:, yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]   # (C, N)
        return vals * (w * inb)[None, :]

    out = (tap(y0, x0, (1 - wy) * (1 - wx)) + tap(y0, x0 + 1, (1 - wy) * wx)
           + tap(y0 + 1, x0, wy * (1 - wx)) + tap(y0 + 1, x0 + 1, wy * wx))
    return out.T


def grid_sample_views(feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(V, C, H, W) features at (V, N, 2) NDC coords -> (V, N, C), each view
    sampled at its own coords (grid_sample_2d per view)."""
    out = F.grid_sample(feats, coords[:, :, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=False)      # (V, C, N, 1)
    return out[..., 0].transpose(1, 2)


def gather_patches(image: torch.Tensor, rc: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Gather clamped (patch_size x patch_size) windows.

    image: (H, W) or (H, W, C); rc: (..., 2) integer (row, col).
    Returns (..., patch_size**2) or (..., patch_size**2, C); tap p = i*patch + j
    for row offset i (outer) and column offset j (inner).
    """
    H, W = image.shape[:2]
    half = patch_size // 2
    offs = torch.arange(-half, half + 1, device=rc.device)
    orow = offs.repeat_interleave(patch_size)
    ocol = offs.repeat(patch_size)
    rows = (rc[..., 0:1].long() + orow).clamp(0, H - 1)
    cols = (rc[..., 1:2].long() + ocol).clamp(0, W - 1)
    return image[rows, cols]


def gather_pixels(image: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """Point lookup image[(row, col)] with rc already clamped; (H, W[, C]) -> (...)."""
    return image[rc[..., 0].long(), rc[..., 1].long()]
