"""OpenCV's resizes, gray conversions and sharpness, on tensors on any device.

Stage 1 feeds its nets and its Gabor bank through OpenCV in the JAX package
(``cv2.resize``, ``cv2.cvtColor``, ``cv2.imread(..., IMREAD_GRAYSCALE)``,
``cv2.Laplacian``). These functions write OpenCV's rules out, so that the port
needs no OpenCV and gives the same pixels:

- ``resize_area`` (``INTER_AREA``): shrinking averages the source cells each
  destination pixel covers, with OpenCV's cell tables and its order of f32
  sums; enlarging is OpenCV's linear rule with the area mode's coefficients
  (neither nearest nor bilinear).
- ``resize_linear`` (``INTER_LINEAR``): uint8 in 11-bit fixed point, bitwise;
  float in f32. Float images take their source positions in float64, as
  OpenCV does (an f32 position is 1e-4 off at x ~ 1000); uint8 images in f32.
- ``resize_cubic`` (``INTER_CUBIC``, float): OpenCV's 4-tap kernel
  (a = -0.75, half-pixel centres, replicated border) in f32.
- ``bgr_to_gray`` (``cvtColor(BGR2GRAY)``, 15-bit fixed point) and
  ``png_rgb_to_gray`` (``IMREAD_GRAYSCALE``: libpng's 15-bit conversion,
  truncated), both integer arithmetic and bitwise.
- ``laplacian_variance``: ``cv2.Laplacian(gray, CV_64F).var()`` (ksize 1,
  ``BORDER_REFLECT_101``) in float64.

Images are (N, C, H, W) tensors; sizes are (height, width).
"""

from __future__ import annotations

import math
import sys
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_COEF_BITS = 11                 # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
# torch.round rounds half to even, as OpenCV's cvRound does


def _f32(x: float) -> float:
    """x rounded to float32, as a C++ (float) cast rounds it."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# coefficient tables (host, float64 as OpenCV computes them)
# ---------------------------------------------------------------------------

def _linear_table(src: int, dst: int, area_mode: bool, rows: bool = False,
                  fixed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Per destination index: the left source index and the f32 weight of the
    right tap (resizeGeneric's xofs/alpha for ksize 2). area_mode is
    INTER_AREA enlarging, which takes the linear path with its own fx.
    Columns past the border take the edge pixel with weight 1; rows keep their
    weights, and both taps read the clamped edge row (resizeGeneric clamps
    fx but not fy). The source position is rounded to f32 for uint8 images
    (fixed) and kept in float64 for float images, as OpenCV takes them."""
    inv_scale = dst / src
    scale = 1.0 / inv_scale
    d = np.arange(dst, dtype=np.float64)
    if not area_mode:
        pos = (d + 0.5) * scale - 0.5
        if fixed:
            pos = pos.astype(np.float32).astype(np.float64)
        sx = np.floor(pos)
        fx = (pos - sx).astype(np.float32)
    else:
        sx = np.floor(d * scale)
        fx = ((d + 1) - (sx + 1) * inv_scale).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    sx = sx.astype(np.int64)
    if not rows:
        edge = (sx < 0) | (sx >= src - 1)
        fx = np.where(edge, np.float32(0), fx)
        sx = np.clip(sx, 0, src - 1)
    return sx, fx


def _area_table(src: int, dst: int) -> List[List[Tuple[int, float]]]:
    """computeResizeAreaTab: per destination index, its (source index, f32
    weight) taps in OpenCV's order."""
    scale = src / dst
    taps = []
    for d in range(dst):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, _f32((sx1 - fsx1) / cell)))
        for s in range(sx1, sx2):
            row.append((s, _f32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, _f32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        taps.append(row)
    return taps


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def _linear_pass(x: torch.Tensor, dim: int, sx: np.ndarray, fx: np.ndarray,
                 fixed: bool) -> torch.Tensor:
    """One axis of the two-tap rule: float x -> x[sx] * (1 - fx) + x[sx+1] * fx;
    uint8 (fixed) -> int32 sums with 11-bit weights."""
    n = x.shape[dim]
    dev = x.device
    i0 = torch.as_tensor(sx, device=dev)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    i0 = torch.clamp(i0, 0, n - 1)
    a1 = torch.as_tensor(fx, device=dev)
    a0 = 1.0 - a1
    shape = [1] * x.dim()
    shape[dim] = len(sx)
    if fixed:
        a0 = torch.round(a0 * _COEF_SCALE).to(torch.int32)
        a1 = torch.round(a1 * _COEF_SCALE).to(torch.int32)
    a0, a1 = a0.reshape(shape), a1.reshape(shape)
    return x.index_select(dim, i0) * a0 + x.index_select(dim, i1) * a1


def _linear(x: torch.Tensor, size: Tuple[int, int], area_mode: bool) -> torch.Tensor:
    H, W = x.shape[-2:]
    h, w = size
    fixed = x.dtype == torch.uint8
    xs = _linear_table(W, w, area_mode, fixed=fixed)
    ys = _linear_table(H, h, area_mode, rows=True, fixed=fixed)
    if not fixed:
        t = _linear_pass(x.float(), -1, *xs, fixed=False)
        return _linear_pass(t, -2, *ys, fixed=False)
    t = _linear_pass(x.to(torch.int32), -1, *xs, fixed=True) >> 4
    i0 = torch.as_tensor(ys[0], device=x.device)
    i1 = torch.clamp(i0 + 1, 0, H - 1)
    i0 = torch.clamp(i0, 0, H - 1)
    b1 = torch.as_tensor(ys[1], device=x.device)
    b0 = torch.round((1.0 - b1) * _COEF_SCALE).to(torch.int32)[:, None]
    b1 = torch.round(b1 * _COEF_SCALE).to(torch.int32)[:, None]
    # VResizeLinear<uchar>: ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2 >> 2
    out = (((b0 * t.index_select(-2, i0)) >> 16) + ((b1 * t.index_select(-2, i1)) >> 16)
           + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def _area_pass(x: torch.Tensor, dim: int, taps: List[List[Tuple[int, float]]]
               ) -> List[torch.Tensor]:
    """Per tap slot k: (x gathered at every destination's k-th source, its
    weights); destinations with fewer taps get weight 0 at source 0."""
    K = max(len(t) for t in taps)
    out = []
    for k in range(K):
        idx = torch.tensor([t[k][0] if k < len(t) else 0 for t in taps], device=x.device)
        wt = torch.tensor([t[k][1] if k < len(t) else 0.0 for t in taps],
                          dtype=torch.float32, device=x.device)
        shape = [1] * x.dim()
        shape[dim] = len(taps)
        out.append((x.index_select(dim, idx), wt.reshape(shape)))
    return out


def _area_general(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """resizeArea: f32 row sums buf = ((0 + S*a0) + S*a1) + ..., then column sums
    sum = b0*buf0 + b1*buf1 + ..., in OpenCV's order; uint8 rounds half to even."""
    H, W = x.shape[-2:]
    h, w = size
    xf = x.float()
    buf = None
    for src, a in _area_pass(xf, -1, _area_table(W, w)):
        term = src * a
        buf = term if buf is None else buf + term
    out = None
    for rows, b in _area_pass(buf, -2, _area_table(H, h)):
        term = b * rows
        out = term if out is None else out + term
    if x.dtype == torch.uint8:
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    return out


def _area_fast(x: torch.Tensor, sx: int, sy: int) -> torch.Tensor:
    """resizeAreaFast for integer factors: block sums; uint8 2x2 blocks as
    (sum + 2) >> 2, other uint8 blocks as round(sum * f32(1 / area))."""
    N, C, H, W = x.shape
    h, w = H // sy, W // sx
    blocks = x[..., :h * sy, :w * sx].reshape(N, C, h, sy, w, sx)
    if x.dtype == torch.uint8:
        s = blocks.to(torch.int32).sum((3, 5))
        if sx == 2 and sy == 2:
            return ((s + 2) >> 2).to(torch.uint8)
        return torch.round(s.float() * _f32(1.0 / (sx * sy))).clamp(0, 255).to(torch.uint8)
    return blocks.float().sum((3, 5)) * _f32(1.0 / (sx * sy))


def resize_area(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(..., INTER_AREA) of (N, C, H, W) uint8 or float to size (h, w)."""
    H, W = x.shape[-2:]
    h, w = size
    if (h, w) == (H, W):
        return x.clone()
    scale_x, scale_y = W / w, H / h
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = round(scale_x), round(scale_y)
        eps = sys.float_info.epsilon
        if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
            return _area_fast(x, ix, iy)
        return _area_general(x, size)
    return _linear(x, size, area_mode=True)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) of (N, C, H, W) uint8 (fixed point) or float."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x.clone()
    return _linear(x, size, area_mode=False)


def _cubic_pass(x: torch.Tensor, dim: int, src: int, dst: int) -> torch.Tensor:
    """One axis of INTER_CUBIC: 4 taps at sx - 1 .. sx + 2 (clamped to the
    border), OpenCV's f32 coefficients (a = -0.75), summed in tap order."""
    A = -0.75
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    sx = np.floor(pos)
    t = (pos - sx).astype(np.float32)
    c0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    c1 = ((A + 2) * t - (A + 3)) * t * t + 1
    c2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    w = torch.as_tensor(np.stack([c0, c1, c2, 1 - c0 - c1 - c2], 1), device=x.device)
    base = torch.as_tensor(sx.astype(np.int64), device=x.device)
    shape = [1] * x.dim()
    shape[dim] = dst
    out = None
    for k in range(4):
        idx = torch.clamp(base + (k - 1), 0, src - 1)
        term = x.index_select(dim, idx) * w[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_cubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(..., INTER_CUBIC) of (N, C, H, W) float, any channel count."""
    H, W = x.shape[-2:]
    h, w = size
    if (h, w) == (H, W):
        return x.clone()
    return _cubic_pass(_cubic_pass(x.float(), -1, W, w), -2, H, h)


# ---------------------------------------------------------------------------
# gray and sharpness
# ---------------------------------------------------------------------------

def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of (..., 3) uint8 in BGR order:
    (B*3735 + G*19235 + R*9798 + 2**14) >> 15 (OpenCV's 15-bit weights)."""
    b, g, r = (bgr[..., k].to(torch.int32) for k in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).to(torch.uint8)


def png_rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.imread(png, IMREAD_GRAYSCALE) of an RGB PNG's (..., 3) uint8 pixels:
    libpng's rgb-to-gray (weights 0.299/0.587 in 15-bit fixed point,
    truncated; gray pixels pass unchanged)."""
    r, g, b = (rgb[..., k].to(torch.int32) for k in range(3))
    gray = (r * 9797 + g * 19234 + b * 3737) >> 15
    return torch.where((r == g) & (g == b), r, gray).to(torch.uint8)


def laplacian_variance(gray: torch.Tensor) -> torch.Tensor:
    """cv2.Laplacian(gray, CV_64F).var() of (..., H, W) uint8 gray images, in
    float64: the 4-neighbour Laplacian (ksize 1) over a BORDER_REFLECT_101
    border, then the population variance."""
    lead = gray.shape[:-2]
    g = gray.to(torch.float64).reshape(-1, 1, *gray.shape[-2:])
    p = F.pad(g, (1, 1, 1, 1), mode="reflect")     # reflect = BORDER_REFLECT_101
    lap = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]
           - 4.0 * p[..., 1:-1, 1:-1])
    flat = lap.reshape(lap.shape[0], -1)
    mean = flat.mean(-1, keepdim=True)
    return ((flat - mean) ** 2).mean(-1).reshape(lead)
