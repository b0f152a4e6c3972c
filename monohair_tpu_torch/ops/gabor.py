"""Gabor-bank orientation and confidence maps (port of monohair_tpu/ops/gabor.py).

The reference (preprocess_capture_data/GaborFilter.py) convolves the
difference-of-gaussians image with 180 oriented 17x17 Gabor filters, keeps the
orientation of the strongest response per pixel and a confidence from the
circular spread of the responses around it. As in the JAX package, the bank is
one (289, 180) matrix and each band of rows is an im2col product of its
(band * W, 289) taps with it; the argmax and variance statistics are per
pixel, so bands are independent, and the normalisation at the end is global.
The product is plain f32 (TF32 off, ``ops.exact_f32``): near-tied
orientations flip the argmax when the summation order changes, and TF32 would
flip far more of them.

Semantics (GaborFilter.py:29-113):
- preprocess: difference-of-gaussians (sigma 0.4, 10) of the gray image in [0, 1]
- response(o) = |conv(image, gabor(theta_o))|, theta_o = pi*o/180, zero padding
- best orientation = argmax_o response (the first of equal maxima)
- orient_diff(o) = circular distance(best, theta_o) on [0, pi)
- variance = sqrt( sum_o orient_diff(o) * (response(o) - max_response)^2 )
- confidence = clamp(variance / max(variance) / 0.2, 0, 1)

Kernel geometry: the gabor x axis runs along image *rows*, y along *columns*
(GaborFilter.py:127-133), grid offsets are (i - k//2 - 0.5).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import GABOR_NUM_ORIENTATIONS
from . import exact_f32

CLAMP_CONF_LOW = 0.0    # GaborFilter.py:24
CLAMP_CONF_HIGH = 0.2   # GaborFilter.py:25


def gabor_bank(kernel_size: int = 17, num_orientations: int = GABOR_NUM_ORIENTATIONS,
               sigma_x: float = 1.8, sigma_y: float = 2.4, lam: float = 4.0,
               phase: float = 0.0) -> np.ndarray:
    """Build the (O, 1, k, k) oriented Gabor filter bank (GaborFilter.py:115-145)."""
    half = kernel_size // 2
    coords = np.arange(-half, half + 1, dtype=np.float64) - 0.5
    x = coords[:, None]  # rows
    y = coords[None, :]  # cols
    thetas = math.pi * np.arange(num_orientations, dtype=np.float64) / num_orientations
    ct, st = np.cos(thetas)[:, None, None], np.sin(thetas)[:, None, None]
    x_t = x[None] * ct + y[None] * st
    y_t = -x[None] * st + y[None] * ct
    gb = (np.exp(-0.5 * (x_t ** 2 / sigma_x ** 2 + y_t ** 2 / sigma_y ** 2))
          * np.cos(2.0 * math.pi * x_t / lam + phase))
    return gb[:, None].astype(np.float32)


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of (H, W) with edge ('nearest') padding, rows
    first, as the JAX package's DoG blurs."""
    k = torch.as_tensor(gaussian_kernel1d(sigma), device=image.device).to(image.dtype)
    r = (k.shape[0] - 1) // 2
    x = image[None, None]
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), k.reshape(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), k.reshape(1, 1, 1, -1))
    return x[0, 0]


def difference_of_gaussians(image: torch.Tensor, low_sigma: float = 0.4,
                            high_sigma: float = 10.0) -> torch.Tensor:
    """DoG band-pass of a (H, W) image in [0, 1] (GaborFilter.py:192)."""
    return gaussian_blur(image, low_sigma) - gaussian_blur(image, high_sigma)


def gabor_orientation(image: torch.Tensor, num_orientations: int = GABOR_NUM_ORIENTATIONS,
                      kernel_size: int = 17, band: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel dominant orientation and confidence of a DoG-filtered (H, W)
    f32 image: (orientation in radians [0, pi), confidence in [0, 1]).

    Bands of `band` rows go through unfold (the (band * W, k * k) taps) times
    the (k * k, O) bank, so peak memory is ~band * W * (k * k + O) floats.
    """
    exact_f32()
    dev = image.device
    mat = torch.as_tensor(gabor_bank(kernel_size, num_orientations)[:, 0], device=dev)
    mat = mat.reshape(num_orientations, -1).T.contiguous()   # (k*k, O) row-major taps
    H, W = image.shape
    half = kernel_size // 2
    padded = F.pad(image.float(), (half, half, half, half))   # zeros
    orients = torch.arange(num_orientations, dtype=torch.float32,
                           device=dev) * (math.pi / num_orientations)
    best = torch.empty((H, W), dtype=torch.float32, device=dev)
    var = torch.empty((H, W), dtype=torch.float32, device=dev)
    for r0 in range(0, H, band):
        rows = min(band, H - r0)
        sl = padded[r0:r0 + rows + 2 * half][None, None]
        taps = F.unfold(sl, kernel_size)[0].T                 # (rows * W, k*k)
        r = torch.abs(taps @ mat)                              # (rows * W, O)
        max_resp = r.amax(-1)
        b = torch.argmax(r, -1).float() * (math.pi / num_orientations)
        diff = torch.abs(b[:, None] - orients[None, :])
        diff = torch.minimum(diff, math.pi - diff)
        rd = r - max_resp[:, None]
        best[r0:r0 + rows] = b.reshape(rows, W)
        var[r0:r0 + rows] = torch.sum(diff * rd * rd, -1).reshape(rows, W)
    variance = torch.sqrt(var)
    variance = variance / torch.clamp_min(variance.max(), 1e-12)
    confidence = torch.clamp((variance - CLAMP_CONF_LOW) / (CLAMP_CONF_HIGH - CLAMP_CONF_LOW),
                             0.0, 1.0)
    return best, confidence


def orientation_maps(gray01: torch.Tensor, threshold: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full per-frame path: DoG -> gabor -> (two-channel ori, angle, confidence).

    gray01: (H, W) grayscale in [0, 1]. Mirror of calOrientationGabor.forward
    (GaborFilter.py:98-113). Returns ((H, W, 2) [sin, cos], angle radians, conf).
    """
    dog = difference_of_gaussians(gray01)
    angle, conf = gabor_orientation(dog)
    conf = torch.where(conf < threshold, 0.0, conf)
    two = torch.stack([torch.sin(angle), torch.cos(angle)], -1)
    return two, angle, conf
