"""Strand resampling utilities (a copy of monohair_tpu/strands/resample.py:
numpy and scipy only).

`resample_strand` mirrors B_spline_interpolate/interpolation
(PMVO_utils.py:116-157): cubic-spline re-parameterization of each strand to a
fixed point count (scipy splprep like the reference; strands with <6 points are
dropped there and here).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.interpolate import splev, splprep


def resample_strand(strand: np.ndarray, num: int = 100) -> np.ndarray:
    """Cubic B-spline fit + uniform re-sampling to `num` points."""
    # splprep rejects duplicate consecutive points; nudge exact dupes
    d = np.linalg.norm(np.diff(strand, axis=0), axis=-1)
    if (d < 1e-12).any():
        strand = strand + np.random.default_rng(0).normal(
            size=strand.shape) * 1e-9
    k = min(3, strand.shape[0] - 1)
    tck, _ = splprep([strand[:, 0], strand[:, 1], strand[:, 2]], s=0.0, k=k)
    u = np.linspace(0.0, 1.0, num)
    x, y, z = splev(u, tck)
    return np.stack([x, y, z], -1)


def resample_strands(strands: Sequence[np.ndarray], num: int = 100,
                     min_points: int = 6) -> List[np.ndarray]:
    """Uniform-length strand set (Interpolatehair, PMVO_utils.py:148-157)."""
    return [resample_strand(s, num) for s in strands if s.shape[0] >= min_points]


def pad_strands(strands: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """(S, N_max, 3) padded array + (S,) lengths for batched device ops."""
    n = max((s.shape[0] for s in strands), default=0)
    out = np.zeros((len(strands), n, 3), np.float32)
    lens = np.zeros(len(strands), np.int64)
    for i, s in enumerate(strands):
        out[i, :len(s)] = s
        lens[i] = len(s)
    return out, lens
