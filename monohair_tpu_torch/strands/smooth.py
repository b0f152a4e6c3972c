"""Batched strand Laplacian smoothing (port of monohair_tpu/strands/smooth.py).

The reference smooths one strand at a time with a sparse scipy solve per axis
(Utils/Utils.py:1148-1198 `smnooth_strand`). The normal equations are
(lam^2 * L^T L + pos^2 * I) x = pos^2 * x0 with L the path-graph Laplacian, an
SPD pentadiagonal system with condition <= 1 + 16*lam^2/pos^2, so a
fixed-iteration conjugate gradient converges to machine precision in a few
dozen iterations. Here all strands of a length bucket solve at once as
(S, N, 3) padded tensors with per-strand length masks, on any device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _neighbours(mask: torch.Tensor):
    """(has_left, has_right, degree), each (S, N, 1), of the path graph
    restricted to the valid points of each strand."""
    zero = torch.zeros_like(mask[:, :1])
    has_left = torch.cat([zero, mask[:, :-1]], 1)[..., None]
    has_right = torch.cat([mask[:, 1:], zero], 1)[..., None]
    return has_left, has_right, has_left + has_right


def _path_laplacian(x: torch.Tensor, m: torch.Tensor, nb) -> torch.Tensor:
    """(S, N, 3) batched L x (Utils/Utils.py:1158-1172). Row 0: x0 - x1; row
    n-1: x_{n-1} - x_{n-2}; interior: 2xi - x_{i-1} - x_{i+1}. `m` is the
    (S, N, 1) mask, `nb` what _neighbours gives for it."""
    has_left, has_right, deg = nb
    xm = x * m
    zero = torch.zeros_like(xm[:, :1])
    left = torch.cat([zero, xm[:, :-1]], 1)
    right = torch.cat([xm[:, 1:], zero], 1)
    return (deg * xm - left * has_left - right * has_right) * m


@torch.no_grad()
def smooth_strands_padded(points: torch.Tensor, lengths: torch.Tensor,
                          lap_constraint: float = 2.0, pos_constraint: float = 1.0,
                          iters: int = 48) -> torch.Tensor:
    """Smooth (S, N, 3) padded strands; entries beyond `lengths` pass through.

    Solves (lam^2 L^2 + p^2 I) x = p^2 x0 by CG (L is symmetric: L^T L = L^2)
    on the device of `points`.
    """
    N = points.shape[1]
    mask = (torch.arange(N, device=points.device)[None, :]
            < lengths.to(points.device)[:, None]).to(points.dtype)
    m = mask[..., None]
    nb = _neighbours(mask)
    lam2 = lap_constraint * lap_constraint
    p2 = pos_constraint * pos_constraint

    def A(x):
        return lam2 * _path_laplacian(_path_laplacian(x, m, nb), m, nb) + p2 * x * m

    def dot(a, c):
        return torch.sum(a * c, dim=(1, 2), keepdim=True)

    b = p2 * points * m
    x = points * m
    r = b - A(x)
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        Ap = A(p)
        alpha = rs / torch.clamp_min(dot(p, Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = dot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-20)
        p = r + beta * p
        rs = rs_new
    return torch.where(m > 0, x, points)


def smooth_strand_list(strands: List[np.ndarray], lap_constraint: float = 2.0,
                       pos_constraint: float = 1.0, fix_tips: bool = False,
                       bucket: int = 64, device="cpu") -> List[np.ndarray]:
    """Smooth a host list of variable-length strands on `device`.

    Strands are padded to length buckets (multiples of `bucket`), one solve per
    bucket, as in the JAX package. Mirror of smooth_strands
    (Utils/Utils.py:1191-1198). Returns float32 arrays.
    """
    if not strands:
        return strands
    lens = np.array([s.shape[0] for s in strands])
    out: List[np.ndarray] = [None] * len(strands)
    padded_sizes = np.maximum(((lens + bucket - 1) // bucket) * bucket, bucket)
    for size in np.unique(padded_sizes):
        idx = np.nonzero(padded_sizes == size)[0]
        lens_b = lens[idx]
        rows = np.repeat(np.arange(len(idx)), lens_b)
        cols = np.arange(rows.size) - np.repeat(np.cumsum(lens_b) - lens_b, lens_b)
        batch = np.zeros((len(idx), size, 3), np.float32)
        batch[rows, cols] = np.concatenate([strands[i] for i in idx], 0)
        sm = smooth_strands_padded(torch.from_numpy(batch).to(device),
                                   torch.from_numpy(lens_b), lap_constraint,
                                   pos_constraint).cpu().numpy()
        flat = sm[rows, cols]
        for j, s in zip(idx, np.split(flat, np.cumsum(lens_b)[:-1])):
            if fix_tips and lens[j] > 2:
                s[0] = strands[j][0]
                s[-1] = strands[j][-1]
            out[j] = s
    return out
