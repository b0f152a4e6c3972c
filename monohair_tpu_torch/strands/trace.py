"""Batched strand tracing through the (occ, ori) voxel field (port of
monohair_tpu/strands/trace.py).

The reference traces one seed at a time with Python while-loops over GPU scalar
reads (HairGrow.py:59-149 `trace`, :154-223 `traceFromScalp`). Here *all* seeds
of a chunk advance together, one batched gather into the device-resident grids
per step, with per-seed active masks. The seed-coverage `flag` (which
suppresses re-tracing voxels already covered 3+ times) is honored between
*chunks* of seeds, a round-based equivalent of the reference's sequential flag.
The chunk size and the seed order are part of the result: they decide which
flag each seed sees.

Differences from the JAX package that do not change a result:
- the forward and backward marches of trace_bidirectional run as one batch of
  2K rows with a sign per row;
- a march stops once no seed is active (checked every _EXIT_CHECK steps). A
  seed that stops never moves again, so the later steps add nothing;
- generate_segments traces only the live seeds of a chunk; the JAX package
  pads them to the chunk size to bound XLA recompiles. The noise rows drawn
  are the same.

All positions are continuous voxel coordinates; `ori` is in the voxel
direction frame (world dirs * [1,-1,-1], HairGrow.py:55-56). Grids and seeds
are torch tensors on one device; strands come back as host numpy arrays.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# how often (in steps) a march checks whether any seed is still active; each
# check is one device-to-host synchronisation
_EXIT_CHECK = 16


class TraceResult(NamedTuple):
    positions: torch.Tensor   # (K, L, 3) voxel coords, padded
    lengths: torch.Tensor     # (K,) valid point counts
    valid: torch.Tensor       # (K,) strand kept at all


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA's fused multiply-add on the
    CPU gives it: the product of two float32 values is exact in float64, and
    the float64 sum rounds to float32 again (a second rounding that can differ
    from a single one only on a tie at float32 precision)."""
    return (a.double() * b.double() + c.double()).float()


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, 3) x (K, 3) -> (K,) dot products in the order XLA computes
    jnp.sum(a * b, -1) on the CPU: fma(a2, b2, fma(a1, b1, a0 * b0)). The
    threshold tests of the march decide on these values, so the order is
    kept on every device."""
    return _fma(a[:, 2], b[:, 2], _fma(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))


def norm3(a: torch.Tensor) -> torch.Tensor:
    """(K, 3) -> (K,) |a| as jnp.linalg.norm: sqrt of dot3(a, a), taken in
    float64 and rounded once (correctly rounded on every device)."""
    return torch.sqrt(dot3(a, a).double()).float()


class VoxelField:
    """Nearest lookups into (X, Y, Z[, C]) grids on one device.

    Lookup is truncation toward zero, then a clamp to the grid, as
    `seedPos.type(torch.long)` + clamp (HairGrow.py:66-69) and the JAX
    package's `pos.astype(int32)`: floor would differ below zero."""

    def __init__(self, occ: torch.Tensor, ori: Optional[torch.Tensor] = None):
        self.shape = tuple(int(r) for r in occ.shape[:3])
        self.occ = occ.reshape(-1)
        self.ori = None if ori is None else ori.reshape(-1, 3)
        self.device = occ.device
        self._hi = torch.tensor([r - 1 for r in self.shape], device=self.device)
        _, ry, rz = self.shape
        self._strides = torch.tensor([ry * rz, rz, 1], device=self.device)

    def index(self, pos: torch.Tensor) -> torch.Tensor:
        """(K, 3) voxel coords -> (K,) flat voxel ids."""
        idx = torch.minimum(torch.clamp_min(pos.long(), 0), self._hi)
        return (idx * self._strides).sum(-1)

    def lookup_occ(self, pos: torch.Tensor) -> torch.Tensor:
        return self.occ[self.index(pos)]

    def lookup_ori(self, pos: torch.Tensor) -> torch.Tensor:
        return self.ori[self.index(pos)]


def _where(take: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(take[:, None], a, b)


def _march(field: VoxelField, pos: torch.Tensor, tan: torch.Tensor,
           sign: torch.Tensor, thr_dot: float, max_steps: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The marches of the bidirectional trace (HairGrow.py:77-143), one row
    per (seed, direction); `sign` is (R, 1) of +1 or -1.

    Returns (points (T, R, 3), taken (T, R) bool), T <= max_steps: point s is
    appended iff taken[s]. Marching stops per row when the current voxel is
    empty or the field turns more than thr_dot; a stopped row stays stopped.
    """
    active = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    pts, taken = [], []
    for s in range(max_steps):
        active = active & (field.lookup_occ(pos) > 0)
        nxt = pos + sign * tan
        ntan = field.lookup_ori(nxt)
        take = active & (dot3(ntan, tan) >= thr_dot)
        pos = _where(take, nxt, pos)
        tan = _where(take, ntan, tan)
        active = take
        pts.append(pos)
        taken.append(take)
        if (s + 1) % _EXIT_CHECK == 0 and not bool(take.any()):
            break
    return torch.stack(pts), torch.stack(taken)


@torch.no_grad()
def trace_bidirectional(occ: torch.Tensor, ori: torch.Tensor, seeds: torch.Tensor,
                        noise: torch.Tensor, thr_dot: float, max_steps: int = 256,
                        min_points: int = 5) -> TraceResult:
    """Trace every seed voxel forward and backward along the field.

    seeds: (K, 3) integer voxel indices; noise: (K, 3) uniform [0,1) used to
    jitter the start inside the voxel (seed + 0.5 + 0.5*noise, HairGrow.py:62-63).
    Output positions are ordered root-to-tip: backward points reversed, then the
    seed, then forward points (HairGrow.py:75-149).
    """
    field = VoxelField(occ, ori)
    dev = field.device
    K = seeds.shape[0]
    pos0 = seeds.to(dev, torch.float32) + 0.5 + 0.5 * noise.to(dev, torch.float32)
    tan0 = field.lookup_ori(pos0)
    sign = torch.cat([torch.ones(K, 1, device=dev), -torch.ones(K, 1, device=dev)])
    pts, taken = _march(field, pos0.repeat(2, 1), tan0.repeat(2, 1), sign, thr_dot,
                        max_steps)
    T = pts.shape[0]
    n = taken.sum(0)                       # consecutive takes from step 0
    n_fwd, n_bwd = n[:K], n[K:]
    total = n_bwd + 1 + n_fwd
    L = 2 * T + 1

    # index i in [0, L): backward point (n_bwd - 1 - i) for i < n_bwd, the seed
    # at i = n_bwd, forward point (i - n_bwd - 1) after it
    axis = torch.arange(L, device=dev)[:, None]
    bwd_idx = torch.clamp(n_bwd[None] - 1 - axis, 0, T - 1)
    fwd_idx = torch.clamp(axis - n_bwd[None] - 1, 0, T - 1)

    def gather(part, idx):
        return torch.gather(part, 0, idx[..., None].expand(-1, -1, 3))

    b_part = gather(pts[:, K:], bwd_idx)
    f_part = gather(pts[:, :K], fwd_idx)
    out = torch.where((axis < n_bwd[None])[..., None], b_part,
                      torch.where((axis == n_bwd[None])[..., None], pos0[None],
                                  torch.where(((axis > n_bwd[None]) & (axis < total[None]))
                                              [..., None], f_part, 0.0)))
    return TraceResult(out.transpose(0, 1), total, total >= min_points)


@torch.no_grad()
def trace_from_scalp(occ: torch.Tensor, ori: torch.Tensor, seeds: torch.Tensor,
                     normals: torch.Tensor, thr_dot: float, max_steps: int = 256,
                     inner_steps: int = 25) -> TraceResult:
    """Grow guide strands from scalp seeds (HairGrow.py:154-223).

    seeds: (K, 3) continuous voxel coords on the scalp; normals: (K, 3) voxel-
    frame scalp normals. Phase 1 ("Grow_Inner") pushes through the empty shell
    along a gravity-blended normal for up to `inner_steps`; once the field is
    reached the trace follows it with sign-flip tolerance. Seeds that never
    reach the field are invalid.
    """
    field = VoxelField(occ, ori)
    dev = field.device
    seeds = seeds.to(dev, torch.float32)
    normals = normals.to(dev, torch.float32)
    K = seeds.shape[0]
    d = torch.tensor([0.0, 1.0, 0.0], device=dev)    # voxel-frame "down" (world -y)
    blend = torch.clamp_max(dot3(normals, d.expand(K, 3)) + 1.0, 1.0)[:, None]
    n0 = normals + d * blend
    n0 = n0 / torch.clamp_min(norm3(n0), 1e-8)[:, None]

    pos, tan = seeds, n0
    inner = torch.ones(K, dtype=torch.bool, device=dev)
    active = torch.ones(K, dtype=torch.bool, device=dev)
    pts, taken, inner_hist = [], [], []
    for i in range(max_steps):
        active = active & ((field.lookup_occ(pos) > 0) | inner)
        nxt = pos + tan
        ntan = field.lookup_ori(nxt)
        empty_next = norm3(ntan) < 0.1

        # empty & still inner: keep pushing along the blended normal
        keep_dir = dot3(tan, n0) < 0.85
        blended = tan + d * blend
        blended = blended / torch.clamp_min(norm3(blended), 1e-8)[:, None]
        inner_tan = _where(keep_dir, tan, blended)

        dot = dot3(ntan, tan)
        flip_ok = -dot >= thr_dot
        field_tan = _where((dot < thr_dot) & flip_ok, -ntan, ntan)
        stop_field = (dot < thr_dot) & ~flip_ok & ~inner
        field_tan = _where(inner & (dot < 0), -field_tan, field_tan)

        use_inner = empty_next & inner
        new_tan = _where(use_inner, inner_tan, field_tan)
        new_inner = inner & use_inner
        take = active & ~stop_field
        if i + 1 >= inner_steps:
            take = take & ~new_inner
        pos = _where(take, nxt, pos)
        tan = _where(take, new_tan, tan)
        inner = torch.where(take, new_inner, inner)
        active = take
        pts.append(pos)
        taken.append(take)
        inner_hist.append(inner)
        if (i + 1) % _EXIT_CHECK == 0 and not bool(take.any()):
            break
    pts, taken, inner_hist = torch.stack(pts), torch.stack(taken), torch.stack(inner_hist)
    T = pts.shape[0]
    n_steps = taken.sum(0)
    # valid strands escaped the inner phase (HairGrow.py:219-223)
    last = torch.clamp(n_steps - 1, 0, T - 1)
    still_inner = torch.gather(inner_hist, 0, last[None])[0] | (n_steps == 0)

    L = T + 1
    pts_full = torch.cat([seeds[None], pts], 0)
    keep = (torch.arange(L, device=dev)[:, None] <= n_steps[None])[..., None]
    pts_full = torch.where(keep, pts_full, 0.0)
    return TraceResult(pts_full.transpose(0, 1), n_steps + 1, ~still_inner)


def strands_to_list(result: TraceResult, min_points: int = 2) -> List[np.ndarray]:
    """Kept strands' valid points as a host list of (Ni, 3) float32 arrays.

    Compacts on the device (a strand's points are a prefix of its row, so a
    row-major mask keeps them in order) and downloads only those rows."""
    keep = result.valid & (result.lengths >= min_points)
    L = result.positions.shape[1]
    mask = keep[:, None] & (torch.arange(L, device=keep.device)[None]
                            < result.lengths[:, None])
    pts = result.positions[mask].cpu().numpy()
    lens = result.lengths[keep].cpu().numpy()
    if lens.size == 0:
        return []
    return np.split(pts, np.cumsum(lens)[:-1])


def update_flag(flag: torch.Tensor, result: TraceResult) -> torch.Tensor:
    """Scatter-add coverage of traced strands into the seed-suppression flag
    (HairGrow.py:288-293), in place; returns `flag`. Each valid point adds 1.0,
    so the counts are exact in any order."""
    L = result.positions.shape[1]
    in_range = ((torch.arange(L, device=flag.device)[None] < result.lengths[:, None])
                & result.valid[:, None])
    flat = VoxelField(flag).index(result.positions[in_range])
    flag.view(-1).index_put_((flat,), torch.ones_like(flat, dtype=flag.dtype),
                             accumulate=True)
    return flag


def generate_segments(occ: torch.Tensor, ori_voxel: torch.Tensor, thr_dot: float,
                      sweeps: int = 3, chunk: int = 16384, flag_cap: int = 3,
                      seed: int = 0, max_steps: int = 256,
                      flag_init: Optional[torch.Tensor] = None) -> List[np.ndarray]:
    """Trace strands from every occupied voxel, `sweeps` times over the grid,
    suppressing seeds whose voxel is already covered >= flag_cap times.

    Round-based equivalent of randomlyGenerateSegments (HairGrow.py:269-299):
    within a chunk all seeds see the same flag snapshot; the flag updates
    between chunks. Each traced chunk draws rng.random((chunk, 3)) for its
    noise, whatever its number of live seeds, as the JAX package does.
    """
    flag = torch.zeros_like(occ) if flag_init is None else flag_init.clone()
    seeds_all = torch.nonzero(occ > 0)          # C order, as np.argwhere
    rng = np.random.default_rng(seed)
    strands: List[np.ndarray] = []
    for _ in range(sweeps):
        for beg in range(0, len(seeds_all), chunk):
            sub = seeds_all[beg:beg + chunk]
            sub = sub[flag[sub[:, 0], sub[:, 1], sub[:, 2]] < flag_cap]
            if len(sub) == 0:
                continue
            noise = rng.random((chunk, 3)).astype(np.float32)[:len(sub)]
            res = trace_bidirectional(occ, ori_voxel, sub, torch.from_numpy(noise),
                                      thr_dot, max_steps)
            update_flag(flag, res)
            strands.extend(strands_to_list(res, min_points=5))
    return strands


def generate_guide_and_segments(occ: torch.Tensor, ori_voxel: torch.Tensor,
                                scalp_points_voxel: np.ndarray,
                                scalp_normals_voxel: np.ndarray, thr_dot: float,
                                chunk: int = 16384, seed: int = 0
                                ) -> Tuple[List[np.ndarray], int]:
    """GenerateGuideStrandFromScalp (HairGrow.py:226-265): scalp-rooted guide
    strands first, then two sweeps of free segments over voxels not yet covered.
    Returns (strands, num_root): the first num_root strands are scalp-rooted.
    Runs on the device of `occ`.
    """
    guides: List[np.ndarray] = []
    flag = torch.zeros_like(occ)
    for beg in range(0, len(scalp_points_voxel), chunk):
        sp = torch.as_tensor(scalp_points_voxel[beg:beg + chunk], dtype=torch.float32)
        sn = torch.as_tensor(scalp_normals_voxel[beg:beg + chunk], dtype=torch.float32)
        res = trace_from_scalp(occ, ori_voxel, sp, sn, thr_dot)
        update_flag(flag, res)
        guides.extend(strands_to_list(res, min_points=2))
    num_root = len(guides)
    flag = torch.clamp_max(flag, 1.0)   # guides mark coverage once (HairGrow.py:246)
    segs = generate_segments(occ, ori_voxel, thr_dot, sweeps=2, chunk=chunk,
                             seed=seed, flag_init=flag)
    return guides + segs, num_root
