"""The coarse NeRF's shared renderer, the hash-grid field and the occupancy
grid (port of monohair_tpu/nerf/ngp.py).

Coordinates: a field lives in the NGP unit cube; NeRF world points map in
through p * 0.33 + 0.5 (``nerf_to_unit``). A field is an ``nn.Module`` with
``density(points01) -> (sigma (N,), geo_feat (N, G))`` and
``forward(points01, dirs) -> (sigma (N,), rgb (N, 3))``; the renderer takes
any of the three (``NGPField`` here, ``fourier.FourierField``,
``dense_grid.DenseGridField``).

Random draws are arguments: a function that draws in the JAX package (the
stratified offsets of a ray, the jitter of an occupancy update) takes its
uniform [0, 1) draws as a tensor (the training loop draws them from a
``torch.Generator`` on the device). Parameters start as flax initialises
them (``flax_dense``, ``flax_uniform_``): the learning rates and step budgets
of the JAX package were tuned with that start.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

NGP_SCALE = 0.33
NGP_OFFSET = 0.5

_PRIMES = (1, 2654435761, 805459861)
# flax's lecun_normal: a normal truncated at 2 sigma, rescaled so that its
# standard deviation is sqrt(1 / fan_in) (the truncated unit normal's is this)
_TRUNC_STD = 0.87962566103423978


def flax_dense(fan_in: int, fan_out: int, bias: bool = True,
               generator: Optional[torch.Generator] = None, device=None) -> nn.Linear:
    """An nn.Linear initialised as flax's nn.Dense: kernel lecun_normal (a
    normal truncated at +-2 sigma, sigma = sqrt(1 / fan_in) / 0.8796), bias 0."""
    layer = nn.Linear(fan_in, fan_out, bias=bias, device=device)
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        layer.weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        if bias:
            layer.bias.zero_()
    return layer


def flax_uniform_(t: torch.Tensor, scale: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's initializers.uniform(scale): U[0, scale), not a symmetric range."""
    with torch.no_grad():
        return t.uniform_(0.0, scale, generator=generator)


def checked_draws(draws: torch.Tensor, shape, device) -> torch.Tensor:
    """U[0, 1) draws of the given shape, as f32 on `device`."""
    if tuple(draws.shape) != tuple(shape):
        raise ValueError(f"draws of shape {tuple(draws.shape)}, expected {tuple(shape)}")
    return draws.to(device=device, dtype=torch.float32)


class HashGridConfig(NamedTuple):
    num_levels: int = 14
    features_per_level: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 1024


def level_resolutions(cfg: HashGridConfig) -> np.ndarray:
    b = math.exp(math.log(cfg.finest_resolution / cfg.base_resolution)
                 / max(cfg.num_levels - 1, 1))
    return np.floor(cfg.base_resolution * b ** np.arange(cfg.num_levels)).astype(np.int32)


def hash_corners(points01: torch.Tensor, resolution: float, log2_table_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's 8 trilinear corners of (N, 3) points in [0, 1]: table
    indices (8, N) int64 and weights (8, N), corners in (cx, cy, cz) order
    with z fastest.

    The spatial hash xors (i + c) * prime over the three axes and keeps the
    low log2_table_size bits. The JAX package wraps in uint32; here the
    products stay below 2**43 in int64, whose low bits are the same."""
    mask = (1 << log2_table_size) - 1
    r = float(np.float32(resolution))
    i = torch.floor(points01.float() * r)
    # the fraction x * r - floor(x * r) rounded once, as XLA's CPU code fuses
    # it into a multiply-add (the f32 product is exact in float64)
    w = (points01.double() * r - i.double()).float()
    i = i.to(torch.int64)
    idx, wts = [], []
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                h = (((i[:, 0] + cx) * _PRIMES[0]) ^ ((i[:, 1] + cy) * _PRIMES[1])
                     ^ ((i[:, 2] + cz) * _PRIMES[2]))
                idx.append(h & mask)
                wts.append((w[:, 0] if cx else 1.0 - w[:, 0])
                           * (w[:, 1] if cy else 1.0 - w[:, 1])
                           * (w[:, 2] if cz else 1.0 - w[:, 2]))
    return torch.stack(idx), torch.stack(wts)


def hash_encode(table: torch.Tensor, points01: torch.Tensor, cfg: HashGridConfig
                ) -> torch.Tensor:
    """(L, F, T) feature-major table (the JAX package's layout, so its
    weights load unchanged), (N, 3) points in [0, 1] -> (N, L*F): per level
    the trilinear blend of the 8 hashed corners, summed in corner order."""
    out = []
    for level, r in enumerate(level_resolutions(cfg)):
        idx, w = hash_corners(points01, r, cfg.log2_table_size)
        acc = torch.zeros((cfg.features_per_level, points01.shape[0]),
                          dtype=table.dtype, device=table.device)
        for k in range(8):
            acc = acc + table[level][:, idx[k]] * w[k][None]
        out.append(acc)
    return torch.cat(out, 0).T


def sh_encoding_deg4(dirs: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 3 (16 coefficients) of unit
    (N, 3) directions: instant-ngp's default direction encoding."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    return torch.stack([
        0.28209479177387814 * one,
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], -1)


def density_from_head(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A sigma head's (N, 1 + G) output -> (exp(clip(h0, -15, 12)), h[:, 1:])."""
    return torch.exp(torch.clamp(h[:, 0], -15.0, 12.0)), h[:, 1:]


class NGPField(nn.Module):
    """Hash table + density/colour MLPs (instant-ngp's layout)."""

    def __init__(self, cfg: HashGridConfig = HashGridConfig(), hidden: int = 64,
                 geo_feat: int = 15, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        L, F = cfg.num_levels, cfg.features_per_level
        self.hash_table = nn.Parameter(flax_uniform_(
            torch.empty((L, F, 2 ** cfg.log2_table_size), device=device), 2e-4, generator))
        kw = dict(generator=generator, device=device)
        self.sigma1 = flax_dense(L * F, hidden, **kw)
        self.sigma2 = flax_dense(hidden, 1 + geo_feat, **kw)
        self.rgb1 = flax_dense(16 + geo_feat, hidden, **kw)
        self.rgb2 = flax_dense(hidden, hidden, **kw)
        self.rgb3 = flax_dense(hidden, 3, **kw)

    def density(self, points01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = hash_encode(self.hash_table, points01, self.cfg)
        return density_from_head(self.sigma2(torch.relu(self.sigma1(enc))))

    def forward(self, points01: torch.Tensor, dirs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma, feat = self.density(points01)
        h = torch.cat([sh_encoding_deg4(dirs), feat], -1)
        h = torch.relu(self.rgb1(h))
        h = torch.relu(self.rgb2(h))
        return sigma, torch.sigmoid(self.rgb3(h))


def nerf_to_unit(p: torch.Tensor) -> torch.Tensor:
    return p * NGP_SCALE + NGP_OFFSET


def camera_rays(c2w: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
                pix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NeRF-convention rays through (N, 2) pixel (row, col) centres:
    dirs_cam = [(col + 0.5 - cx) / fx, -(row + 0.5 - cy) / fy, -1] (OpenGL:
    +y up, -z forward), rotated by c2w and normalised; origins c2w[:3, 3]."""
    x = (pix[:, 1] + 0.5 - cx) / fx
    y = -(pix[:, 0] + 0.5 - cy) / fy
    d = torch.stack([x, y, -torch.ones_like(x)], -1)
    d = d @ c2w[:3, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand(d.shape), d


def ray_aabb(o: torch.Tensor, d: torch.Tensor, lo: float = -1.5, hi: float = 1.5
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry and exit t of rays against the NeRF-world box. Rays that miss
    it get the degenerate segment [tmin, tmin + 0.01]: a negative delta would
    flip the absorption's sign and overflow exp when most rays miss."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), -1)
    tmax = torch.amin(torch.maximum(t0, t1), -1)
    tmin = torch.clamp_min(tmin, 0.05)
    return tmin, torch.maximum(tmax, tmin + 0.01)


def composite(sigma: torch.Tensor, rgb: torch.Tensor, t: torch.Tensor,
              delta: torch.Tensor, background: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Emission-absorption: alpha = 1 - exp(-sigma delta), transmittance the
    exclusive cumprod of (1 - alpha + 1e-10), then rgb, depth and opacity,
    with the background behind the volume."""
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    w = alpha * trans
    rgb_out = torch.sum(w[..., None] * rgb, 1)
    depth = torch.sum(w * t, 1)
    opacity = torch.sum(w, 1)
    if background is not None:
        rgb_out = rgb_out + (1.0 - opacity)[:, None] * background
    return rgb_out, depth, opacity


def as_background(background, device) -> Optional[torch.Tensor]:
    """A config's background colour (None, a scalar or 3 values) -> (3,) f32."""
    if background is None:
        return None
    return torch.as_tensor(background, dtype=torch.float32, device=device).expand(3)


def render_rays(field: nn.Module, o: torch.Tensor, d: torch.Tensor,
                num_samples: int = 192, u: Optional[torch.Tensor] = None,
                bound: float = 1.5, background: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stratified uniform samples between the box's entry and exit, through
    the field, composited. `u` (N, num_samples) are the stratified offsets'
    U[0, 1) draws; without them each sample sits at its bin's midpoint.
    `background` (3,) is composited behind the volume: without it, a bright
    backdrop with no geometry inside the bound can only be explained by fog.

    Returns (rgb (N, 3), depth (N,), opacity (N,)); depth is the expected
    distance along the unit ray direction."""
    N = o.shape[0]
    tmin, tmax = ray_aabb(o, d, -bound, bound)
    base = torch.arange(num_samples, dtype=torch.float32, device=o.device) / num_samples
    if u is not None:
        u = base[None] + checked_draws(u, (N, num_samples), o.device) / num_samples
    else:
        u = (base[None] + 0.5 / num_samples).expand(N, num_samples)
    t = tmin[:, None] + (tmax - tmin)[:, None] * u
    pts = o[:, None] + d[:, None] * t[..., None]
    dirs = d[:, None].expand(pts.shape)
    sigma, rgb = field(nerf_to_unit(pts.reshape(-1, 3)), dirs.reshape(-1, 3))
    delta = (tmax - tmin)[:, None] / num_samples * NGP_SCALE   # unit-cube scale
    return composite(sigma.reshape(N, num_samples), rgb.reshape(N, num_samples, 3), t,
                     delta, background)


# -----------------------------------------------------------------------------
# Occupancy-grid sampling (instant-ngp's density bitfield, in static shapes):
# an EMA density grid updated from jittered cell-centre queries; at render
# time cheap grid lookups along each ray build a piecewise-constant PDF, and
# the MLP samples are placed by its inverse CDF.
# -----------------------------------------------------------------------------


def init_occupancy_grid(resolution: int = 128, device=None) -> torch.Tensor:
    """EMA density grid over the NeRF-world cube [-bound, bound]^3."""
    return torch.zeros((resolution,) * 3, dtype=torch.float32, device=device)


def update_occupancy_grid(field: nn.Module, values: torch.Tensor, jitter: torch.Tensor,
                          bound: float = 1.5, decay: float = 0.95) -> torch.Tensor:
    """One EMA update: sigma at a jittered point in every cell (`jitter`
    (R^3, 3) U[0, 1) draws), then new = max(decay * old, sigma)."""
    R = values.shape[0]
    cell = 2.0 * bound / R
    ax = torch.arange(R, dtype=torch.float32, device=values.device)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pts = -bound + (grid + checked_draws(jitter, grid.shape, values.device)) * cell
    sigma, _ = field.density(nerf_to_unit(pts))
    return torch.maximum(decay * values, sigma.reshape(values.shape))


def occupancy_threshold(values: torch.Tensor) -> torch.Tensor:
    """min(mean, 2.0): early in training every cell stays occupied, so the
    sampling degrades to uniform; once the field sharpens, surfaces remain."""
    return torch.clamp_max(torch.mean(values), 2.0)


def _grid_lookup(values: torch.Tensor, pts: torch.Tensor, bound: float) -> torch.Tensor:
    R = values.shape[0]
    idx = torch.clamp(((pts + bound) / (2 * bound) * R).to(torch.int32), 0, R - 1).long()
    return values[idx[..., 0], idx[..., 1], idx[..., 2]]


def occupancy_sample_ts(values: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                        num_coarse: int, num_fine: int, bound: float,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, num_fine) sorted sample distances, concentrated in occupied cells.

    Coarse midpoints probe the grid; occupied bins weigh 1.02, empty ones
    0.02 (so training can still carve mistakes away); the fine samples sit at
    the inverse CDF of stratified u (`u` (N, num_fine) draws; midpoints
    without them), bins found on the left side."""
    N = o.shape[0]
    tmin, tmax = ray_aabb(o, d, -bound, bound)
    dt = (tmax - tmin) / num_coarse
    k = torch.arange(num_coarse, device=o.device)
    mid = tmin[:, None] + (k + 0.5) * dt[:, None]
    pts = o[:, None] + d[:, None] * mid[..., None]
    occ = _grid_lookup(values, pts, bound) > occupancy_threshold(values)
    w = occ.float() + 0.02
    cdf = torch.cumsum(w, -1)
    cdf = cdf / cdf[:, -1:]
    j = torch.arange(num_fine, device=o.device)
    if u is not None:
        uu = j / num_fine + checked_draws(u, (N, num_fine), o.device) / num_fine
    else:
        uu = ((j + 0.5) / num_fine).expand(N, num_fine)
    uu = uu.contiguous()
    bins = torch.clamp(torch.searchsorted(cdf, uu), 0, num_coarse - 1)
    cdf_lo = torch.where(bins > 0, torch.gather(cdf, 1, torch.clamp_min(bins - 1, 0)),
                         torch.zeros_like(uu))
    cdf_hi = torch.gather(cdf, 1, bins)
    frac = (uu - cdf_lo) / torch.clamp_min(cdf_hi - cdf_lo, 1e-9)
    t = tmin[:, None] + (bins + frac) * dt[:, None]
    return torch.sort(t, -1).values


def render_rays_occ(field: nn.Module, values: torch.Tensor, o: torch.Tensor,
                    d: torch.Tensor, num_coarse: int = 128, num_fine: int = 64,
                    u: Optional[torch.Tensor] = None, bound: float = 1.5,
                    background: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """render_rays' compositing over num_fine samples placed by the grid
    (occupancy_sample_ts) instead of num_samples uniform ones."""
    N = o.shape[0]
    t = occupancy_sample_ts(values, o, d, num_coarse, num_fine, bound, u)
    pts = o[:, None] + d[:, None] * t[..., None]
    dirs = d[:, None].expand(pts.shape)
    sigma, rgb = field(nerf_to_unit(pts.reshape(-1, 3)), dirs.reshape(-1, 3))
    delta = torch.diff(t, dim=-1, append=t[:, -1:] + 1e-3) * NGP_SCALE
    return composite(sigma.reshape(N, num_fine), rgb.reshape(N, num_fine, 3), t, delta,
                     background)


def grid_points(resolution: int, bound: float) -> np.ndarray:
    """(resolution^3, 3) float32 points of np.linspace(-bound, bound) axes,
    x slowest."""
    axes = np.linspace(-bound, bound, resolution)
    return np.stack(np.meshgrid(axes, axes, axes, indexing="ij"), -1
                    ).reshape(-1, 3).astype(np.float32)


@torch.no_grad()
def density_grid(field: nn.Module, resolution: int = 256, chunk: int = 262144,
                 bound: float = 1.5) -> np.ndarray:
    """Sigma over the NeRF-world grid for the mesh export, in chunks of
    `chunk` points on the field's device: (R, R, R) float32 on the host."""
    device = next(field.parameters()).device
    pts = torch.as_tensor(grid_points(resolution, bound), device=device)
    out = torch.empty(len(pts), dtype=torch.float32, device=device)
    for beg in range(0, len(pts), chunk):
        out[beg:beg + chunk] = field.density(nerf_to_unit(pts[beg:beg + chunk]))[0]
    return out.reshape((resolution,) * 3).cpu().numpy()
