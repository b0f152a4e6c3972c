"""Differentiable soft mesh rasterisation for the bust fit's losses (port of
monohair_tpu/bustfit/soft_raster.py), in plain PyTorch on the cameras' device.

- Each face emits a fixed ``window`` x ``window`` block of fragments anchored
  at its screen bbox min (the anchor carries no gradient). Per fragment:
  barycentrics and a signed pixel distance to the triangle's boundary, both
  smooth in the projected vertices.
- Silhouette (SoftRas-style): per-fragment coverage D = sigmoid(dist/sigma);
  a pixel is 1 - prod(1 - D), a scatter-add of log(1 - D).
- Colour: softmax depth blending, w = D * exp((zn - m)/gamma) with zn the
  normalised inverse depth and m the pixel's max zn over valid fragments (a
  scatter-max without gradient); numerator and denominator accumulate by
  scatter-add, the background weighs exp(-m/gamma).

Three clamps keep NaN out of the backward where a forward mask cannot (a NaN
gradient is zeroed by the optimiser, so such a fault freezes the fit
silently): the barycentrics divide by a sign-safe |area| >= 1e-9, the edge
lengths take their eps inside the sqrt, and the softmax exponent is clamped at
0 (an invalid fragment's exp would overflow, and inf * 0 is NaN). torch.where
passes NaN backwards as jnp.where does, so all three stay.

Faces are (F, 3) int64, numpy or a tensor on the vertices' device (the fit
passes a tensor, so that no step copies them from the host). The scatters
add in fragment order on the CPU and in any order on the card
(atomics), so the card's sums differ from the CPU's by rounding only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..camera import Cameras, project
from ..ops.rasterize import _pixel_from_ndc


def vertex_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """Area-weighted vertex normals: a scatter-add of the face normals, the
    eps inside the sqrt (an isolated or fully degenerate vertex's norm(0)
    would give a NaN gradient)."""
    f = torch.as_tensor(faces, device=verts.device)
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)                   # area-weighted
    n = torch.zeros_like(verts)
    for k in range(3):
        n = n.index_add(0, f[:, k], fn)
    return n / torch.sqrt(torch.sum(n * n, -1, keepdim=True) + 1e-24)


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    """jnp.maximum(x, v): a tie passes half the gradient (torch.clamp passes
    all of it; the colour pass's exponent ties at its winning fragments)."""
    return torch.maximum(x, x.new_full((), v))


def _min(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.minimum(x, x.new_full((), v))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), ties included."""
    return _min(_max(x, lo), hi)


def _edge(p: torch.Tensor, q: torch.Tensor, xr: torch.Tensor, xc: torch.Tensor
          ) -> torch.Tensor:
    """Signed 2x-area of (p, q, x); > 0 when x is left of p->q. p, q (V, F, 2)
    (row, col); x's rows and cols (V, F, P) -> (V, F, P), or (V, F) for x
    (V, F)."""
    if xr.dim() == p.dim():
        return ((xc - p[..., None, 1]) * (q[..., 0] - p[..., 0])[..., None]
                - (xr - p[..., None, 0]) * (q[..., 1] - p[..., 1])[..., None])
    return (xc - p[..., 1]) * (q[..., 0] - p[..., 0]) - (xr - p[..., 0]) * (q[..., 1] - p[..., 1])


def _elen(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Edge length with the eps inside the sqrt (norm(0)'s backward is 0/0)."""
    sq = torch.sum((q - p) ** 2, -1)
    return torch.sqrt(sq + 1e-18)[..., None]


def _soft_fragments(cam: Cameras, v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                    image_size, window: int, scale: int, sigma_px: float,
                    colour: bool = False):
    """Per-face soft fragments in every view: (flat pixel ids (V, F*P) int64,
    coverage D (V, F*P), valid (V, F*P)), P = window**2; with `colour` also
    the depth (V, F*P) and the clipped, normalised barycentrics (three
    (V, F*P)), which the colour passes use and the silhouette does not. The
    arithmetic is the JAX package's, kept per barycentric component rather
    than stacked (the stacks were copies the card paid for)."""
    H, W = image_size
    Hl, Wl = max(H // scale, 1), max(W // scale, 1)
    dev = v0.device
    uvs, zs = zip(*(project(cam, v) for v in (v0, v1, v2)))
    a, b, c = (_pixel_from_ndc(u, (H, W)) / scale for u in uvs)    # (V, F, 2) each

    bb_min = torch.floor(torch.minimum(torch.minimum(a, b), c)).detach()
    ar = torch.arange(window, device=dev, dtype=torch.float32)
    # fragment k of a face sits at (k // window, k % window) from the anchor
    pr = bb_min[..., 0:1] + ar.repeat_interleave(window) + 0.5     # (V, F, P)
    pc = bb_min[..., 1:2] + ar.repeat(window) + 0.5

    w0, w1, w2 = _edge(b, c, pr, pc), _edge(c, a, pr, pc), _edge(a, b, pr, pc)
    area = _edge(b, c, a[..., 0], a[..., 1])                        # (V, F)
    sgn = torch.where(area >= 0, 1.0, -1.0)[..., None]              # either winding
    area_abs = _max(torch.abs(area), 1e-9)[..., None]

    # signed pixel distance to the triangle boundary: min over edges of the
    # edge function over the edge length (exact in edge regions)
    d = torch.minimum(torch.minimum(sgn * w0 / _elen(b, c), sgn * w1 / _elen(c, a)),
                      sgn * w2 / _elen(a, b))                       # (V, F, P), px
    D = torch.sigmoid(d * scale / sigma_px)

    front = ((zs[0] < 0) & (zs[1] < 0) & (zs[2] < 0))[..., None]   # -z > 0: in front
    degenerate = area_abs < 1e-8
    r = pr.to(torch.int64)                      # truncates toward zero, as astype
    cc = pc.to(torch.int64)
    inb = (r >= 0) & (r < Hl) & (cc >= 0) & (cc < Wl)
    valid = front & inb & ~degenerate
    flat = torch.clamp(r, 0, Hl - 1) * Wl + torch.clamp(cc, 0, Wl - 1)
    V, F, P = D.shape
    out = (flat.reshape(V, F * P), D.reshape(V, F * P), valid.reshape(V, F * P))
    if not colour:
        return out
    # barycentrics over the sign-safe area, clipped and renormalised: an
    # outside fragment takes the colour and depth of the nearest boundary
    # point instead of extrapolating (toward the camera, for the depth)
    area_safe = sgn * area_abs
    lc = [_clip(w / area_safe, 0.0, 1.0) for w in (w0, w1, w2)]
    total = _max(lc[0] + lc[1] + lc[2], 1e-9)
    lc = [x / total for x in lc]
    depth = lc[0] * (-zs[0])[..., None] + lc[1] * (-zs[1])[..., None] + lc[2] * (-zs[2])[..., None]
    return out + (depth.reshape(V, F * P), [x.reshape(V, F * P) for x in lc])


def _corners(verts: torch.Tensor, sub: torch.Tensor):
    return verts[sub[:, 0]], verts[sub[:, 1]], verts[sub[:, 2]]


def soft_silhouette_mesh(cam: Cameras, verts: torch.Tensor, faces,
                         image_size: Tuple[int, int], scale: int = 8,
                         window: int = 8, sigma_px: float = 2.0,
                         chunk: int = 8192) -> torch.Tensor:
    """(V, H/scale, W/scale) soft mesh coverage in [0, 1], differentiable
    (the reference's PyTorch3D SoftSilhouetteShader pass)."""
    H, W = image_size
    Hl, Wl = max(H // scale, 1), max(W // scale, 1)
    f = torch.as_tensor(faces, device=verts.device)
    acc = torch.zeros((cam.num_views, Hl * Wl), device=verts.device)
    for beg in range(0, len(f), chunk):
        flat, D, valid = _soft_fragments(cam, *_corners(verts, f[beg:beg + chunk]),
                                         (H, W), window, scale, sigma_px)
        contrib = torch.where(valid, torch.log1p(-_clip(D, 0.0, 1.0 - 1e-6)), 0.0)
        acc = acc.scatter_add(1, flat, contrib)
    return (1.0 - torch.exp(acc)).reshape(cam.num_views, Hl, Wl)


def soft_render_colors(cam: Cameras, verts: torch.Tensor, faces,
                       vert_colors: torch.Tensor, image_size: Tuple[int, int],
                       scale: int = 8, window: int = 8, sigma_px: float = 1.0,
                       gamma: float = 1e-2, z_range: Tuple[float, float] = (0.1, 3.0),
                       background: float = 0.0, chunk: int = 8192) -> torch.Tensor:
    """(V, H/scale, W/scale, C) softmax-depth-blended vertex-colour rendering
    (the stand-in for SRenderY's textured pass). vert_colors is (N, C) for
    every view or (V, N, C), one set a view (the fit's per-view lights): the
    arithmetic of each view is that of a call with its own (N, C)."""
    H, W = image_size
    Hl, Wl = max(H // scale, 1), max(W // scale, 1)
    V = cam.num_views
    C = vert_colors.shape[-1]
    f = torch.as_tensor(faces, device=verts.device)
    znear, zfar = z_range
    cols = vert_colors if vert_colors.dim() == 3 else vert_colors[None]

    def frag(sub):
        flat, D, valid, depth, bary = _soft_fragments(cam, *_corners(verts, sub), (H, W),
                                                      window, scale, sigma_px, colour=True)
        zn = _clip((zfar - depth) / (zfar - znear), 0.0, 1.0)
        return flat, D, bary, zn, valid

    # pass 1: per-pixel max of zn (the softmax shift; the background sits at
    # zn = 0, so an empty pixel keeps m = 0 and its background weight exp(0))
    m = torch.zeros((V, Hl * Wl), device=verts.device)
    with torch.no_grad():
        for beg in range(0, len(f), chunk):
            flat, D, _, zn, valid = frag(f[beg:beg + chunk])
            m = m.scatter_reduce(1, flat, torch.where(valid, zn, 0.0), "amax")

    # pass 2: shifted softmax accumulation
    num = torch.zeros((V, Hl * Wl, C), device=verts.device)
    den = torch.exp(-m / gamma)                       # background term (zn = 0)
    num = num + background * den[..., None]
    for beg in range(0, len(f), chunk):
        sub = f[beg:beg + chunk]
        flat, D, bary, zn, valid = frag(sub)
        c0, c1, c2 = cols[:, sub[:, 0]], cols[:, sub[:, 1]], cols[:, sub[:, 2]]  # (1|V, F, C)
        P = flat.shape[1] // len(sub)
        # the clipped barycentrics (SoftRas): fragments outside the face would
        # otherwise extrapolate colours arbitrarily far
        b0, b1, b2 = (x.reshape(V, len(sub), P, 1) for x in bary)
        col = (b0 * c0[:, :, None] + b1 * c1[:, :, None] + b2 * c2[:, :, None]).reshape(V, -1, C)
        mg = torch.gather(m, 1, flat)
        # every valid fragment has zn <= mg, so the clamp at 0 changes no
        # valid weight; an invalid one would overflow exp to inf
        ex = torch.exp(_min((zn - mg) / gamma, 0.0))
        w = torch.where(valid, D * ex, 0.0)
        num = num.scatter_add(1, flat[..., None].expand(-1, -1, C), w[..., None] * col)
        den = den.scatter_add(1, flat, w)
    img = num / _max(den, 1e-12)[..., None]
    return img.reshape(V, Hl, Wl, C)
