"""Z-buffer rasterization of strand line segments and triangle meshes (port of
monohair_tpu/ops/rasterize.py), in plain PyTorch on the cameras' device.

Geometry becomes *fragments* (pixel id, camera depth, attribute): each line
segment is sampled at S points with a 3x3 footprint (line_width 3,
Render_utils.py:28); each triangle is rasterized exactly over a K x K pixel
window at the finest mip level where its bbox fits (larger triangles render
coarser and are upsampled). Depth resolves by a scatter-min into the z-buffer
(`scatter_reduce_` "amin"); attributes resolve in a second pass among the
fragments whose depth matches the winning depth. Both passes stream over
fragment chunks.

Where several fragments win one pixel, the JAX package keeps the one its
scatter applies last, which on the CPU is the last in fragment order, chunk
after chunk. A scatter of duplicate indices has no order on the card, so the
port picks that fragment explicitly: a scatter-max of the fragment's index,
then a gather of its segment's attribute.

Conventions match the GL pipeline: depth = -z_cam, NDC x right / y up, pixel
row = (1 - y_ndc)/2 * H (GL flips vertically on readback, Render_utils.py:257).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..camera import Cameras, project

DEPTH_EPS = 1e-4


def _pixel_from_ndc(uv: torch.Tensor, image_size) -> torch.Tensor:
    """NDC -> continuous (row, col) with GL vertical flip: row = (1 - v)/2 * H.

    This differs from camera.ndc_to_pixel (the PMVO map convention, which
    negates u instead): the renderer must match GL's framebuffer orientation.
    """
    H, W = image_size
    col = (uv[..., 0] * 0.5 + 0.5) * W
    row = (1.0 - (uv[..., 1] * 0.5 + 0.5)) * H
    return torch.stack([row, col], -1)


# -----------------------------------------------------------------------------
# Line segments
# -----------------------------------------------------------------------------

_FOOT3 = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), indexing="ij"),
                  -1).reshape(-1, 2)


def _line_fragments(cam: Cameras, p0: torch.Tensor, p1: torch.Tensor,
                    image_size: Tuple[int, int], samples: int = 6):
    """Fragments of (M, 3)x(M, 3) segments in one view: (pix (M*samples*9,)
    int64, depth, valid); fragment f belongs to segment f // (samples*9)."""
    H, W = image_size
    uv0, z0 = project(cam, p0)
    uv1, z1 = project(cam, p1)
    uv0, z0, uv1, z1 = uv0[0], z0[0], uv1[0], z1[0]
    t = torch.linspace(0.0, 1.0, samples, device=p0.device)
    uv = uv0[:, None, :] * (1 - t[None, :, None]) + uv1[:, None, :] * t[None, :, None]
    z = z0[:, None] * (1 - t[None]) + z1[:, None] * t[None]
    rci = torch.round(_pixel_from_ndc(uv, (H, W))).long()           # (M, S, 2)
    rcf = rci[:, :, None, :] + torch.as_tensor(_FOOT3, device=p0.device)
    depth = -z
    valid = ((depth[..., None] > 0)
             & (rcf[..., 0] >= 0) & (rcf[..., 0] < H)
             & (rcf[..., 1] >= 0) & (rcf[..., 1] < W))
    pix = rcf[..., 0].clamp(0, H - 1) * W + rcf[..., 1].clamp(0, W - 1)
    d = depth[..., None].expand(valid.shape)
    return pix.reshape(-1), d.reshape(-1), valid.reshape(-1)


def tangent_step_points(p0: np.ndarray, tangent: np.ndarray) -> np.ndarray:
    """The points a 0.01-long step along each segment's tangent from its start,
    whose projection gives the segment's screen direction."""
    return p0 + tangent / np.maximum(np.linalg.norm(tangent, axis=-1, keepdims=True),
                                     1e-12) * 0.01


def tangent_colors(cam: Cameras, p0: torch.Tensor, p_step: torch.Tensor,
                   mode: int) -> torch.Tensor:
    """Per-segment color replicating the strand fragment shader
    (Render_utils.py:56-107): theta from the NDC-space projection of the step
    from `p0` to `p_step` (tangent_step_points), both on the camera's device;
    mode 1 = angle color, 2 = double angle, 3 = white."""
    uv0, _ = project(cam, p0)
    uv1, _ = project(cam, p_step)
    t2d = (uv1 - uv0)[0]
    theta = torch.atan2(t2d[:, 1], t2d[:, 0])
    if mode in (1, 2):
        a = theta if mode == 1 else 2 * theta
        return torch.stack([(torch.cos(a) + 1) * 0.5, (torch.sin(a) + 1) * 0.5,
                            torch.zeros_like(theta)], -1)
    return torch.ones((theta.shape[0], 3), dtype=torch.float32, device=p0.device)


def segment_tangent_colors(cam: Cameras, p0: np.ndarray, tangent: np.ndarray,
                           mode: int) -> torch.Tensor:
    """tangent_colors of segments given on the host by start and tangent."""
    dev = cam.device
    return tangent_colors(cam, torch.as_tensor(p0, device=dev),
                          torch.as_tensor(tangent_step_points(p0, tangent), device=dev), mode)


def rasterize_strands(cam: Cameras, seg_starts, seg_ends,
                      colors: torch.Tensor, image_size: Tuple[int, int],
                      chunk: int = 262144, samples: int = 6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth buffer (+inf = background) and color buffer of strand segments
    with per-segment colors (M, C), in one view. The segments' starts and ends
    are arrays or tensors; tensors on the camera's device are not copied."""
    H, W = image_size
    dev = cam.device
    p0 = torch.as_tensor(seg_starts, dtype=torch.float32, device=dev)
    p1 = torch.as_tensor(seg_ends, dtype=torch.float32, device=dev)
    M = p0.shape[0]
    zbuf = torch.full((H * W,), math.inf, dtype=torch.float32, device=dev)
    for beg in range(0, M, chunk):
        pix, d, valid = _line_fragments(cam, p0[beg:beg + chunk], p1[beg:beg + chunk],
                                        (H, W), samples)
        zbuf.scatter_reduce_(0, pix, torch.where(valid, d, math.inf), "amin")
    # the attribute pass: per pixel, the last winning fragment in fragment order
    per_segment = samples * 9
    last = torch.full((H * W,), -1, dtype=torch.long, device=dev)
    for beg in range(0, M, chunk):
        pix, d, valid = _line_fragments(cam, p0[beg:beg + chunk], p1[beg:beg + chunk],
                                        (H, W), samples)
        win = valid & (d <= zbuf[pix] + DEPTH_EPS)
        frag = torch.arange(beg * per_segment, beg * per_segment + pix.numel(), device=dev)
        last.scatter_reduce_(0, pix[win], frag[win], "amax")
    seen = last >= 0
    out = torch.zeros((H * W, colors.shape[-1]), dtype=torch.float32, device=dev)
    out[seen] = colors[last[seen] // per_segment].float()
    return zbuf.reshape(H, W), out.reshape(H, W, -1)


# -----------------------------------------------------------------------------
# Triangles — mip-leveled exact bbox raster
# -----------------------------------------------------------------------------


def _tri_zpass(cam: Cameras, v0, v1, v2, zbuf_level: torch.Tensor, image_size,
               window: int, scale: int) -> torch.Tensor:
    """Rasterize (F, 3) triangles into a flat (H/scale * W/scale) z-buffer level.

    Each face covers an exact `window` x `window` pixel block anchored at its
    bbox min in level coords; faces whose bbox exceeds the window are masked out
    (they belong to a coarser level). Depth is barycentric-interpolated camera
    depth (screen-space linear).
    """
    H, W = image_size
    Hl, Wl = max(H // scale, 1), max(W // scale, 1)
    dev = zbuf_level.device
    proj = [project(cam, v) for v in (v0, v1, v2)]
    rc = [_pixel_from_ndc(uv[0], (H, W)) / scale for uv, _ in proj]   # level coords
    rc_all = torch.stack(rc, 1)                                        # (F, 3, 2)
    z_all = torch.stack([-z[0] for _, z in proj], 1)                   # (F, 3)
    lim = torch.tensor([Hl, Wl], dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    bb_min = torch.minimum(torch.maximum(torch.floor(rc_all.amin(1)), zero), lim)
    bb_max = torch.minimum(torch.maximum(torch.ceil(rc_all.amax(1)), zero), lim)
    size = (bb_max - bb_min).amax(-1)
    fits = size <= window
    if scale > 1:
        # only faces that did NOT fit one level finer (re-rendering small faces
        # coarsely would dilate silhouettes)
        fits = fits & (size > window / 2)
    use = fits & torch.all(z_all > 0, -1)

    offs = torch.stack(torch.meshgrid(torch.arange(window, device=dev),
                                      torch.arange(window, device=dev), indexing="ij"),
                       -1).reshape(-1, 2)                              # (P, 2)
    pix = bb_min[:, None, :] + offs[None] + 0.5                        # (F, P, 2) centres

    def edge(a, b, p):
        return ((p[..., 1] - a[:, None, 1]) * (b[:, 0] - a[:, 0])[:, None]
                - (p[..., 0] - a[:, None, 0]) * (b[:, 1] - a[:, 1])[:, None])

    a, b, c = rc
    w0, w1, w2 = edge(b, c, pix), edge(c, a, pix), edge(a, b, pix)
    area = edge(b, c, a[:, None, :])[:, 0]                             # (F,)
    area = torch.where(torch.abs(area) < 1e-12, torch.full_like(area, 1e-12), area)
    l0, l1, l2 = w0 / area[:, None], w1 / area[:, None], w2 / area[:, None]
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
    depth = l0 * z_all[:, 0:1] + l1 * z_all[:, 1:2] + l2 * z_all[:, 2:3]

    r = pix[..., 0].to(torch.int32).long()        # truncation, as astype(int32)
    cc = pix[..., 1].to(torch.int32).long()
    valid = inside & use[:, None] & (r >= 0) & (r < Hl) & (cc >= 0) & (cc < Wl)
    flat = r.clamp(0, Hl - 1) * Wl + cc.clamp(0, Wl - 1)
    d = torch.where(valid, depth, math.inf)
    return zbuf_level.scatter_reduce_(0, flat.reshape(-1), d.reshape(-1), "amin")


def rasterize_mesh_depth(cam: Cameras, vertices: np.ndarray, faces: np.ndarray,
                         image_size: Tuple[int, int], window: int = 16,
                         levels: Optional[int] = None, chunk: int = 65536
                         ) -> torch.Tensor:
    """(H, W) camera-depth buffer (+inf = background) of a triangle mesh."""
    H, W = image_size
    if levels is None:
        # enough levels that a full-image bbox fits the window at the coarsest
        levels = max(1, int(np.ceil(np.log2(max(H, W) / window))) + 1)
    dev = cam.device
    v = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    f = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    out = None
    for level in range(levels):
        scale = 2 ** level
        Hl, Wl = max(H // scale, 1), max(W // scale, 1)
        zb = torch.full((Hl * Wl,), math.inf, dtype=torch.float32, device=dev)
        for beg in range(0, len(f), chunk):
            sub = f[beg:beg + chunk]
            _tri_zpass(cam, v[sub[:, 0]], v[sub[:, 1]], v[sub[:, 2]], zb, (H, W),
                       window, scale)
        zb = zb.reshape(Hl, Wl)
        if level == 0:
            out = zb
            continue
        up = zb.repeat_interleave(scale, 0).repeat_interleave(scale, 1)[:H, :W]
        # non-power-of-two sizes: (W // s) * s can fall short of W (720 at
        # level 5 -> 704); the uncovered edge strip stays at level 0's depth
        out[:up.shape[0], :up.shape[1]] = torch.minimum(out[:up.shape[0], :up.shape[1]], up)
    return out


def compose_depth_to_image(depth: torch.Tensor, background: float = 1.0,
                           depth_range: float = 2.0) -> torch.Tensor:
    """Camera depth buffer -> normalized image like the GL depth shader
    (depth/depth_range, background = clear color)."""
    return torch.where(torch.isinf(depth), torch.full_like(depth, background),
                       depth / depth_range)
