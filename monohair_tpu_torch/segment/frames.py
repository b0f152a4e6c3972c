"""The segmentation nets' synthetic training frames (tools/train_hair_parser.py
:32-176, 294-297), drawn with the port's OpenCV rules (``segment/draw.py``,
``ops/resize.py``): the same numpy Generator, consumed in the tool's order,
gives the same frames and labels bit for bit.

- ``render_frame``: a lambertian head sphere with a hair cap (stripes, flat
  or noise texture) and strand arcs falling from its rim, randomly placed
  and scaled (radius 8-35% of the frame), over a gradient background with
  clutter rectangles, skin-coloured ellipses and lines; ~8% of the frames
  hold no head.
- ``render_case_frame``: a frame of the capture case (the orbit camera and
  the analytic head of ``synthetic.capture_render_view`` at 720x1280, 24
  degrees), a random square crop around the head resized to the frame size.
- ``finish_frame``: a colour tint and, on 30% of the frames, a 3x3 or 5x5
  Gaussian blur.
Labels are 0 background, 1 skin, 17 hair (the CelebAMask-HQ ids).
``matte_from_label`` and ``boundary_band`` give MODNet's targets.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops.resize import resize_area
from ..synthetic import CAPTURE_FOV_Y, capture_orbit_pose, capture_render_view
from . import draw

FRAME_SIZE = 512                 # the tool's S
CASE_SIZE = (720, 1280)          # the capture case's frames (H, W)
BAND_KSIZE = 13                  # boundary_band's dilate/erode window


def render_frame(rng: np.random.Generator, size: int = FRAME_SIZE
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(size, size, 3) uint8 frame and (size, size) uint8 label."""
    S = size
    img = np.zeros((S, S, 3), np.float32)
    g0, g1 = rng.random(3), rng.random(3)
    t = np.linspace(0, 1, S)[:, None, None]
    img[:] = g0 * (1 - t) + g1 * t
    for _ in range(rng.integers(0, 12)):
        x0, y0 = rng.integers(0, S, 2)
        w, h = rng.integers(20, 200, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.random(3)
    for _ in range(rng.integers(0, 5)):
        col = np.sort(rng.random(3))[::-1] * rng.uniform(0.5, 1.0)  # skin-ish
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        center = (int(rng.integers(0, S)), int(rng.integers(0, S)))
        axes = (int(rng.integers(15, 120)), int(rng.integers(15, 120)))
        draw.ellipse(u8, center, axes, float(rng.uniform(0, 180)),
                     tuple(int(c * 255) for c in col))
        img = u8.astype(np.float32) / 255.0
    for _ in range(rng.integers(0, 8)):
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        p0, p1 = tuple(rng.integers(0, S, 2)), tuple(rng.integers(0, S, 2))
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        draw.line(u8, p0, p1, color, int(rng.integers(1, 6)))
        img = u8.astype(np.float32) / 255.0
    img += rng.normal(0, 0.03, img.shape)

    # ~8% headless frames: the matte must learn to output 0
    if rng.random() < 0.08:
        return finish_frame(img, np.zeros((S, S), np.uint8), rng)

    r = rng.uniform(0.08, 0.35) * S
    cx = rng.uniform(0.25, 0.75) * S
    cy = rng.uniform(0.25, 0.75) * S
    skin = np.array([rng.uniform(0.45, 0.9), rng.uniform(0.35, 0.7),
                     rng.uniform(0.3, 0.6)])
    skin = np.sort(skin)[::-1]                       # r >= g >= b skin-ish
    hair_col = rng.random(3) * rng.uniform(0.05, 0.5)
    light = rng.normal(size=3)
    light[1] = abs(light[1]) + 0.5
    light /= np.linalg.norm(light)
    cap_deg = rng.uniform(45, 95)
    roll = rng.uniform(0, 2 * math.pi)

    ys, xs = np.mgrid[:S, :S].astype(np.float32)
    dx, dy = (xs - cx) / r, (ys - cy) / r
    rr = dx * dx + dy * dy
    hit = rr < 1.0
    nz = np.sqrt(np.maximum(1.0 - rr, 0.0))
    ux, uy = math.sin(roll), -math.cos(roll)         # head 'up' rolled in-plane
    n_up = dx * ux + dy * uy
    polar = np.degrees(np.arccos(np.clip(n_up, -1, 1)))
    shade = np.clip(dx * light[0] - dy * light[1] + nz * light[2], 0, 1) \
        * rng.uniform(0.45, 0.8) + rng.uniform(0.2, 0.45)
    az = np.arctan2(dy, dx)
    tex = rng.random()                               # stripes / flat / noise
    if tex < 0.5:
        stripes = 0.55 + rng.uniform(0.2, 0.45) * np.sin(rng.uniform(20, 70) * az)
    elif tex < 0.75:
        stripes = np.full((S, S), rng.uniform(0.7, 1.0), np.float32)
    else:
        stripes = 0.6 + 0.4 * rng.random((S, S)).astype(np.float32)

    label = np.zeros((S, S), np.uint8)
    hair = hit & (polar < cap_deg)
    skin_px = hit & ~hair
    img[skin_px] = skin[None] * shade[skin_px, None]
    img[hair] = hair_col[None] * (shade[hair] * stripes[hair])[:, None]
    label[skin_px] = 1
    label[hair] = 17

    # strand arcs falling from the cap rim (long hair)
    mask_str = np.zeros((S, S), np.uint8)
    n_str = rng.integers(0, 140)
    length = rng.uniform(0.3, 2.2) * r
    for _ in range(n_str):
        a = rng.uniform(0, 2 * math.pi)
        px = cx + math.cos(a) * r * rng.uniform(0.7, 1.0)
        py = cy + math.sin(a) * r * rng.uniform(0.7, 1.0)
        sway = rng.uniform(-0.4, 0.4)
        pts = []
        for k in range(8):
            f = k / 7.0
            pts.append([px + sway * f * f * r, py + f * length])
            pts[-1][0] += math.sin(f * 3 + a) * 0.05 * r
        draw.polylines(mask_str, np.array(pts, np.int32), 1, max(1, int(r / 40)))
    stro = mask_str.astype(bool) & ~skin_px
    img[stro] = hair_col[None] * rng.uniform(0.6, 1.0)
    label[stro] = 17

    return finish_frame(img, label, rng)


def finish_frame(img: np.ndarray, label: np.ndarray, rng: np.random.Generator
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Global photometric jitter: colour tint, optional defocus blur."""
    img = img * rng.uniform(0.75, 1.0, 3)[None, None]
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if rng.random() < 0.3:
        u8 = draw.gaussian_blur(u8, int(rng.choice([3, 5])))
    return u8, label


def render_case_frame(rng: np.random.Generator, size: int = FRAME_SIZE
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """A capture-case frame (orbit camera, analytic head, fixed palette) as a
    random square crop around the head, area-resized to (size, size); the
    label resized nearest."""
    H, W = CASE_SIZE
    f_pix = (H / 2) / math.tan(math.radians(CAPTURE_FOV_Y) / 2)
    c2w = capture_orbit_pose(rng.uniform(0, 2 * math.pi), elev=rng.uniform(0.0, 1.2))
    img, hair, hit = capture_render_view(c2w, f_pix, H, W)
    label = np.zeros((H, W), np.uint8)
    label[hit] = 1
    label[hair] = 17
    side = int(rng.uniform(0.6, 1.0) * H)
    cy = int(np.clip(H // 2 + rng.integers(-80, 80), side // 2, H - side // 2))
    cx = int(np.clip(W // 2 + rng.integers(-120, 120), side // 2, W - side // 2))
    sl = (slice(cy - side // 2, cy - side // 2 + side),
          slice(cx - side // 2, cx - side // 2 + side))
    crop = torch.from_numpy(np.ascontiguousarray(img[sl])).permute(2, 0, 1)[None]
    img = resize_area(crop, (size, size))[0].permute(1, 2, 0).numpy()
    label = draw.resize_nearest(label[sl], (size, size))
    img = img + rng.normal(0, 0.015, img.shape)
    return finish_frame(img, label, rng)


def render_frames(rng: np.random.Generator, n: int, size: int = FRAME_SIZE
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """n frames as the tool draws its set: a capture-case frame with
    probability 0.25, else a generic one -> ((n, size, size, 3) uint8,
    (n, size, size) uint8)."""
    out = [render_case_frame(rng, size) if rng.random() < 0.25 else render_frame(rng, size)
           for _ in range(n)]
    return np.stack([f for f, _ in out]), np.stack([lab for _, lab in out])


def matte_from_label(label: torch.Tensor) -> torch.Tensor:
    """The person matte of a label map: 1 where the label is not background."""
    return (label > 0).float()


def boundary_band(matte: torch.Tensor, ksize: int = BAND_KSIZE) -> torch.Tensor:
    """Dilate-minus-erode transition band around each matte edge, (..., H, W)."""
    return draw.dilate(matte, ksize) - draw.erode(matte, ksize)
