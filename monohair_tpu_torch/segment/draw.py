"""OpenCV 5.0's drawing and filtering rules that the segmentation nets'
training frames use (tools/train_hair_parser.py), written out on numpy so the
port draws the same pixels without OpenCV:

- ``ellipse`` (filled, LINE_8): ellipse2Poly's polygon from OpenCV's
  whole-degree sine table, the angle rounded to whole degrees and the step
  chosen from the axes, in 16.16 fixed point, then the convex fill;
- ``line`` (LINE_8, thickness 1-5) and ``polylines`` (open): thickness 1 is
  the LineIterator's Bresenham walk; a thicker line, its ends first clipped
  to the image grown by the thickness, is a convex quadrilateral in 16.16
  fixed point plus round caps (filled midpoint circles), as drawing.cpp's
  ThickLine draws it;
- ``gaussian_blur`` (uint8, 3x3 or 5x5, sigma 0): the fixed binomial kernels
  of ksize <= 7 in OpenCV's bit-exact fixed point, BORDER_REFLECT_101;
- ``dilate`` / ``erode`` (ksize x ksize ones, the border ignored), on tensors;
- ``resize_nearest`` (INTER_NEAREST).

Images are (H, W) or (H, W, C) uint8 arrays, drawn in place; colours are one
value or a tuple of one value a channel.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .annotations import _XY_ONE as XY_ONE, _XY_SHIFT as XY_SHIFT, _clip_line, _line8, _tdiv

_HALF = XY_ONE >> 1

# OpenCV's SinTable: sin of 0..450 whole degrees as float literals of 7
# decimals (cos(a) = SinTable[450 - a])
_SIN_TABLE = np.round(np.sin(np.radians(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def _round(x: float) -> int:
    """cvRound: to nearest, ties to even."""
    return int(np.rint(x))


def _color(img: np.ndarray, color):
    """A colour of one value a channel as the image's pixel."""
    c = np.asarray(color).reshape(-1).astype(img.dtype)
    return c if img.ndim == 3 else c[0]


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


# ---------------------------------------------------------------------------
# drawing.cpp's primitives
# ---------------------------------------------------------------------------

def _line2(img: np.ndarray, p1, p2, color) -> None:
    """Line2: a line between 16.16 fixed-point ends, stepped one pixel along
    the major axis, the minor coordinate in fixed point; both ends drawn."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    px, py = (x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT
    if 0 <= px < w and 0 <= py < h:
        img[py, px] = color
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        ys = (y1 >> XY_SHIFT) + k
        xs = (x1 + k * x_step) >> XY_SHIFT
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color,
                      shift: int = XY_SHIFT) -> None:
    """FillConvexPoly (LINE_8): the outline's edges drawn (Line2 for
    fixed-point vertices), then each row from the left edge to the right, the
    edges' x in 16.16 fixed point stepped by a rounded slope, the span's ends
    rounded half up."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        p = (x << (XY_SHIFT - shift), y << (XY_SHIFT - shift))
        if shift == 0:
            _line8(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                   (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        # the rows until an edge ends: both edges step linearly
        y_end = min(edge[0]["ye"], edge[1]["ye"], ymax + 1)
        n = max(y_end - y, 1)
        k = np.arange(n, dtype=np.int64)
        xa = edge[0]["x"] + k * edge[0]["dx"]
        xb = edge[1]["x"] + k * edge[1]["dx"]
        left, right = np.minimum(xa, xb), np.maximum(xa, xb)
        x1 = (left + _HALF) >> XY_SHIFT
        x2 = (right + _HALF) >> XY_SHIFT
        rows = slice(max(y, 0), y + n)
        if rows.start < rows.stop:
            x1, x2 = x1[rows.start - y:, None], x2[rows.start - y:, None]
            cols = np.arange(w)[None, :]
            span = (cols >= x1) & (cols <= x2)        # empty where x2 < 0 or x1 >= w
            img[rows][span] = color
        edge[0]["x"] += n * edge[0]["dx"]
        edge[1]["x"] += n * edge[1]["dx"]
        y += n
        if y > ymax:
            break


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """Circle with fill: the midpoint circle's horizontal spans."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int, flags: int) -> None:
    """ThickLine for 16.16 ends (LINE_8): thickness <= 1 the Bresenham walk
    between the rounded ends; else the quadrilateral of half-width
    (thickness + thickness % 2) / 2 and, for flags bit i, a round cap of
    radius (thickness + 1) // 2 at end i."""
    if thickness <= 1:
        _line8(img, ((p0[0] + _HALF) >> XY_SHIFT, (p0[1] + _HALF) >> XY_SHIFT),
               ((p1[0] + _HALF) >> XY_SHIFT, (p1[1] + _HALF) >> XY_SHIFT), color)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)],
                          color, XY_SHIFT)
    radius = (thickness + _HALF) >> XY_SHIFT
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _circle_filled(img, (p[0] + _HALF) >> XY_SHIFT, (p[1] + _HALF) >> XY_SHIFT,
                           radius, color)


# ---------------------------------------------------------------------------
# the public functions (cv2's signatures, shift 0, LINE_8)
# ---------------------------------------------------------------------------

def _segment(img: np.ndarray, pt1, pt2, color, thickness: int, flags: int) -> None:
    """One segment between integer ends: a thicker line's ends are first
    clipped (cv::clipLine, integer) to the image grown by the thickness on
    every side, and nothing is drawn when the segment misses it."""
    p1, p2 = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    if thickness > 1:
        h, w = img.shape[:2]
        t = thickness
        clipped = _clip_line(w + 2 * t, h + 2 * t, (p1[0] + t, p1[1] + t), (p2[0] + t, p2[1] + t))
        if clipped is None:
            return
        (x1, y1), (x2, y2) = clipped
        p1, p2 = (x1 - t, y1 - t), (x2 - t, y2 - t)
    _thick_line(img, (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT),
                (p2[0] << XY_SHIFT, p2[1] << XY_SHIFT), color, thickness, flags)


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, thickness) with LINE_8, in place."""
    _segment(img, pt1, pt2, _color(img, color), int(thickness), 3)
    return img


def polylines(img: np.ndarray, pts: np.ndarray, color, thickness: int = 1) -> np.ndarray:
    """cv2.polylines(img, [pts], False, color, thickness) with LINE_8, in
    place: each segment as `line` draws it, the first with both caps, the
    others with their end's cap only."""
    c = _color(img, color)
    v = np.asarray(pts).reshape(-1, 2)
    flags = 3
    for p0, p1 in zip(v[:-1], v[1:]):
        _segment(img, p0, p1, c, int(thickness), flags)
        flags = 2
    return img


def _ellipse2poly(center, axes, angle: int, delta: int) -> list:
    """ellipse2Poly (double) over the whole ellipse: the points at every
    delta degrees from 0 to 360, x = a cos t, y = b sin t rotated by angle,
    all from the sine table."""
    angle %= 360
    alpha, beta = _SIN_TABLE[450 - angle], _SIN_TABLE[angle]
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = axes[0] * _SIN_TABLE[450 - a]
        y = axes[1] * _SIN_TABLE[a]
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    return pts


def ellipse(img: np.ndarray, center, axes, angle: float, color) -> np.ndarray:
    """cv2.ellipse(img, center, axes, angle, 0, 360, color, -1) (filled,
    LINE_8), in place."""
    c = _color(img, color)
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    ax, ay = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    delta = (max(ax, ay) + _HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v = []
    for x, y in _ellipse2poly((float(cx), float(cy)), (float(ax), float(ay)),
                             _round(angle), delta):
        pt = (_round(x), _round(y))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [(cx, cy)] * 2
    _fill_convex_poly(img, v, c, XY_SHIFT)
    return img


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), 0) of a uint8 image, ksize 3 or 5:
    the binomial kernel ([1, 2, 1] / 4 or [1, 4, 6, 4, 1] / 16) on rows and
    columns, the exact sum rounded half up once (OpenCV's fixed point),
    BORDER_REFLECT_101."""
    taps = {3: (1, 2, 1), 5: (1, 4, 6, 4, 1)}[ksize]
    r = ksize // 2
    x = img.astype(np.int64)
    pad = [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(x, pad, mode="reflect")
    H, W = img.shape[:2]
    rows = sum(t * x[:, i:i + W] for i, t in enumerate(taps))
    s = sum(t * rows[i:i + H] for i, t in enumerate(taps))
    total = sum(taps) ** 2
    return ((s + total // 2) // total).astype(np.uint8)


def dilate(x: torch.Tensor, ksize: int = 13) -> torch.Tensor:
    """cv2.dilate(x, ones((ksize, ksize))) of (..., H, W) float maps: the
    window's maximum, the border ignored."""
    shape = x.shape
    y = F.max_pool2d(x.reshape(-1, 1, *shape[-2:]), ksize, 1, ksize // 2)
    return y.reshape(shape)


def erode(x: torch.Tensor, ksize: int = 13) -> torch.Tensor:
    """cv2.erode(x, ones((ksize, ksize))): the window's minimum, the border
    ignored."""
    return -dilate(-x, ksize)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST) for size (h, w):
    source index floor(d * (1 / (dst / src))) in float64, clamped."""
    H, W = img.shape[:2]
    h, w = size
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
    return img[sy[:, None], sx[None, :]]
