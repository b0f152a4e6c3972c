"""Per-frame annotations of the bust fit (port of
monohair_tpu/segment/annotations.py; the reference's dataprocess.py).

Four steps a frame, each skipped when its output directory exists and is not
empty ("cached"), in the file formats the bust fit reads:

  matting/<name>.png       RGBA: the frame and the MODNet matte as alpha
  landmark2d/<name>.txt    (68, 2) np.savetxt pixels (x, y), FAN
  iris/<name>.txt          (2, 3) [x, y, conf]: the pupil inside each FAN eye
                           ring (points 36-41, 42-47), refined photometrically
  face_parsing/<name>.png  uint8 class-id map (CelebAMask-HQ), BiSeNet

Backends are callables (image_paths, out_dir) -> None; each batches all
frames through its net on the device. ``fill_poly`` is OpenCV's fillPoly
(8-connected edges and its scanline rule) for integer vertices, written out.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..io.image_io import imread_rgb, read_png, write_png


class AnnotationProcessor:
    """Idempotent annotation runner over <case>/capture_images."""

    STEPS = ("matting", "landmark2d", "iris", "face_parsing")

    def __init__(self, case_root: str, image_folder: str = "capture_images",
                 backends: Optional[Dict[str, Callable]] = None):
        self.root = case_root
        self.image_dir = os.path.join(case_root, image_folder)
        self.out_root = os.path.join(case_root, "optimize")
        self.backends = backends or {}

    def _done(self, step: str) -> bool:
        d = os.path.join(self.out_root, step)
        return os.path.isdir(d) and len(os.listdir(d)) > 0

    def run(self, steps: Optional[List[str]] = None) -> Dict[str, str]:
        """Run the missing steps; returns {step: status}."""
        status = {}
        files = sorted(os.listdir(self.image_dir)) if os.path.isdir(self.image_dir) else []
        paths = [os.path.join(self.image_dir, f) for f in files]
        for step in steps or self.STEPS:
            if self._done(step):
                status[step] = "cached"
                continue
            backend = self.backends.get(step)
            if backend is None:
                status[step] = "skipped (no backend configured)"
                continue
            out_dir = os.path.join(self.out_root, step)
            os.makedirs(out_dir, exist_ok=True)
            backend(paths, out_dir)
            status[step] = "computed"
        return status


# ---------------------------------------------------------------------------
# OpenCV's fillPoly for integer vertices (imgproc/src/drawing.cpp)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, p1, p2):
    """cv::clipLine: the segment clipped to [0, w-1] x [0, h-1] (integer
    arithmetic, the offsets truncated from doubles); None when outside."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """cv::Line with LINE_8: the LineIterator's Bresenham walk, left to
    right, after clipping to the image."""
    h, w = img.shape[:2]
    clipped = _clip_line(w, h, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:                                  # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    plus_delta, minus_delta = 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        if err < 0:                              # a step along both axes
            err += minus_delta + plus_delta
            x, y = (x + 1, y + sy)
        else:                                    # a step along the major axis
            err += minus_delta
            if steep:
                y += sy
            else:
                x += 1


def fill_poly(img: np.ndarray, poly: np.ndarray, color=1) -> np.ndarray:
    """cv2.fillPoly(img, [poly], color) for one ring of integer vertices
    (K, 2) [x, y], LINE_8, shift 0, in place: every edge drawn 8-connected,
    then each scanline filled between pairs of active edges, their x in 16.16
    fixed point offset by half a pixel; a span runs from floor(x_left) to
    floor(x_right - 1/2). This gives OpenCV 5.0's pixels for rings inside the
    canvas (held against cv2 on random convex, concave and self-crossing
    rings); a ring that leaves the canvas takes cv::clipLine's clipped edges,
    where OpenCV 5.0 differs on some rings' border pixels."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
    edges = []                                   # [y0, y1, x, dx]
    p0 = pts[-1]
    for p1 in pts:
        t0, t1 = p0, p1
        _line8(img, t0, t1, color)
        x0c, y0c = (t0[0] << _XY_SHIFT), t0[1]
        x1c, y1c = (t1[0] << _XY_SHIFT), t1[1]
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            # clipped endpoints for a more accurate edge (drawing.cpp)
            c = _clip_line(w, h, t0, t1)
            if c is not None and c[0][1] != c[1][1]:
                (cx0, cy0), (cx1, cy1) = c
                x0c, y0c, x1c, y1c = cx0 << _XY_SHIFT, cy0, cx1 << _XY_SHIFT, cy1
        x0c += _XY_ONE >> 1
        x1c += _XY_ONE >> 1
        if t0[1] != t1[1]:
            dxe = _tdiv(x1c - x0c, y1c - y0c) if y1c != y0c else 0
            if t0[1] < t1[1]:
                edges.append([t0[1], t1[1], x0c + (t0[1] - y0c) * dxe, dxe])
            else:
                edges.append([t1[1], t0[1], x1c + (t1[1] - y1c) * dxe, dxe])
        p0 = p1
    if len(edges) < 2:
        return img
    y_min = min(e[0] for e in edges)
    y_max = min(max(e[1] for e in edges), h)
    for y in range(max(y_min, 0), y_max):
        xs = sorted(e[2] + (y - e[0]) * e[3] for e in edges if e[0] <= y < e[1])
        for xl, xr in zip(xs[0::2], xs[1::2]):
            x1, x2 = xl >> _XY_SHIFT, (xr - (_XY_ONE >> 1)) >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
    return img


def refine_pupil(gray: np.ndarray, ring: np.ndarray, power: float = 4.0) -> np.ndarray:
    """Pupil centre inside one eye-ring polygon: the darkness-weighted
    centroid ((1 - luminance)^power) of the pixels inside the rounded ring;
    the ring's centroid when the window is degenerate or uniformly bright.

    gray: (H, W) float or uint8 luminance. ring: (K, 2) [x, y] eyelid
    landmarks. Returns (2,) [x, y] pixels."""
    centroid = ring.mean(0)
    x0 = int(np.floor(ring[:, 0].min())) - 2
    x1 = int(np.ceil(ring[:, 0].max())) + 3
    y0 = int(np.floor(ring[:, 1].min())) - 2
    y1 = int(np.ceil(ring[:, 1].max())) + 3
    H, W = gray.shape[:2]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, W), min(y1, H)
    if x1 - x0 < 3 or y1 - y0 < 3:
        return centroid.astype(np.float32)
    crop = gray[y0:y1, x0:x1].astype(np.float32)
    if crop.max() > 1.5:                     # uint8-range input
        crop = crop / 255.0
    poly = np.round(ring - [x0, y0]).astype(np.int32)
    mask = fill_poly(np.zeros(crop.shape, np.uint8), poly, 1)
    w = mask * np.clip(1.0 - crop, 0.0, 1.0) ** power
    total = w.sum()
    if total < 1e-6:
        return centroid.astype(np.float32)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    return np.array([(w * xs).sum() / total, (w * ys).sum() / total], np.float32)


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _frames(paths: List[str], device) -> torch.Tensor:
    return torch.as_tensor(np.stack([imread_rgb(p) for p in paths]), device=device)


def default_backends(cfg: dict, device="cuda") -> Dict[str, Callable]:
    """The four backends from the segment.* checkpoint config. Only steps
    whose checkpoints exist are returned (the others stay 'skipped')."""
    from .runners import LandmarkRunner, MattingRunner, ParsingRunner, face_box_from_mask

    seg = cfg.get("segment", {}) or {}
    backends: Dict[str, Callable] = {}

    def ck(key):
        p = seg.get(key)
        return p if p and os.path.exists(p) else None

    modnet = ck("modnet_flax")
    if modnet:
        def matting(paths, out_dir, _p=modnet):
            runner = MattingRunner(_p, width=float(seg.get("modnet_width", 1.0)), device=device)
            imgs = _frames(paths, device)
            matte = runner.matte(imgs).cpu().numpy()
            for p, im, m in zip(paths, imgs.cpu().numpy(), matte):
                rgba = np.dstack([im, np.clip(m * 255, 0, 255).astype(np.uint8)])
                write_png(os.path.join(out_dir, _stem(p) + ".png"), rgba)
        backends["matting"] = matting

    fan = ck("fan_flax")
    if fan:
        def landmark2d(paths, out_dir, _p=fan):
            runner = LandmarkRunner(_p, width=float(seg.get("fan_width", 1.0)),
                                    num_modules=int(seg.get("fan_modules", 4)),
                                    depth=int(seg.get("fan_depth", 4)), device=device)
            imgs = _frames(paths, device)
            # the face box from the matte when there is one, else the frame
            boxes = []
            mat_dir = os.path.join(os.path.dirname(out_dir), "matting")
            for p in paths:
                mp = os.path.join(mat_dir, _stem(p) + ".png")
                if os.path.exists(mp):
                    boxes.append(face_box_from_mask(read_png(mp)[..., 3] / 255.0))
                else:
                    boxes.append(np.array([0, 0, imgs.shape[2], imgs.shape[1]], np.float32))
            lmk = runner.landmarks(imgs, np.stack(boxes))
            for p, k in zip(paths, lmk):
                np.savetxt(os.path.join(out_dir, _stem(p) + ".txt"), k)
        backends["landmark2d"] = landmark2d

        def iris(paths, out_dir):
            """Iris centres, rows (right, left) as the reference orders them;
            each pupil refined inside its FAN eye ring (the eyelid centroid
            is not the pupil when the gaze is off-centre)."""
            lmk_dir = os.path.join(os.path.dirname(out_dir), "landmark2d")
            for p in paths:
                lp = os.path.join(lmk_dir, _stem(p) + ".txt")
                out = np.zeros((2, 3), np.float32)
                if os.path.exists(lp):
                    k = np.loadtxt(lp)
                    gray = imread_rgb(p).astype(np.float32).mean(-1)
                    out[0, :2] = refine_pupil(gray, k[36:42])   # right eye
                    out[1, :2] = refine_pupil(gray, k[42:48])   # left eye
                    out[:, 2] = 1.0
                np.savetxt(os.path.join(out_dir, _stem(p) + ".txt"), out)
        backends["iris"] = iris

    parser = ck("parser_flax")
    if parser:
        def face_parsing(paths, out_dir, _p=parser):
            runner = ParsingRunner(_p, n_classes=int(seg.get("parser_classes", 19)),
                                   width=float(seg.get("parser_width", 1.0)),
                                   input_size=int(seg.get("parse_size", 512)), device=device)
            # the reference parses the matted frames composed on white
            mat_dir = os.path.join(os.path.dirname(out_dir), "matting")
            imgs = []
            for p in paths:
                mp = os.path.join(mat_dir, _stem(p) + ".png")
                if os.path.exists(mp):
                    rgba = read_png(mp)
                    a = rgba[..., 3:4].astype(np.float32) / 255.0
                    rgb = rgba[..., :3].astype(np.float32)
                    imgs.append((rgb * a + 255.0 * (1 - a)).astype(np.uint8))
                else:
                    imgs.append(imread_rgb(p))
            parsing = runner.parse(torch.as_tensor(np.stack(imgs), device=device)).cpu().numpy()
            for p, cls in zip(paths, parsing):
                write_png(os.path.join(out_dir, _stem(p) + ".png"), cls)
        backends["face_parsing"] = face_parsing

    return backends


def landmarks_to_training_targets(lmk_dir: str, views: List[str]) -> np.ndarray:
    """Stack per-view landmark files -> (V, L, 2) pixel targets for fit_bust."""
    return np.stack([np.load(os.path.join(lmk_dir, v + ".npy")) for v in views]
                    ).astype(np.float32)
