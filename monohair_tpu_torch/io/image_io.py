"""Per-view map loading: 2D orientation, confidence, depth, hair mask
(port of monohair_tpu/io/image_io.py), with its own PNG reader and writer.

The decode conventions are the reference's:
- orientation images store the Gabor angle in degrees as grayscale; decode is
  theta = (180 - g)/180 * pi, vector = (sin theta, cos theta)
  (PMVO_utils.py:255-276 `Load_Ori_And_Conf`)
- confidence images are grayscale / 255
- depth is a (H, W, 3) .npy holding 255 * (-z_cam)/2 (PMVO_utils.py:278-295)
- masks binarize at 50/255 (PMVO_utils.py:297-313), read from channel 0 of the
  BGR image as cv2.imread returns it

PNGs are decoded here with zlib and numpy: 8-bit gray, gray+alpha, RGB or
RGBA, non-interlaced, filter types 0-4 — what cv2.imwrite writes for uint8
images. ``write_png`` writes the same kinds with filter 0. Channels stay in
file order (RGB, RGBA); cv2 hands the JAX package BGR and BGRA, and its
``[..., 2::-1]`` slices are ``[..., :3]`` here. OpenCV is not used: a .jpg/.JPG/.jpeg
goes through the port's baseline JPEG codec (``io/jpeg.py``), which gives
cv2's pixels and files. ``imread_*`` and ``imwrite`` choose the codec by the
file's suffix; ``read_png``/``write_png`` take PNG only.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.resize import png_rgb_to_gray
from .jpeg import read_jpeg, write_jpeg

_SUFFIXES = (".JPG", ".png", ".jpg")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples per pixel
_COLOUR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _find(path_no_ext: str) -> str:
    for s in _SUFFIXES:
        if os.path.exists(path_no_ext + s):
            return path_no_ext + s
    raise FileNotFoundError(path_no_ext + " (.JPG/.png/.jpg)")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
    return cur


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (line[i] + pred) & 0xFF
    return cur


def is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit gray, gray+alpha, RGB or RGBA non-interlaced PNG ->
    (H, W) or (H, W, C) uint8 with C = 2, 3 or 4, channels in file order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length                       # length, type, body, CRC
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: only 8-bit gray/GA/RGB/RGBA non-interlaced PNGs are supported "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(width, bpp), 0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype == 3:      # Average
            cur = np.frombuffer(_unfilter_average(line.tobytes(), prev.tobytes(), bpp),
                                np.uint8)
        elif ftype == 4:      # Paeth
            cur = np.frombuffer(_unfilter_paeth(line.tobytes(), prev.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out if bpp == 1 else out.reshape(height, width, bpp)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write an (H, W) gray or (H, W, C) uint8 image, C = 2 (gray+alpha),
    3 (RGB) or 4 (RGBA), as PNG (filter 0)."""
    if is_jpeg(path):
        raise ValueError(f"write_png: {path} names a JPEG; use imwrite")
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (2, 3, 4)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 2|3|4) uint8, got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape[:2]
    color = _COLOUR_TYPE[1 if img.ndim == 2 else img.shape[2]]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), img.reshape(height, -1)], 1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def _without_alpha(img: np.ndarray) -> np.ndarray:
    """Drop a gray+alpha or RGBA image's alpha, as cv2.imread does without
    IMREAD_UNCHANGED: (H, W) gray or (H, W, 3) RGB."""
    if img.ndim == 3 and img.shape[2] in (2, 4):
        img = img[..., :-1]
    return img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img


def imwrite(path: str, img: np.ndarray, quality: Optional[int] = None) -> None:
    """Write (H, W) gray or (H, W, C) uint8 in file order (RGB), as
    cv2.imwrite writes the BGR image: a .jpg/.JPG/.jpeg as baseline 4:2:0 JPEG
    at ``quality`` (cv2's default 95 when None), anything else as PNG."""
    if is_jpeg(path):
        write_jpeg(path, img, quality)
    elif quality is not None:
        raise ValueError(f"imwrite: a quality is for JPEG, not {path}")
    else:
        write_png(path, img)


def imread_gray(path: str) -> np.ndarray:
    """(H, W) uint8, as cv2.imread(path, cv2.IMREAD_GRAYSCALE) gives it: a
    JPEG's Y plane (libjpeg's grayscale output), a PNG's BGR2GRAY."""
    if is_jpeg(path):
        return read_jpeg(path, gray=True)
    img = _without_alpha(read_png(path))
    if img.ndim == 2:
        return img
    return png_rgb_to_gray(torch.from_numpy(np.ascontiguousarray(img))).numpy()


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 in RGB order, as cv2.cvtColor(cv2.imread(path),
    cv2.COLOR_BGR2RGB) gives it."""
    if is_jpeg(path):
        return read_jpeg(path)
    img = _without_alpha(read_png(path))
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img


def imread_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 in BGR order, as cv2.imread(path) gives it."""
    if is_jpeg(path):
        return np.ascontiguousarray(read_jpeg(path)[..., ::-1])
    img = _without_alpha(read_png(path))
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    return img[..., ::-1]


# ---------------------------------------------------------------------------
# per-view maps
# ---------------------------------------------------------------------------

def encode_orientation_image(theta: np.ndarray) -> np.ndarray:
    """Angle in radians [0, pi) -> uint8 degree image (inverse of decode up to
    the 180-g flip; used when writing best_ori maps, GaborFilter.py:209). The
    f32 angle is divided and scaled in f32 and truncated, as the JAX package
    does it, so a bin k can land on k - 1."""
    return np.clip(theta / math.pi * 180.0, 0, 255).astype(np.uint8)


def decode_orientation_image(gray: np.ndarray) -> np.ndarray:
    """(H, W) uint8/float angle-in-degrees image -> (H, W, 2) (sin, cos) vectors."""
    theta = (180.0 - gray.astype(np.float32)) / 180.0 * math.pi
    return np.stack([np.sin(theta), np.cos(theta)], -1)


def load_orientation_and_confidence(views: List[str], ori_dir: str, conf_dir: str
                                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked (V, H, W, 2) orientation vectors and (V, H, W) confidences."""
    oris, confs = [], []
    for view in views:
        oris.append(decode_orientation_image(imread_gray(_find(os.path.join(ori_dir, view)))))
        c = imread_gray(_find(os.path.join(conf_dir, view)))
        confs.append(c.astype(np.float32) / 255.0)
    return np.stack(oris), np.stack(confs)


def load_depth_maps(views: List[str], depth_dir: str) -> np.ndarray:
    """Stacked (V, H, W) depth maps on the 0..255 scale (channel 0 of the npy)."""
    out = []
    for view in views:
        d = np.load(os.path.join(depth_dir, view + ".npy")).astype(np.float32)
        if d.ndim == 3:
            d = d[..., 0]
        out.append(d)
    return np.stack(out)


def load_masks(views: List[str], mask_dir: str) -> np.ndarray:
    """Stacked (V, H, W) float masks; values <50/255 zeroed (PMVO_utils.py:303-304)."""
    out = []
    for view in views:
        m = imread_bgr(_find(os.path.join(mask_dir, view)))[..., 0].astype(np.float32)
        m[m < 50] = 0
        out.append(m / 255.0)
    return np.stack(out)
