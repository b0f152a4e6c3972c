"""Baseline JPEG read and write through the port's own codec
(``csrc/jpeg.cpp``, built with g++ at first use and loaded with ctypes).

The JAX package reads and writes JPEG captures through OpenCV, whose libjpeg
decides the bits; the codec writes libjpeg-turbo's rules out, so a decode
gives ``cv2.imread``'s pixels and an encode gives ``cv2.imwrite``'s file at
the same quality and sampling (tests/test_torch_jpeg.py).

EXIF orientation: ``cv2.imread`` turns the image by the EXIF orientation tag
unless told not to, and so does ``read_jpeg`` (flips and transposes as
OpenCV's ApplyExifOrientation does them).

Images are in file order: (H, W) gray or (H, W, 3) RGB uint8.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops import _build

SOURCE = "jpeg.cpp"
# cv2.imwrite's default quality (IMWRITE_JPEG_QUALITY) and sampling (4:2:0)
DEFAULT_QUALITY = 95
SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}
_ERRLEN = 256


class UnsupportedJPEGError(ValueError):
    """A valid JPEG of a kind the baseline codec does not take: progressive,
    arithmetic-coded, lossless, hierarchical, 12-bit or CMYK."""


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.jpeg_header.argtypes = [p, i64, p, ctypes.c_char_p, i]
        lib.jpeg_header.restype = i
        lib.jpeg_decode.argtypes = [p, i64, i, p, ctypes.c_char_p, i]
        lib.jpeg_decode.restype = i
        lib.jpeg_encode.argtypes = [p, i, i, i, i, i, i, i, p, i64, ctypes.c_char_p, i]
        lib.jpeg_encode.restype = i64
        _LIB = lib
    return _LIB


def _raise(code: int, err: ctypes.Array, what: str) -> None:
    msg = f"{what}: {err.value.decode(errors='replace')}"
    raise (UnsupportedJPEGError if code == 2 else ValueError)(msg)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation for the tags 2-8 (1 and others: as is)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, flip) if flip else img)


def decode_jpeg(data: bytes, gray: bool = False, what: str = "JPEG") -> np.ndarray:
    """JPEG bytes -> (H, W) gray or (H, W, 3) RGB uint8, EXIF orientation
    applied. ``gray`` of a YCbCr file is its Y plane, as cv2.IMREAD_GRAYSCALE
    gives it."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    code = lib.jpeg_header(buf.ctypes.data, buf.size, info.ctypes.data, err, _ERRLEN)
    if code:
        _raise(code, err, what)
    width, height, _, orientation = (int(v) for v in info)
    out = np.empty((height, width) if gray else (height, width, 3), np.uint8)
    code = lib.jpeg_decode(buf.ctypes.data, buf.size, int(gray), out.ctypes.data, err,
                           _ERRLEN)
    if code:
        _raise(code, err, what)
    return _orient(out, orientation)


def encode_jpeg(img: np.ndarray, quality: int = DEFAULT_QUALITY, sampling: str = "420",
                restart_interval: int = 0) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> baseline JPEG bytes, as
    cv2.imencode writes them (a gray image is always 1x1 sampled).
    ``restart_interval`` puts an RSTn marker after every that many MCUs."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f"JPEG takes (H, W) or (H, W, 1|3) uint8, got {img.dtype} {img.shape}")
    if sampling not in SAMPLING:
        raise ValueError(f"JPEG sampling {sampling!r}: one of {sorted(SAMPLING)}")
    if not 0 <= restart_interval <= 65535:
        raise ValueError(f"restart_interval {restart_interval} out of 0..65535")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    hs, vs = SAMPLING[sampling]
    lib = _lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    cap = h * w * c + 65536
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data, w, h, c, int(quality), hs, vs,
                            int(restart_interval), out.ctypes.data, cap, err, _ERRLEN)
        if n == -1:
            _raise(1, err, "JPEG encode")
        if n >= 0:
            return out[:n].tobytes()
        cap = -n


def read_jpeg(path: str, gray: bool = False) -> np.ndarray:
    """Decode a JPEG file (see decode_jpeg)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), gray, what=path)


def write_jpeg(path: str, img: np.ndarray, quality: Optional[int] = None,
               sampling: str = "420", restart_interval: int = 0) -> None:
    """Write a JPEG file at ``quality`` (cv2's default 95 when None)."""
    data = encode_jpeg(img, DEFAULT_QUALITY if quality is None else quality, sampling,
                       restart_interval)
    with open(path, "wb") as f:
        f.write(data)
