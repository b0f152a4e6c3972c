"""MPEG-4 Part 2 video in MP4 ("mp4v") through the port's own codec
(``csrc/mp4v.cpp``, built with g++ at first use and loaded with ctypes).

The JAX package reads videos with ``cv2.VideoCapture`` and writes the NeRF
fly-through with ``cv2.VideoWriter(..., fourcc "mp4v")``, both through
FFmpeg. The codec writes FFmpeg's decoding rules out, so ``read_video`` gives
``cv2.VideoCapture``'s BGR frames bit for bit on mp4v files (I- and P-VOPs,
any size; tests/test_torch_mp4v.py), and ``VideoWriter`` writes files that
``cv2.VideoCapture`` reads back with the same frame count, size and frame
rate. Streams the codec does not take (H.264/HEVC sample entries such as
avc1 or hvc1, B-VOPs, sprites/GMC, interlace, quarter-pel, data
partitioning, video packets, the short video header) raise
``UnsupportedVideoError`` instead of being skipped.

Frames are (H, W, 3) uint8 in BGR order, as cv2 hands them over.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..ops import _build

SOURCE = "mp4v.cpp"
DEFAULT_QSCALE = 3   # the fixed quantiser: ~36 dB on smooth content
DEFAULT_GOP = 12     # an I-VOP every 12 frames, P-VOPs between (cv2's GOP)
# the counters of mp4v_stats, in the codec's order
STAT_NAMES = ("i_vops", "p_vops", "rounding_vops", "intra_mbs", "inter_mbs", "four_mv_mbs",
              "not_coded_mbs", "half_pel_vectors", "escape1", "escape2", "escape3",
              "ac_pred_mbs", "dc_as_ac_blocks", "mpeg_quant_vops")
_ERRLEN = 256


class UnsupportedVideoError(ValueError):
    """A valid file of a kind the mp4v codec does not take: another sample
    entry (avc1, hvc1, ...), B-VOPs, sprites, interlace, quarter-pel, data
    partitioning, video packets or the short video header."""


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
        lib.mp4v_open.argtypes = [s, p, s, i]
        lib.mp4v_open.restype = p
        lib.mp4v_read.argtypes = [p, p, s, i]
        lib.mp4v_read.restype = i
        lib.mp4v_stats.argtypes = [p, p]
        lib.mp4v_stats.restype = i
        lib.mp4v_close.argtypes = [p]
        lib.mp4v_close.restype = None
        lib.mp4v_writer_open.argtypes = [s, i, i, i, i, p, s, i]
        lib.mp4v_writer_open.restype = p
        lib.mp4v_writer_write.argtypes = [p, p, s, i]
        lib.mp4v_writer_write.restype = i
        lib.mp4v_writer_close.argtypes = [p, s, i]
        lib.mp4v_writer_close.restype = i
        _LIB = lib
    return _LIB


def _raise(code: int, err: ctypes.Array, what: str) -> None:
    msg = f"{what}: {err.value.decode(errors='replace')}"
    raise (UnsupportedVideoError if code == -2 else ValueError)(msg)


class VideoReader:
    """An open mp4v file: ``frames``, ``fps``, ``width``, ``height``; iterate
    for the decoded BGR frames, ``stats`` for what the stream used so far."""

    def __init__(self, path: str):
        self.path = path
        self._h = None
        lib = _lib()
        info = np.zeros(5, np.int64)
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = lib.mp4v_open(path.encode(), info.ctypes.data, err, _ERRLEN)
        if not self._h:
            _raise(int(info[0]), err, path)
        self.frames, self.width, self.height = (int(v) for v in info[:3])
        # FFmpeg's average frame rate: frames * timescale / duration
        self.fps = float(info[3]) / float(info[4]) if info[4] else 0.0

    def read(self) -> Optional[np.ndarray]:
        """The next BGR frame, None at the end."""
        if not self._h:
            return None
        out = np.empty((self.height, self.width, 3), np.uint8)
        err = ctypes.create_string_buffer(_ERRLEN)
        code = _lib().mp4v_read(self._h, out.ctypes.data, err, _ERRLEN)
        if code < 0:
            _raise(code, err, self.path)
        return out if code == 1 else None

    @property
    def stats(self) -> Dict[str, int]:
        out = np.zeros(len(STAT_NAMES) + 2, np.int64)
        n = _lib().mp4v_stats(self._h, out.ctypes.data)
        return dict(zip(STAT_NAMES, (int(v) for v in out[:n])))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def close(self) -> None:
        if self._h:
            _lib().mp4v_close(self._h)
            self._h = None

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        self.close()


def video_info(path: str) -> Tuple[int, float, int, int]:
    """(frames, fps, width, height), as cv2.VideoCapture's CAP_PROP_FRAME_COUNT,
    CAP_PROP_FPS, CAP_PROP_FRAME_WIDTH and CAP_PROP_FRAME_HEIGHT give them."""
    with VideoReader(path) as r:
        return r.frames, r.fps, r.width, r.height


def read_video(path: str) -> Iterator[np.ndarray]:
    """The frames of an mp4v file in order, each (H, W, 3) BGR uint8, as
    ``cap.read()`` returns them."""
    with VideoReader(path) as r:
        yield from r


class VideoWriter:
    """cv2.VideoWriter(path, fourcc "mp4v", fps, (W, H)): ``write`` takes
    (H, W, 3) BGR uint8 frames, ``release`` writes the index and closes the
    file. Frames are coded at the fixed quantiser ``qscale`` (1-31), an I-VOP
    every ``gop`` frames (1: intra only) and P-VOPs between. ``four_mv``,
    ``ac_pred``, ``quant_type`` (1: MPEG matrices) and ``dc_thr``
    (intra_dc_vlc_thr) switch on stream features that FFmpeg's default
    writer does not use, so that the tests can hold the decoder's paths for
    them against cv2 on the writer's files."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 qscale: int = DEFAULT_QSCALE, gop: int = DEFAULT_GOP, four_mv: bool = False,
                 ac_pred: bool = False, quant_type: int = 0, dc_thr: int = 0):
        self.path = path
        self._h = None
        self.width, self.height = (int(v) for v in frame_size)
        rate = Fraction(fps).limit_denominator(1001)
        opts = np.array([qscale, gop, int(four_mv), int(ac_pred), quant_type, dc_thr], np.int32)
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = _lib().mp4v_writer_open(path.encode(), self.width, self.height,
                                          rate.numerator, rate.denominator, opts.ctypes.data,
                                          err, _ERRLEN)
        if not self._h:
            _raise(-1, err, path)
        self.frames = 0

    def write(self, frame: np.ndarray) -> None:
        if not self._h:
            raise ValueError(f"{self.path}: the writer was released")
        frame = np.ascontiguousarray(frame)
        if frame.dtype != np.uint8 or frame.shape != (self.height, self.width, 3):
            raise ValueError(f"{self.path}: frames are ({self.height}, {self.width}, 3) uint8, "
                             f"got {frame.dtype} {frame.shape}")
        err = ctypes.create_string_buffer(_ERRLEN)
        if _lib().mp4v_writer_write(self._h, frame.ctypes.data, err, _ERRLEN):
            _raise(-1, err, self.path)
        self.frames += 1

    def release(self) -> None:
        if self._h:
            h, self._h = self._h, None
            err = ctypes.create_string_buffer(_ERRLEN)
            if _lib().mp4v_writer_close(h, err, _ERRLEN):
                _raise(-1, err, self.path)

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
