"""H.265 / HEVC test streams in MP4 through the port's writer
(``csrc/hevc_writer.cpp``, built with g++ at first use and loaded with
ctypes), the way ``synthetic.py`` makes test data.

The JAX package writes only mp4v, so the port adds no HEVC writing feature:
nothing in ``io/video.py`` or a CLI reaches this module. It exists for the
tests, ``tools/hevc_sweep.py`` and ``chip_smoke.py``, which need HEVC files
where no encoder is at hand (the opencv-python wheel's FFmpeg decodes HEVC
but cannot write it). The writer drives the decoder's own syntax code
(``csrc/hevc.h``) with the bit writer on, so every stream it writes is held
against ``cv2.VideoCapture``, never only against the port's decoder.

``write_random`` draws the syntax of ``n_frames`` pictures from a seed;
``write_frames`` codes BGR frames (intra 2Nx2N, skip, merge and AMVP coding
units of 16x16 at a fixed QP, an I picture every ``gop`` frames). The keyword
features become the writer's options; where one is absent, random mode draws
it per stream: ``ctb`` (16, 32 or 64), ``min_cb`` (8 or 16), ``max_tb``
(the largest transform), ``amp``, ``sao``, ``pcm``, ``scaling`` (scaling
lists, in the SPS and/or the PPSs), ``tmvp``, ``strong`` (strong intra
smoothing), ``output_flag`` (pic_output_flag), ``sign_hiding``,
``cabac_init``, ``constrained_intra``, ``transform_skip``, ``cu_qp_delta``,
``chroma_offsets``, ``weighted``, ``bypass`` (transquant bypass),
``lf_across``, ``deblock``, ``list_mod``, ``poc_bits``
(log2_max_pic_order_cnt_lsb), ``sps_rps`` (short-term RPSs in the SPS),
``vui``; and as given: ``group`` (POCs out of decode order in groups of up
to that many pictures, the last coded first), ``gop`` (an IRAP picture every
that many; 0: only the first), ``cra`` (1: the later IRAPs are CRA, 2: some,
3: the first too), ``idr_n_lp``, ``refs`` (references kept), ``slices`` (up
to that many a picture), ``intra_only``, the shares ``nonref`` (TRAIL_N
pictures), ``no_output_prior`` (IRAPs with no_output_of_prior_pics_flag),
``skip`` (skipped coding units), ``pcm_share``, ``mod_share`` (list
modification), ``deblock_off_share`` (slices after the first that disable
deblocking), ``hidden_share`` (pic_output_flag 0), ``inter_rps_share``
(slice-header RPSs predicted from the SPS's); ``hev1`` (sample entry hev1,
parameter sets in band), ``inband`` (hvc1 that repeats them before each
IRAP), ``length_size``, ``quicktime``, ``rotation``, ``crop_top``/
``crop_left``, ``full_range``/``matrix``/``primaries``/``transfer`` (VUI
colour), ``hrd`` (VUI timing and HRD parameters), ``ctts`` (0: no
composition offsets for reordered pictures), ``refuse`` (write a feature
the decoder refuses: main10, rext, bit_depth10, chroma422, long_term,
tiles, wpp, dependent_slice, b_slice, leading, missing_ref).
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Iterable, Tuple

import numpy as np

from ..ops import _build

SOURCE = "hevc_writer.cpp"
_ERRLEN = 256
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
        lib.hevc_writer_open.argtypes = [s, i, i, i, i, s, s, i]
        lib.hevc_writer_open.restype = p
        lib.hevc_writer_write.argtypes = [p, p, s, i]
        lib.hevc_writer_write.restype = i
        lib.hevc_writer_close.argtypes = [p, s, i]
        lib.hevc_writer_close.restype = i
        _LIB = lib
    return _LIB


def _options(features: dict) -> bytes:
    return ";".join(f"{k}={v if isinstance(v, str) else int(v) if isinstance(v, bool) else v}"
                    for k, v in features.items()).encode()


def _write(path: str, size: Tuple[int, int], fps: float, opts: dict, frames: Iterable) -> None:
    lib = _lib()
    w, h = (int(v) for v in size)
    rate = Fraction(fps).limit_denominator(1001)
    err = ctypes.create_string_buffer(_ERRLEN)
    handle = lib.hevc_writer_open(path.encode(), w, h, rate.numerator, rate.denominator,
                                  _options(opts), err, _ERRLEN)
    if not handle:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        for frame in frames:
            ptr = None
            if frame is not None:
                frame = np.ascontiguousarray(frame)
                if frame.dtype != np.uint8 or frame.shape != (h, w, 3):
                    raise ValueError(f"{path}: frames are ({h}, {w}, 3) uint8, got "
                                     f"{frame.dtype} {frame.shape}")
                ptr = frame.ctypes.data
            if lib.hevc_writer_write(handle, ptr, err, _ERRLEN):
                raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    finally:
        if lib.hevc_writer_close(handle, err, _ERRLEN):
            raise ValueError(f"{path}: {err.value.decode(errors='replace')}")


def write_random(path: str, size: Tuple[int, int], n_frames: int, seed: int = 0,
                 fps: float = 30.0, **features) -> None:
    """An MP4 of ``n_frames`` pictures whose syntax is drawn from ``seed``;
    ``size`` is (width, height), even, and need not be a multiple of 8."""
    _write(path, size, fps, dict(mode="random", seed=seed, **features), [None] * n_frames)


def write_frames(path: str, frames, fps: float = 30.0, qp: int = 24, gop: int = 0,
                 ctb: int = 64, **features) -> None:
    """An MP4 of the (H, W, 3) BGR uint8 frames: an I picture first (and every
    ``gop`` frames when ``gop`` > 0), P pictures between, at quantiser ``qp``,
    under CTBs of ``ctb``."""
    frames = list(frames)
    h, w = frames[0].shape[:2]
    _write(path, (w, h), fps, dict(mode="frames", qp=qp, gop=gop, ctb=ctb, **features), frames)
