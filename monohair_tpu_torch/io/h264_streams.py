"""H.264 test streams in MP4 through the port's writer (``csrc/h264_writer.cpp``,
built with g++ at first use and loaded with ctypes), the way ``synthetic.py``
makes test data.

The JAX package writes only mp4v, so the port adds no H.264 writing feature:
nothing in ``io/video.py`` or a CLI reaches this module. It exists for the
tests and ``chip_smoke.py``, which need H.264 files where no encoder is at
hand (the opencv-python wheel's FFmpeg decodes H.264 but has no H.264
encoder). The writer drives
the decoder's own syntax code (``csrc/h264.h``) with the bit writer on, so
every stream it writes is held against ``cv2.VideoCapture``, never only
against the port's decoder.

``write_random`` draws the syntax of ``n_frames`` pictures from a seed;
``write_frames`` codes BGR frames (Intra 16x16, P_L0_16x16 and P_Skip, and
in B pictures B_Skip, B_Direct_16x16 and B_L0/L1/Bi_16x16, at a fixed QP).
The keyword features become the writer's options: ``cabac``,
``t8`` (the 8x8 transform), ``scaling`` (scaling lists: 1 in the SPS,
2 in the PPS, 3 both), ``slices`` (up to that
many a picture), ``deblock`` (disable_deblocking_filter_idc and offsets per
slice), ``refs`` (max_num_ref_frames), ``mmco`` (MMCOs and long-term
references), ``weighted``, ``poc_type``, ``avc3`` (in-band parameter sets,
sample entry avc3), ``inband``, ``idr_period``, ``gop`` (an I picture every
that many), ``quicktime`` (brand "qt  "), ``rotation`` (tkhd matrix),
``edit`` (an edit list from that media time), ``length_size`` (the NAL
units' length field: 1, 2 or 4 bytes), ``crop_left``/``crop_top``,
``constrained_intra``, ``nonref`` (share of non-reference pictures),
``full_range``/``matrix``/``primaries``/``transfer``/``reorder`` (VUI:
max_num_reorder_frames), ``hrd`` (VUI NAL and VCL HRD parameters and
pic_struct_present_flag), ``pcm`` (share of I_PCM macroblocks),
``intra_only``, ``bframes`` (B pictures between anchors, coded after
the anchor that follows them), ``pyramid`` (the middle B picture a
reference, coded first), ``direct`` ("spatial", "temporal" or "mixed" per
slice), ``direct8x8`` (direct_8x8_inference_flag), ``bipred_idc``
(weighted_bipred_idc: 0 default, 1 explicit, 2 implicit), ``pslices`` and
``bslices`` (shares of P slices in B pictures and of B slices in P
pictures), ``idr_long`` (with ``mmco``, the share of IDR pictures marked long-term;
0.3), ``ltcol`` (share of B slices whose list 1 starts with a held
long-term reference, the co-located picture), ``ctts`` (0: no composition offsets for reordered pictures),
``ctts_version`` (1: signed offsets, FFmpeg's negative_cts_offsets), ``edit``
(an edit list from that media time, or "movenc", FFmpeg's muxer's edit from
the first composition time, the default with ctts version 0, or "none"),
``equal_chroma_offsets`` (the PPS's two chroma QP offsets equal, as
FFmpeg's fast loop filter needs), ``atc_sei`` (an alternative transfer
characteristics SEI naming that transfer in the first access unit), ``refuse`` (write a feature the decoder refuses: sp_slice, si_slice,
redundant, partitioning, chroma422, bit_depth10, transform_bypass, fields,
slice_groups, frame_num_gap).
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Iterable, Tuple

import numpy as np

from ..ops import _build

SOURCE = "h264_writer.cpp"
_ERRLEN = 256
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
        lib.h264_writer_open.argtypes = [s, i, i, i, i, s, s, i]
        lib.h264_writer_open.restype = p
        lib.h264_writer_write.argtypes = [p, p, s, i]
        lib.h264_writer_write.restype = i
        lib.h264_writer_close.argtypes = [p, s, i]
        lib.h264_writer_close.restype = i
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
    handle = lib.h264_writer_open(path.encode(), w, h, rate.numerator, rate.denominator,
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
            if lib.h264_writer_write(handle, ptr, err, _ERRLEN):
                raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    finally:
        if lib.h264_writer_close(handle, err, _ERRLEN):
            raise ValueError(f"{path}: {err.value.decode(errors='replace')}")


def write_random(path: str, size: Tuple[int, int], n_frames: int, seed: int = 0,
                 fps: float = 30.0, **features) -> None:
    """An MP4 of ``n_frames`` pictures whose syntax is drawn from ``seed``;
    ``size`` is (width, height), even, and need not be a multiple of 16."""
    _write(path, size, fps, dict(mode="random", seed=seed, **features), [None] * n_frames)


def write_frames(path: str, frames, fps: float = 30.0, qp: int = 24, gop: int = 2,
                 cabac: bool = True, **features) -> None:
    """An MP4 of the (H, W, 3) BGR uint8 frames: an I picture every ``gop``
    frames, P pictures between (with ``bframes``, B pictures between the
    anchors), at quantiser ``qp``."""
    frames = list(frames)
    h, w = frames[0].shape[:2]
    _write(path, (w, h), fps, dict(mode="frames", qp=qp, gop=gop, cabac=cabac, **features),
           frames)
