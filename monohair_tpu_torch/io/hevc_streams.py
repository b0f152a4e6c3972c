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
units of 16x16 at a fixed QP; list 0, list 1 or bi-prediction in B
pictures). Both take ``bit_depth`` (8, 9 or 10; 8 unless given, Main 10's
profile above 8): at 9 and 10 bits random mode draws samples, PCM values
(half of the blocks on one gently curved surface over the picture) and
depths (``pcm_bd`` gives the PCM depth), weighted offsets over their
whole range, QPs below 0 and SAO offsets above 7, from a generator of its
own, so that streams written without it stay as they were; frames mode
scales the frames up, with a pattern in the lowest bit of luma. The
keyword features become the writer's options; where one is
absent, random mode draws it per stream: ``ctb`` (16, 32 or 64), ``min_cb``
(8 or 16), ``max_tb`` (the largest transform), ``amp``, ``sao``, ``pcm``,
``scaling`` (scaling lists, in the SPS and/or the PPSs), ``tmvp``,
``strong`` (strong intra smoothing), ``output_flag`` (pic_output_flag),
``sign_hiding``, ``cabac_init``, ``constrained_intra``, ``transform_skip``,
``cu_qp_delta``, ``chroma_offsets``, ``weighted``, ``weighted_bipred`` (when
B slices are asked for), ``bypass`` (transquant bypass), ``lf_across``,
``deblock``, ``list_mod``, ``poc_bits`` (log2_max_pic_order_cnt_lsb),
``sps_rps`` (short-term RPSs in the SPS), ``vui``; and as given: ``group``
(POCs out of decode order in groups of up to that many pictures, the last
coded first), ``gop`` (an IRAP picture every that many; 0: only the first),
``cra`` (1: the later IRAPs are CRA, 2: some, 3: the first too, 4: the
first and some later), ``leading`` (up to that many leading pictures after
each IRAP: RASL after a CRA, RADL after an IDR_W_RADL; a CRA that starts
the stream then names pictures before it that the stream does not hold),
``idr_n_lp``, ``refs`` (references kept), ``slices`` (up to that many a
picture; with WPP, tiles or dependent slice segments, slice segments: that
many on average, up to that many in random mode), ``intra_only``, the
parallel tools, off unless given (streams without them stay as they were):
``wpp`` (entropy_coding_sync_enabled_flag), ``tiles`` with ``tile_cols``,
``tile_rows``, ``uniform`` (else explicit sizes, of one CTB or more) and
``lf_across_tiles`` (each drawn per PPS where absent), ``dependent`` (the
share of slice segment boundaries that start a dependent slice segment;
the slices and segments keep the standard's rules at tiles and WPP rows),
``bad_entry`` (the first entry point of each slice segment one byte off,
for the decoder's check), the shares ``bslices`` (of the inter slices that
are B; 0 by default), ``mvd_l1_zero`` (B slices with mvd_l1_zero_flag),
``col_l1`` (B slices taking the collocated picture from list 1), ``nonref``
(sub-layer non-reference pictures), ``no_output_prior`` (IRAPs with
no_output_of_prior_pics_flag), ``skip`` (skipped coding units),
``pcm_share``, ``mod_share`` (list modification), ``deblock_off_share``
(slices after the first that disable deblocking), ``hidden_share``
(pic_output_flag 0), ``inter_rps_share`` (slice-header RPSs predicted from
the SPS's); ``hev1`` (sample entry hev1, parameter sets in band), ``inband``
(hvc1 that repeats them before each IRAP), ``length_size``, ``quicktime``,
``rotation``, ``crop_top``/``crop_left``, ``full_range``/``matrix``/
``primaries``/``transfer`` (VUI colour), ``chroma_loc_type`` (the VUI's
chroma_sample_loc_type, 0-5, or above: unspecified), ``hrd`` (VUI timing and HRD
parameters), ``ctts`` (0: no composition offsets for reordered pictures),
``hvcc_bd`` (hvcC's luma bit depth, for the decoder's check of a wrong one),
the HDR signalling, off unless given (streams without it stay as they
were): ``atc_sei`` (an alternative transfer characteristics SEI naming that
transfer, in the access units ``atc_aus`` says: ``first`` (the default),
``all``, ``irap``, or the number of one), ``luminance_sei`` (HDR10's
mastering display colour volume and content light level SEIs in the first),
``dv_rpu`` (Dolby Vision RPU-shaped NAL units of type 62 ending each access
unit, their payloads from a generator of their own), ``dvcc`` (a Dolby
Vision configuration box of that profile: dvcC up to 7, dvvC above, its
base layer HLG-compatible for profile 8) and ``dv_entry`` (the sample entry
``dvh1`` or ``dvhe``),
``refuse`` (write a feature the decoder refuses: rext, bit_depth_mixed (luma
10 bits, chroma 8), bit_depth12, chroma422, long_term, wpp_tiles (WPP and
tiles in one PPS), bla, tsa_stsa,
missing_ref, idr_over_generated: an IDR right after the leading pictures of
a CRA that starts the stream, with cra=3). Frames mode takes ``bframes``
(0-4 B pictures between anchors, each group coded after the anchor that
follows it), ``pyramid`` (the middle B a reference, coded first), ``refs``,
``gop`` with ``cra`` (1: every ``gop`` frames a CRA whose B pictures are
RASL, an open GOP; 0: an IDR_W_RADL whose B pictures are RADL), and the
parallel tools with ``slices`` as above (``wpp=1`` as x265 writes by
default).
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
    ``gop`` frames when ``gop`` > 0), P pictures between (with ``bframes``,
    B pictures between those), at quantiser ``qp``, under CTBs of ``ctb``."""
    frames = list(frames)
    h, w = frames[0].shape[:2]
    _write(path, (w, h), fps, dict(mode="frames", qp=qp, gop=gop, ctb=ctb, **features), frames)
