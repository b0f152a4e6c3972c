"""Video in MP4 or QuickTime through the port's own codecs, built with g++
at first use and loaded with ctypes: MPEG-4 Part 2 ("mp4v", ``csrc/mp4v.cpp``),
H.264 ("avc1"/"avc3", ``csrc/h264.cpp``) and H.265 / HEVC ("hvc1"/"hev1",
``csrc/hevc.cpp``), behind one demuxer (``csrc/mp4.h``).

The JAX package reads videos with ``cv2.VideoCapture`` and writes the NeRF
fly-through with ``cv2.VideoWriter(..., fourcc "mp4v")``, both through
FFmpeg. ``VideoReader`` picks the codec by the first video track's sample
entry. The mp4v codec writes FFmpeg's decoding rules out, so ``read_video``
gives ``cv2.VideoCapture``'s BGR frames bit for bit on mp4v files (I- and
P-VOPs, any size; tests/test_torch_mp4v.py), and ``VideoWriter`` writes files
that ``cv2.VideoCapture`` reads back with the same frame count, size and
frame rate. H.264 is bit-exact by its standard, so the H.264 decoder gives
FFmpeg's YUV planes, and cv2's BGR frames bit for bit, on progressive 8-bit
4:2:0 I, P and B slices of the Constrained Baseline, Main and High profiles,
CAVLC and CABAC (tests/test_torch_h264.py): what a phone records when it
does not use HEVC, and what x264 (FFmpeg, HandBrake) writes by default, B
pictures, B references and implicit weights included, with the frames cv2
hands over in its order (and the pictures it drops, where the file does not
tell FFmpeg the reorder delay). HEVC is bit-exact by its standard too:
the HEVC decoder gives cv2's frames bit for bit on the Main profile's I and P
slices (tests/test_torch_hevc.py): CTBs of 16, 32 and 64, CABAC, intra,
merge/AMVP/TMVP inter prediction, weighted prediction, scaling lists,
transform skip, sign hiding, PCM, transquant bypass, the deblocking filter
and SAO, several slices a picture, IDR, CRA and trailing pictures, POCs out
of decode order, with FFmpeg's output order and its departures from the
standard in the loop filters; what a phone records when it records HEVC
without B slices. The display matrix of a phone's
portrait video is applied as cv2 applies it: the frames come rotated by 90,
180 or 270 degrees, and ``width``/``height`` are the rotated frame's.
Streams the codecs do not take raise ``UnsupportedVideoError`` naming the
feature instead of being skipped: a sample entry none of the codecs reads
(named with the entries the port reads), an edit
list other than the identity or FFmpeg's muxer's edit from the first
composition time, a display matrix that is no rotation by a
multiple of 90 degrees; in mp4v B-VOPs, sprites/GMC, interlace, quarter-pel,
data partitioning, video packets and the short video header; in H.264 SP
and SI slices, fields and MBAFF, other chroma formats and bit depths, slice
groups, redundant pictures, data partitioning, the lossless transform bypass,
gaps in frame_num, reference lists longer than the references held; in HEVC
B slices, RASL/RADL leading pictures, BLA and TSA/STSA pictures, WPP,
tiles, dependent slice segments, long-term references, profiles other than
Main and the SPS/PPS extensions, bit depths above 8, chroma formats other
than 4:2:0, coded fields, constrained intra prediction with coding blocks of
16x16 or more, a missing reference picture; in H.264 and HEVC a left
crop, and the colour descriptions whose frames cv2
converts through colour management (BT.2020 primaries, PQ/HLG transfers, the
GBR, YCgCo and BT.2020 matrices). Full range and the BT.601/BT.709 matrices
convert as cv2 converts them.

Frames are (H, W, 3) uint8 in BGR order, as cv2 hands them over.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..ops import _build

SOURCE = "mp4v.cpp"
H264_SOURCE = "h264.cpp"
HEVC_SOURCE = "hevc.cpp"
MP4V_ENTRIES = ("mp4v",)
H264_ENTRIES = ("avc1", "avc3")
HEVC_ENTRIES = ("hvc1", "hev1")
DEFAULT_QSCALE = 3   # the fixed quantiser: ~36 dB on smooth content
DEFAULT_GOP = 12     # an I-VOP every 12 frames, P-VOPs between (cv2's GOP)
# the counters of mp4v_stats, in the codec's order
STAT_NAMES = ("i_vops", "p_vops", "rounding_vops", "intra_mbs", "inter_mbs", "four_mv_mbs",
              "not_coded_mbs", "half_pel_vectors", "escape1", "escape2", "escape3",
              "ac_pred_mbs", "dc_as_ac_blocks", "mpeg_quant_vops")
# the counters of h264_stats, in the codec's order (long_term_refs: the
# long-term reference pictures held, summed over the pictures decoded;
# deblocked_slices: disable_deblocking_filter_idc 0 or 2;
# slice_edge_unfiltered_slices: idc 2, whose slices' edges stay unfiltered;
# scaling_list_slices: slices whose scaling lists are not flat; skip_mbs:
# P_Skip and B_Skip; direct_mbs: B_Direct_16x16 and B_8x8 with B_Direct_8x8;
# bipred_partitions: partitions coded with both lists (direct ones aside);
# b_reference_pictures: reference pictures with a B slice; dropped_pictures:
# pictures FFmpeg drops as out of order, and so does the decoder;
# long_term_colocated_slices: B slices whose RefPicList1[0] is a long-term
# reference; mixed_type_pictures: pictures with slices of two or three types)
H264_STAT_NAMES = ("idr_pictures", "i_slices", "p_slices", "cabac_slices", "intra4x4_mbs",
                   "intra8x8_mbs", "intra16x16_mbs", "pcm_mbs", "inter_mbs", "skip_mbs",
                   "sub8x8_mbs", "transform8x8_mbs", "weighted_slices", "long_term_refs",
                   "mmcos", "deblocked_slices", "slice_edge_unfiltered_slices",
                   "scaling_list_slices", "ref_list_modified_slices", "b_slices",
                   "direct_spatial_slices", "direct_temporal_slices", "b_skip_mbs",
                   "direct_mbs", "bipred_partitions", "implicit_weighted_slices",
                   "b_reference_pictures", "dropped_pictures", "long_term_colocated_slices",
                   "mixed_type_pictures")
# the counters of hevc_stats, in the codec's order (pictures by NAL unit
# type and CTB size; partial_ctbs: CTBs that cross the picture's right or
# bottom edge; small_pus: 8x4 and 4x8 prediction units; tmvp_candidates:
# prediction units whose merge or AMVP list took the collocated vector;
# sign_hidden_groups: 4x4 coefficient groups with a hidden sign;
# lf_not_across_slices: slices after the first that do not filter across
# their left and upper edges; sao_*: CTB components; hidden_pictures:
# pic_output_flag 0; discarded_pictures: dropped by
# no_output_of_prior_pics_flag; repeated_ref_slices: reference lists longer
# than the pictures they cycle through)
HEVC_STAT_NAMES = ("idr_pictures", "cra_pictures", "trail_n_pictures", "i_slices", "p_slices",
                   "multi_slice_pictures", "ctb16_pictures", "ctb32_pictures", "ctb64_pictures",
                   "partial_ctbs", "intra_cus", "intra_nxn_cus", "pcm_cus", "bypass_cus",
                   "skip_cus", "merge_pus", "amvp_pus", "amp_cus", "inter_nxn_cus", "small_pus",
                   "tmvp_slices", "tmvp_candidates", "weighted_slices", "transform_skip_blocks",
                   "sign_hidden_groups", "dst_blocks", "transform32_blocks",
                   "scaling_list_slices", "qp_delta_cus", "chroma_offset_slices",
                   "strong_smoothing_blocks", "constrained_intra_slices", "deblocked_slices",
                   "deblock_disabled_slices", "lf_not_across_slices", "sao_band_ctbs",
                   "sao_edge_ctbs", "sao_merged_ctbs", "ref_list_modified_slices",
                   "inter_rps_slices", "sps_rps_slices", "hidden_pictures",
                   "discarded_pictures", "cabac_init_slices", "repeated_ref_slices")
_CODECS = {"mp4v": (SOURCE, MP4V_ENTRIES, STAT_NAMES),
           "h264": (H264_SOURCE, H264_ENTRIES, H264_STAT_NAMES),
           "hevc": (HEVC_SOURCE, HEVC_ENTRIES, HEVC_STAT_NAMES)}
_ERRLEN = 256


class UnsupportedVideoError(ValueError):
    """A valid file of a kind the port's codecs do not take: another sample
    entry (vp09, av01, ...), another edit list or display matrix; in mp4v
    B-VOPs, sprites, interlace, quarter-pel, data partitioning, video packets
    or the short video header; in H.264 SP/SI slices, fields/MBAFF, other
    chroma formats or bit depths, slice groups, redundant pictures, data
    partitioning, the transform bypass or a gap in frame_num; in HEVC B
    slices, leading pictures, WPP, tiles, dependent slice segments, long-term
    references, other profiles, bit depths or chroma formats."""


_LIBS: Dict[str, ctypes.CDLL] = {}


def _declare(lib: ctypes.CDLL, prefix: str) -> None:
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    for name, args, res in (("open", [s, p, s, i], p), ("read", [p, p, s, i], i),
                            ("stats", [p, p], i), ("close", [p], None)):
        fn = getattr(lib, f"{prefix}_{name}")
        fn.argtypes, fn.restype = args, res
    lib.mp4_sample_entry.argtypes = [s, s, s, i]
    lib.mp4_sample_entry.restype = i


def _lib(source: str = SOURCE) -> ctypes.CDLL:
    if source not in _LIBS:
        lib = _build.load(source)
        _declare(lib, next(k for k, v in _CODECS.items() if v[0] == source))
        if source == SOURCE:
            p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
            lib.mp4v_writer_open.argtypes = [s, i, i, i, i, p, s, i]
            lib.mp4v_writer_open.restype = p
            lib.mp4v_writer_write.argtypes = [p, p, s, i]
            lib.mp4v_writer_write.restype = i
            lib.mp4v_writer_close.argtypes = [p, s, i]
            lib.mp4v_writer_close.restype = i
        _LIBS[source] = lib
    return _LIBS[source]


def _raise(code: int, err: ctypes.Array, what: str) -> None:
    msg = f"{what}: {err.value.decode(errors='replace')}"
    raise (UnsupportedVideoError if code == -2 else ValueError)(msg)


def sample_entry(path: str) -> str:
    """The first video track's sample entry: "mp4v", "avc1", "hvc1", ..."""
    entry = ctypes.create_string_buffer(8)
    err = ctypes.create_string_buffer(_ERRLEN)
    code = _lib().mp4_sample_entry(path.encode(), entry, err, _ERRLEN)
    if code:
        _raise(code, err, path)
    return entry.value.decode(errors="replace")


class VideoReader:
    """An open mp4v, H.264 or HEVC file: ``frames``, ``fps``, ``width``,
    ``height`` (as displayed, after the display matrix's rotation); iterate
    for the decoded BGR frames, ``stats`` for what the stream used so far."""

    def __init__(self, path: str):
        self.path = path
        self._h = None
        entry = sample_entry(path)
        self.codec = next((k for k, v in _CODECS.items() if entry in v[1]), None)
        if self.codec is None:
            raise UnsupportedVideoError(
                f"{path}: sample entry {entry!r} (the port reads "
                f"{', '.join(e for v in _CODECS.values() for e in v[1])})")
        source, _, self._stat_names = _CODECS[self.codec]
        lib = _lib(source)
        prefix = self.codec
        self._read, self._stats_fn = getattr(lib, f"{prefix}_read"), getattr(lib, f"{prefix}_stats")
        # held here: at interpreter exit __del__ may run after the module's
        # globals are gone
        self._close = getattr(lib, f"{prefix}_close")
        info = np.zeros(5, np.int64)
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = getattr(lib, f"{prefix}_open")(path.encode(), info.ctypes.data, err, _ERRLEN)
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
        code = self._read(self._h, out.ctypes.data, err, _ERRLEN)
        if code < 0:
            _raise(code, err, self.path)
        return out if code == 1 else None

    @property
    def stats(self) -> Dict[str, int]:
        out = np.zeros(len(self._stat_names) + 2, np.int64)
        n = self._stats_fn(self._h, out.ctypes.data)
        return dict(zip(self._stat_names, (int(v) for v in out[:n])))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, None
            self._close(h)

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self.close()


def video_info(path: str) -> Tuple[int, float, int, int]:
    """(frames, fps, width, height), as cv2.VideoCapture's CAP_PROP_FRAME_COUNT,
    CAP_PROP_FPS, CAP_PROP_FRAME_WIDTH and CAP_PROP_FRAME_HEIGHT give them
    (the size after the display matrix's rotation)."""
    with VideoReader(path) as r:
        return r.frames, r.fps, r.width, r.height


def read_video(path: str) -> Iterator[np.ndarray]:
    """The frames of an mp4v, H.264 or HEVC file in order, each (H, W, 3)
    BGR uint8, as ``cap.read()`` returns them."""
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
