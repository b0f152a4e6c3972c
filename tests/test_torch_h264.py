"""The port's H.264 decoder (monohair_tpu_torch/io/video.py, csrc/h264.cpp)
against OpenCV's FFmpeg on the CPU.

The opencv-python wheel's FFmpeg decodes H.264 but has no H.264 encoder, and
no H.264 file is in the repository, so the streams come from the port's
test-stream writer
(io/h264_streams.py). The writer drives the decoder's own syntax code, so
every stream is held against cv2.VideoCapture, never against the port alone.

Held bitwise (max |diff| 0 on every frame, no tolerance needed: H.264 defines
every decoded sample in integers, and the BGR conversion is swscale's): each
named feature set of random syntax, two seeds each, with the frame count,
fps and size that cv2 reports; the counters of what the stream used show
that the feature was exercised. The writer's frames mode round-trips
frames at >= 30 dB and decodes to cv2's frames. The VUI's full range and
BT.709 matrix convert as cv2 converts them. Every refused feature raises
UnsupportedVideoError naming it. The build digest covers the headers the
sources include, and a reader left open at interpreter exit closes quietly."""

import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

from monohair_tpu_torch.io.h264_streams import write_frames, write_random
from monohair_tpu_torch.io.video import (UnsupportedVideoError, VideoReader, read_video,
                                         video_info)
from monohair_tpu_torch.ops import _build
from tests.test_torch_mp4v import assert_same_frames, cv2_read, psnr, smooth_frames

SIZE = (96, 64)
FRAMES = 10

# name: (writer features, frame size, the counters that must be non-zero)
FEATURE_SETS = {
    "cavlc_intra": (dict(intra_only=1, cabac=0, pcm=0.05), SIZE,
                    ("intra4x4_mbs", "intra16x16_mbs", "pcm_mbs")),
    "cabac_intra": (dict(intra_only=1, cabac=1, pcm=0.05), SIZE,
                    ("intra4x4_mbs", "intra16x16_mbs", "pcm_mbs", "cabac_slices")),
    "cavlc_p": (dict(cabac=0, refs=3, gop=4, poc_type=2, nonref=0.3), SIZE,
                ("p_slices", "inter_mbs", "skip_mbs", "sub8x8_mbs", "ref_list_modified_slices")),
    "cabac_p": (dict(cabac=1, refs=3, gop=4, poc_type=1, nonref=0.3, reorder=1, hrd=1), SIZE,
                ("p_slices", "inter_mbs", "skip_mbs", "sub8x8_mbs", "cabac_slices",
                 "ref_list_modified_slices")),
    "8x8_scaling": (dict(t8=1, refs=2), SIZE,
                    ("intra8x8_mbs", "transform8x8_mbs", "scaling_list_slices")),
    "multi_slice_deblock_idc2": (dict(slices=4, deblock=1, refs=2, constrained_intra=1), SIZE,
                                 ("deblocked_slices", "slice_edge_unfiltered_slices",
                                  "p_slices")),
    "long_term_mmco": (dict(mmco=1, refs=4, gop=0), SIZE, ("mmcos", "long_term_refs")),
    "weighted": (dict(weighted=1, refs=3), SIZE, ("weighted_slices",)),
    "cropped_odd_size": (dict(refs=2, length_size=2, crop_top=1), (72, 40), ("p_slices",)),
    "in_band_avc3": (dict(avc3=1, idr_period=4, refs=2), SIZE, ("idr_pictures",)),
    # an iPhone's .MOV: avc1 whose parameter sets also repeat before each IDR
    "quicktime_brand": (dict(quicktime=1, refs=2, inband=1, idr_period=5, edit=0), SIZE,
                        ("p_slices", "idr_pictures")),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_decode_equals_cv2_bitwise(name, seed, tmp_path):
    features, size, used = FEATURE_SETS[name]
    features = dict(features)
    features.setdefault("cabac", seed)  # both entropy coders where the set names neither
    if name == "long_term_mmco":
        features["poc_type"] = seed * 2
    if name == "8x8_scaling":  # lists in SPS and PPS (fall-back rule B), in the PPS alone (A)
        features["scaling"] = 3 - seed
    path = str(tmp_path / f"{name}.mp4")
    write_random(path, size, FRAMES, seed=seed, **features)
    want, props = cv2_read(path)
    assert props == (FRAMES, 30.0, *size)
    assert video_info(path) == props
    with VideoReader(path) as reader:
        assert reader.codec == "h264"
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    for key in used:
        assert stats[key] > 0, (key, stats)
    if name == "in_band_avc3":
        assert open(path, "rb").read().count(b"avc3") == 1 and stats["idr_pictures"] == 3
    if name == "quicktime_brand":  # with FFmpeg's identity edit list
        data = open(path, "rb").read()
        assert data[8:12] == b"qt  " and data.count(b"elst") == 1
    if name == "multi_slice_deblock_idc2":
        assert stats["i_slices"] + stats["p_slices"] > FRAMES
        assert stats["deblocked_slices"] < stats["i_slices"] + stats["p_slices"]  # idc 1 too


def test_one_byte_nal_lengths(tmp_path):
    """lengthSizeMinusOne 0: every NAL unit of a small stream under 256 bytes."""
    path = str(tmp_path / "short.mp4")
    write_random(path, (32, 16), 4, seed=3, length_size=1, intra_only=1, pcm=0)
    assert open(path, "rb").read().count(b"avcC") == 1
    want, _ = cv2_read(path)
    assert_same_frames(list(read_video(path)), want)


def test_first_video_track_after_an_audio_track(tmp_path):
    """A phone's file may list its audio track first: the video track is
    still the one decoded, as cv2 decodes it."""
    from tests.test_torch_mp4v import _boxes, _bytes
    path = str(tmp_path / "v.mp4")
    write_random(path, (64, 48), 4, seed=2, cabac=1)
    boxes = _boxes(open(path, "rb").read())
    moov = next(b for b in boxes if b[0] == "moov")
    trak = next(b for b in moov[1] if b[0] == "trak")
    audio = [["tkhd", bytes(84), False],
             ["mdia", [["mdhd", bytes(24), False],
                       ["hdlr", bytes(8) + b"soun" + bytes(13), False]], False]]
    moov[1].insert(moov[1].index(trak), ["trak", audio, False])
    # the chunk offset moves by the audio track's size
    grown = _bytes([["trak", audio, False]])
    stco = [b for b in trak[1][1][1][2][1][2][1] if b[0] == "stco"][0]
    off = int.from_bytes(stco[1][8:12], "big") + len(grown)
    stco[1] = stco[1][:8] + off.to_bytes(4, "big")
    mdat_first = [b[0] for b in boxes].index("mdat") < [b[0] for b in boxes].index("moov")
    if mdat_first:  # moov after mdat: the samples do not move
        stco[1] = stco[1][:8] + (off - len(grown)).to_bytes(4, "big")
    open(path, "wb").write(_bytes(boxes))
    want, props = cv2_read(path)
    assert len(want) == 4 and video_info(path) == props
    assert_same_frames(list(read_video(path)), want)


def test_frames_mode_round_trip(tmp_path):
    frames = smooth_frames(72, 128, 8)
    for cabac in (False, True):
        path = str(tmp_path / f"frames_{int(cabac)}.mp4")
        write_frames(path, frames, fps=24, qp=24, gop=3, cabac=cabac)
        want, props = cv2_read(path)
        assert props == (len(frames), 24.0, 128, 72)
        with VideoReader(path) as reader:
            got = list(reader)
            stats = reader.stats
        assert_same_frames(got, want)
        assert stats["skip_mbs"] > 0 and stats["inter_mbs"] > 0
        assert min(psnr(a, b) for a, b in zip(got, frames)) >= 30.0


@pytest.mark.parametrize("colour", [dict(full_range=1), dict(matrix=1),
                                    dict(matrix=1, full_range=1), dict(matrix=6, full_range=1)])
def test_signalled_colour_converts_as_cv2(colour, tmp_path):
    path = str(tmp_path / "colour.mp4")
    write_random(path, (64, 48), 3, seed=7, **colour)
    want, _ = cv2_read(path)
    assert_same_frames(list(read_video(path)), want)


def _patch_matrix(path, matrix):
    data = bytearray(open(path, "rb").read())
    tkhd = data.index(b"tkhd") + 4
    off = tkhd + (52 if data[tkhd] == 1 else 40)
    data[off:off + 36] = b"".join(int(v).to_bytes(4, "big", signed=True) for v in matrix)
    open(path, "wb").write(bytes(data))


REFUSED = {
    # name: (writer features, the words the error names)
    "b_slice": (dict(refuse="b_slice"), "B slices"),
    "sp_slice": (dict(refuse="sp_slice"), "SP slices"),
    "si_slice": (dict(refuse="si_slice"), "SI slices"),
    "redundant": (dict(refuse="redundant"), "redundant pictures"),
    "partitioning": (dict(refuse="partitioning"), "data partitioning"),
    "chroma422": (dict(refuse="chroma422"), "chroma_format_idc 2"),
    "bit_depth10": (dict(refuse="bit_depth10"), "bit depth 10"),
    "transform_bypass": (dict(refuse="transform_bypass"), "transform_bypass"),
    "fields": (dict(refuse="fields"), "frame_mbs_only_flag 0"),
    "slice_groups": (dict(refuse="slice_groups"), "slice groups"),
    "frame_num_gap": (dict(refuse="frame_num_gap"), "gap in frame_num"),
    "edit_list": (dict(edit=1), "edit list"),
    "left_crop": (dict(crop_left=2), "frame_crop_left_offset"),
    "bt2020_primaries": (dict(matrix=1, primaries=9, transfer=1), "colour_primaries 9"),
    "pq_transfer": (dict(matrix=1, primaries=1, transfer=16), "transfer_characteristics 16"),
    "gbr_matrix": (dict(matrix=0, primaries=1, transfer=1), "matrix_coefficients 0"),
    "rotation_45": (dict(), "not a rotation by a multiple of 90 degrees"),
    "mirror": (dict(), "mirrors"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_features_raise_by_name(name, tmp_path):
    features, words = REFUSED[name]
    path = str(tmp_path / f"{name}.mp4")
    size = (56, 40) if name == "left_crop" else (64, 48)
    write_random(path, size, 4, seed=1, refs=2, gop=0, **features)
    if name == "rotation_45":
        _patch_matrix(path, [46341, 46341, 0, -46341, 46341, 0, 0, 0, 1 << 30])
    if name == "mirror":
        _patch_matrix(path, [-65536, 0, 0, 0, 65536, 0, 0, 0, 1 << 30])
    with pytest.raises(UnsupportedVideoError, match=words):
        list(read_video(path))


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """A changed header gives another library name, so a stale build is not
    served; the header's own bytes are hashed, not its time stamp."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("*.cu"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: calls.append(cmd) or
                        open(cmd[cmd.index("-o") + 1], "wb").close() or
                        subprocess.CompletedProcess(cmd, 0, "", ""))
    monkeypatch.setattr(_build, "native_target", lambda: "-mtest")
    first = _build.build("h264.cpp")
    assert _build.build("h264.cpp") == first and len(calls) == 1
    with open(csrc / "mp4.h", "a") as f:
        f.write("\n// changed\n")
    second = _build.build("h264.cpp")
    assert second != first and len(calls) == 2


def test_reader_left_open_at_exit_closes_quietly(tmp_path):
    path = str(tmp_path / "open.mp4")
    write_random(path, (32, 32), 2, seed=0)
    code = ("from monohair_tpu_torch.io.video import VideoReader\n"
            f"r = VideoReader({path!r})\nr.read()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "Exception ignored" not in proc.stderr and "TypeError" not in proc.stderr, proc.stderr
