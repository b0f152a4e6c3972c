"""The port's H.265 / HEVC decoder (monohair_tpu_torch/io/video.py,
csrc/hevc.cpp over csrc/hevc.h) against OpenCV's FFmpeg on the CPU.

The opencv-python wheel's FFmpeg decodes HEVC but cannot write it, there is
no HEVC encoder at hand and no HEVC file in the repository, so the streams
come from the port's test-stream writer (io/hevc_streams.py). The writer
drives the decoder's own syntax code, so every stream is held against
cv2.VideoCapture, never against the port alone.

Held bitwise (max |diff| 0 on every frame, no tolerance needed: H.265 defines
every decoded sample in integers, and the BGR conversion is swscale's): each
named feature set of random Main-profile I/P syntax, two seeds each, at small
sizes with partial CTBs on the right and bottom edges and CTBs of 16, 32 and
64, with the frame count, fps and size that cv2 reports; the counters of
what the stream used show that the feature was exercised, and every counter
is exercised by some set. Where FFmpeg departs from the standard (SAO beside
deferred deblocking, the chroma of transquant-bypass blocks under SAO, the
deblocking offsets it carries from CTB to CTB, its output order), the
decoder takes FFmpeg's way, and the sets that reach those paths hold it. The
writer's frames mode round-trips frames at >= 30 dB. hvc1 and hev1 both
decode; a portrait display matrix rotates the frames as cv2 rotates them.
Every refused feature raises UnsupportedVideoError naming it."""

import pytest

from monohair_tpu_torch.io.hevc_streams import write_frames, write_random
from monohair_tpu_torch.io.video import (HEVC_STAT_NAMES, UnsupportedVideoError, VideoReader,
                                         read_video, video_info)
from tests.test_torch_mp4v import assert_same_frames, cv2_read, psnr, smooth_frames

SIZE = (72, 40)   # 8 and 16 short of whole CTBs of 16, 32 and 64 on each edge
FRAMES = 8

# name: (writer features, frame size, the counters that must be non-zero)
FEATURE_SETS = {
    "intra_ctb16": (dict(intra_only=1, ctb=16, pcm=0, bypass=0), SIZE,
                    ("idr_pictures", "i_slices", "intra_cus", "intra_nxn_cus", "dst_blocks",
                     "partial_ctbs", "ctb16_pictures")),
    "intra_tools_ctb32": (dict(intra_only=1, ctb=32, max_tb=32, pcm=1, pcm_share=0.15, bypass=1,
                               transform_skip=1, sign_hiding=1, strong=1, cu_qp_delta=1,
                               scaling=1, sao=0), (96, 64),
                          ("ctb32_pictures", "pcm_cus", "bypass_cus", "transform_skip_blocks",
                           "sign_hidden_groups", "qp_delta_cus", "scaling_list_slices",
                           "transform32_blocks", "strong_smoothing_blocks")),
    "p_merge_amvp_tmvp_ctb64": (dict(ctb=64, refs=3, tmvp=1, amp=0), (136, 72),
                                ("ctb64_pictures", "p_slices", "skip_cus", "merge_pus",
                                 "amvp_pus", "small_pus", "tmvp_slices", "tmvp_candidates",
                                 "partial_ctbs")),
    "p_amp_weighted": (dict(ctb=32, amp=1, weighted=1, refs=2), SIZE,
                       ("amp_cus", "weighted_slices", "p_slices")),
    "inter_nxn_cb16": (dict(ctb=32, min_cb=16, refs=2), (96, 48), ("inter_nxn_cus",)),
    "reordered_pocs": (dict(group=4, refs=4, nonref=0.3, poc_bits=5, sps_rps=3,
                            inter_rps_share=1), SIZE,
                       ("trail_n_pictures", "inter_rps_slices", "repeated_ref_slices")),
    "sps_rps": (dict(group=1, refs=1, nonref=0, sps_rps=2), SIZE, ("sps_rps_slices",)),
    "slices_deblock_sao": (dict(slices=4, deblock=1, deblock_off_share=0.5, sao=1, lf_across=1,
                                ctb=16), SIZE,
                           ("multi_slice_pictures", "deblocked_slices", "deblock_disabled_slices",
                            "lf_not_across_slices", "sao_band_ctbs", "sao_edge_ctbs",
                            "sao_merged_ctbs")),
    "cra_output_flag": (dict(gop=3, cra=1, output_flag=1, hidden_share=0.5, refs=2), SIZE,
                        ("cra_pictures", "hidden_pictures")),
    # an IDR whose no_output_of_prior_pics_flag drops the pictures still waiting
    "idr_no_output_prior": (dict(gop=3, group=3, no_output_prior=1, idr_n_lp=1, refs=2), SIZE,
                            ("discarded_pictures", "idr_pictures")),
    "list_mod_cabac_init": (dict(list_mod=1, mod_share=1, cabac_init=1, chroma_offsets=1,
                                 refs=4, group=2),
                            SIZE, ("ref_list_modified_slices", "cabac_init_slices",
                                   "chroma_offset_slices")),
    "constrained_intra": (dict(constrained_intra=1, refs=2, min_cb=8), SIZE,
                          ("constrained_intra_slices", "p_slices")),
    "cra_first_hev1": (dict(cra=3, gop=4, hev1=1), SIZE, ("cra_pictures",)),
    "inband_qt_len2_crop": (dict(inband=1, quicktime=1, length_size=2, crop_top=1, gop=4,
                                 hrd=1), SIZE,
                            ("idr_pictures",)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_decode_equals_cv2_bitwise(name, seed, tmp_path):
    features, size, used = FEATURE_SETS[name]
    path = str(tmp_path / f"{name}.mp4")
    write_random(path, size, FRAMES, seed=seed, **features)
    want, props = cv2_read(path)
    assert props == (FRAMES, 30.0, *size)
    assert video_info(path) == props
    with VideoReader(path) as reader:
        assert reader.codec == "hevc"
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    for key in used:
        assert stats[key] > 0, (key, stats)
    data = open(path, "rb").read()
    if name == "cra_first_hev1":
        assert data.count(b"hev1") == 1 and data.count(b"hvc1") == 0
    if name == "inband_qt_len2_crop":
        assert data[8:12] == b"qt  " and data.count(b"hvc1") == 1


def test_every_counter_is_held_against_cv2():
    """The decoder claims no tool that no feature set exercises."""
    held = {key for _, _, used in FEATURE_SETS.values() for key in used}
    assert held == set(HEVC_STAT_NAMES), set(HEVC_STAT_NAMES) - held


@pytest.mark.parametrize("ctb", [16, 64])
def test_frames_mode_round_trip(ctb, tmp_path):
    frames = smooth_frames(72, 136, 6)
    path = str(tmp_path / f"frames_{ctb}.mp4")
    write_frames(path, frames, fps=24, qp=24, ctb=ctb)
    want, props = cv2_read(path)
    assert props == (len(frames), 24.0, 136, 72)
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    assert stats["skip_cus"] + stats["merge_pus"] > 0 and stats["p_slices"] > 0
    assert min(psnr(a, b) for a, b in zip(got, frames)) >= 30.0


@pytest.mark.parametrize("entry", ["hvc1", "hev1"])
def test_hvc1_and_hev1_decode(entry, tmp_path):
    path = str(tmp_path / f"{entry}.mp4")
    write_frames(path, smooth_frames(48, 64, 5), fps=30, qp=22, ctb=32, hev1=int(entry == "hev1"))
    assert open(path, "rb").read().count(entry.encode()) == 1
    want, props = cv2_read(path)
    assert video_info(path) == props == (5, 30.0, 64, 48)
    assert_same_frames(list(read_video(path)), want)


@pytest.mark.parametrize("degrees", [90, 270])
def test_portrait_display_matrix_rotates_as_cv2(degrees, tmp_path):
    path = str(tmp_path / "portrait.mp4")
    write_random(path, (64, 48), 4, seed=degrees, rotation=degrees)
    want, props = cv2_read(path)
    assert props[2:] == (48, 64) and video_info(path) == props
    got = list(read_video(path))
    assert got[0].shape == (64, 48, 3)
    assert_same_frames(got, want)


@pytest.mark.parametrize("colour", [dict(full_range=1), dict(matrix=1),
                                    dict(matrix=6, full_range=1)])
def test_signalled_colour_converts_as_cv2(colour, tmp_path):
    path = str(tmp_path / "colour.mp4")
    write_random(path, (64, 48), 3, seed=7, **colour)
    want, _ = cv2_read(path)
    assert_same_frames(list(read_video(path)), want)


REFUSED = {
    # name: (writer features, the words the error names)
    "b_slices": (dict(refuse="b_slice"), "B slices"),
    "leading_pictures": (dict(refuse="leading"), "RASL/RADL leading pictures"),
    "wpp": (dict(refuse="wpp"), "entropy_coding_sync_enabled_flag"),
    "tiles": (dict(refuse="tiles"), "tiles"),
    "dependent_slices": (dict(refuse="dependent_slice", slices=3), "dependent slice segments"),
    "long_term_refs": (dict(refuse="long_term"), "long-term reference pictures"),
    "main10_profile": (dict(refuse="main10"), "Main 10"),
    "rext_profile": (dict(refuse="rext"), "profiles other than Main"),
    "bit_depth10": (dict(refuse="bit_depth10"), "bit depth 10"),
    "chroma422": (dict(refuse="chroma422"), "chroma_format_idc 2"),
    "missing_reference": (dict(refuse="missing_ref"), "missing reference picture"),
    "left_crop": (dict(crop_left=2), "conf_win_left_offset"),
    "bt2020_primaries": (dict(matrix=1, primaries=9, transfer=1), "colour_primaries 9"),
    "pq_transfer": (dict(matrix=1, primaries=1, transfer=16), "transfer_characteristics 16"),
    "hlg_transfer": (dict(matrix=1, primaries=1, transfer=18), "transfer_characteristics 18"),
    "gbr_matrix": (dict(matrix=0, primaries=1, transfer=1), "matrix_coefficients 0"),
    "ycgco_matrix": (dict(matrix=8, primaries=1, transfer=1), "matrix_coefficients 8"),
    "bt2020_matrix": (dict(matrix=9, primaries=1, transfer=1), "matrix_coefficients 9"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_features_raise_by_name(name, tmp_path):
    features, words = REFUSED[name]
    path = str(tmp_path / f"{name}.mp4")
    size = (56, 40) if name == "left_crop" else (64, 48)
    write_random(path, size, 4, seed=1, refs=2, **features)
    with pytest.raises(UnsupportedVideoError, match=words):
        list(read_video(path))


def test_an_unknown_sample_entry_is_refused_by_name(tmp_path):
    """No sample entry falls through to the mp4v decoder: one that no codec
    takes is refused naming it and the entries the port reads."""
    path = str(tmp_path / "v.mp4")
    write_random(path, (32, 32), 2, seed=0)
    data = open(path, "rb").read()
    bad = tmp_path / "vp09.mp4"
    bad.write_bytes(data.replace(b"hvc1", b"vp09"))
    with pytest.raises(UnsupportedVideoError, match=r"'vp09'.*mp4v, avc1, avc3, hvc1, hev1"):
        VideoReader(str(bad))


@pytest.mark.parametrize("rotation", [0, 90])
def test_extract_sharpest_frames_keeps_the_jax_frames(rotation, tmp_path):
    """On an HEVC file, the port keeps the frames the JAX package's
    extract_sharpest_frames keeps (cv2.VideoCapture there), with the same
    pixels; with a portrait display matrix both keep portrait frames."""
    import cv2
    import numpy as np

    from monohair_tpu.video import extract_sharpest_frames as jax_extract
    from monohair_tpu_torch.video import extract_sharpest_frames
    from tests.test_torch_video import sharp_and_blurred

    video = str(tmp_path / "v.mp4")
    write_frames(video, sharp_and_blurred(13), fps=30, qp=20, ctb=16, rotation=rotation)
    want = jax_extract(video, str(tmp_path / "jax"), interval=5)
    got = extract_sharpest_frames(video, str(tmp_path / "port"), interval=5, device="cpu")
    assert got == want and len(got) == 2
    shape = (64, 48, 3) if rotation else (48, 64, 3)
    for name in got:
        a, b = (cv2.imread(str(tmp_path / d / name)) for d in ("port", "jax"))
        assert a.shape == shape and np.array_equal(a, b), name
    # the sharp frame of the second window: frame 6
    assert np.array_equal(cv2.imread(str(tmp_path / "port" / got[1])), list(read_video(video))[6])


@pytest.mark.parametrize("header", ["hevc.h", "hevc_tables.h", "bits.h", "mp4.h"])
def test_build_digest_covers_the_headers_hevc_includes(header, tmp_path, monkeypatch):
    """A changed header that hevc.cpp includes gives another library name, so
    a stale build is not served."""
    import shutil
    import subprocess

    from monohair_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("*.cu"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: calls.append(cmd) or
                        open(cmd[cmd.index("-o") + 1], "wb").close() or
                        subprocess.CompletedProcess(cmd, 0, "", ""))
    monkeypatch.setattr(_build, "native_target", lambda: "-mtest")
    first = {s: _build.build(s) for s in ("hevc.cpp", "hevc_writer.cpp")}
    assert len(calls) == 2 and all(_build.build(s) == p for s, p in first.items())
    with open(csrc / header, "a") as f:
        f.write("\n// changed\n")
    assert all(_build.build(s) != p for s, p in first.items()) and len(calls) == 4
