"""The port's H.265 / HEVC decoder (monohair_tpu_torch/io/video.py,
csrc/hevc.cpp over csrc/hevc.h) against OpenCV's FFmpeg on the CPU.

The opencv-python wheel's FFmpeg decodes HEVC but cannot write it, there is
no HEVC encoder at hand and no HEVC file in the repository, so the streams
come from the port's test-stream writer (io/hevc_streams.py). The writer
drives the decoder's own syntax code, so every stream is held against
cv2.VideoCapture, never against the port alone.

Held bitwise (max |diff| 0 on every frame, no tolerance needed: H.265 defines
every decoded sample in integers, and the BGR conversion is swscale's, its
unscaled yuv2rgb at 8 bits and its general scaler at 9 and 10): each
named feature set of random Main and Main 10 I/P/B syntax (8, 9 and 10
bits), two seeds each, at small
sizes with partial CTBs on the right and bottom edges and CTBs of 16, 32 and
64, with the frame count, fps and size that cv2 reports; the counters of
what the stream used show that the feature was exercised, and every counter
is exercised by some set. The parallel tools are among the sets: WPP on
pictures one and two CTBs wide and with slices, dependent slice segments and
B slices; uniform and explicit tiles (tiles one CTB wide among them), with
and without loop filtering across their edges; every substream of every
stream starts where its entry points say (cv2's FFmpeg finds the substreams
without them, so the decoder counts each that does not, and a stream whose
writer was told to get one wrong shows it). Where FFmpeg departs from the
standard (SAO beside deferred deblocking, the chroma of transquant-bypass
blocks under SAO, the deblocking offsets it carries from CTB to CTB, the
filters' order in tile scan, its output order, the RASL pictures it skips),
the decoder takes FFmpeg's way, and the sets that reach those paths hold it.
The writer's frames mode round-trips frames at >= 30 dB, I/P and I/P/B (B
pyramids, open and closed GOPs), Main 10 I/P/B, with WPP as x265 writes it
by default, and with tiles and dependent slice segments. hvc1 and hev1 both
decode; a wrong bit depth in hvcC is counted (FFmpeg reads the SPS's); a
portrait display matrix rotates the frames as cv2 rotates them; the
signalled colour converts as cv2 converts it at 8 and 10 bits. Every
refused feature raises UnsupportedVideoError naming it (mixed bit depths,
12 bits, BT.2020 and the HDR transfers among them)."""

import numpy as np
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
    # B slices: both lists, bi-prediction, the combined bi-predictive merge candidates
    "b_merge_amvp": (dict(bslices=1, refs=3, group=3), SIZE,
                     ("b_slices", "bipred_pus", "l1_pus", "combined_merge_cands", "merge_pus",
                      "amvp_pus")),
    # mvd_l1_zero_flag, and 8x4/4x8 units that keep list 0 of a bi-predicted candidate
    "b_mvd_l1_zero_small_pus": (dict(bslices=1, mvd_l1_zero=1, refs=2, group=2, min_cb=8), SIZE,
                                ("mvd_l1_zero_pus", "small_pus", "bipred_pus")),
    # TMVP from a collocated picture in list 1, collocated blocks predicted from both lists
    "b_tmvp_col_l1": (dict(bslices=1, tmvp=1, col_l1=1, group=3, refs=2), (136, 72),
                      ("col_l1_slices", "bi_col_blocks", "tmvp_candidates")),
    "b_weighted_bipred": (dict(bslices=1, weighted_bipred=1, refs=3, group=2), SIZE,
                          ("weighted_bipred_slices", "bipred_pus")),
    # mid-stream CRAs (open GOPs) with RASL pictures naming pictures before them
    "open_gop_rasl": (dict(cra=1, gop=2, leading=3, bslices=0.5, refs=3), SIZE,
                      ("cra_pictures", "rasl_pictures")),
    "idr_w_radl": (dict(gop=3, leading=3, bslices=0.5, refs=2), SIZE,
                   ("radl_pictures", "idr_pictures")),
    # a stream that starts with a CRA: FFmpeg neither decodes nor outputs its RASL pictures
    "cra_first_skipped_rasl": (dict(cra=3, leading=3, gop=4, bslices=0.5, refs=3), SIZE,
                               ("skipped_rasl_pictures", "cra_pictures")),
    # WPP on a picture one CTB wide: no CTB above and right, each row starts afresh
    "wpp_one_ctb_wide": (dict(wpp=1, ctb=32, refs=2, sao=1, deblock=1), (24, 136),
                         ("wpp_pictures", "wpp_initialised_rows", "entry_points")),
    # two CTBs wide: each row takes the contexts stored after the row above's last CTB
    "wpp_two_ctbs_wide": (dict(wpp=1, ctb=16, refs=2, cu_qp_delta=1), (32, 72),
                          ("wpp_pictures", "wpp_synced_rows", "entry_points", "qp_delta_cus")),
    "wpp_slices_dependent_b": (dict(wpp=1, ctb=16, slices=8, dependent=0.6, bslices=0.6, group=3,
                                    refs=3, sao=1, deblock=1), (136, 72),
                               ("wpp_synced_rows", "wpp_initialised_rows", "multi_slice_pictures",
                                "dependent_slice_segments", "dependent_restores", "b_slices")),
    "tiles_uniform_no_lf_ctb16": (dict(tiles=1, tile_cols=3, tile_rows=2, uniform=1,
                                       lf_across_tiles=0, sao=1, deblock=1, ctb=16, refs=2),
                                  (136, 72),
                                  ("tile_pictures", "tiles", "tile_edges_unfiltered",
                                   "sao_edge_ctbs", "sao_band_ctbs", "deblocked_slices")),
    # explicit sizes on a picture of 5 x 3 CTBs: columns and rows one CTB wide
    "tiles_explicit_dependent": (dict(tiles=1, tile_cols=4, tile_rows=3, uniform=0, slices=8,
                                      dependent=0.6, ctb=16, refs=2), SIZE,
                                 ("tiles", "dependent_slice_segments", "dependent_restores",
                                  "entry_points")),
    # PCM samples near 0 put emulation_prevention_three_bytes inside the
    # substreams, which the entry points count
    "wpp_pcm_escapes": (dict(wpp=1, ctb=16, intra_only=1, pcm=1, pcm_share=1), SIZE,
                        ("wpp_pictures", "pcm_cus", "entry_points")),
    "tiles_slices_qp_b": (dict(tiles=1, lf_across_tiles=1, slices=6, bslices=0.6, cu_qp_delta=1,
                               group=2, refs=2, sao=1, deblock=1, ctb=32), (136, 72),
                          ("tile_pictures", "multi_slice_pictures", "qp_delta_cus", "b_slices")),
    # Main 10: intra with PCM at 8 bits (shifted up) and at 10, transform skip,
    # transquant bypass, strong smoothing, scaling lists and cu_qp_delta
    # taking QpY below 0
    "main10_intra_pcm8": (dict(bit_depth=10, intra_only=1, ctb=32, max_tb=32, pcm=1, pcm_bd=8,
                               pcm_share=0.15, bypass=1, transform_skip=1, strong=1, cu_qp_delta=1,
                               scaling=1, sao=0), (96, 64),
                          ("pictures_10bit", "pcm_cus", "pcm_upshifted_cus", "bypass_cus",
                           "transform_skip_blocks", "strong_smoothing_blocks",
                           "scaling_list_slices", "qp_delta_cus", "negative_qp_cus")),
    "main10_intra_pcm10": (dict(bit_depth=10, intra_only=1, ctb=32, max_tb=32, pcm=1, pcm_bd=10,
                                pcm_share=0.15, bypass=1, transform_skip=1, strong=1,
                                cu_qp_delta=1, scaling=1, sao=0), (96, 64),
                           ("pictures_10bit", "pcm_cus", "bypass_cus", "transform_skip_blocks",
                            "strong_smoothing_blocks", "negative_qp_cus")),
    # 32x32 intra blocks beside PCM blocks that sample one gently curved
    # surface: strong smoothing's threshold, 1 << (bitDepth - 5)
    "main10_strong_smoothing": (dict(bit_depth=10, intra_only=1, ctb=64, min_cb=16, max_tb=32,
                                     pcm=1, pcm_bd=10, pcm_share=0.5, strong=1, bypass=0, sao=0,
                                     deblock=0, transform_skip=0), (128, 96),
                                ("pictures_10bit", "strong_smoothing_blocks", "pcm_cus")),
    # explicit weights with offsets over their whole range, AMP
    "main10_p_weighted_amp": (dict(bit_depth=10, ctb=32, amp=1, weighted=1, refs=2), SIZE,
                              ("pictures_10bit", "weighted_slices", "amp_cus", "p_slices")),
    # I/P/B with WPP, SAO band and edge offsets above 7, deblocking with offsets
    "main10_ipb_wpp_sao_deblock": (dict(bit_depth=10, wpp=1, bslices=0.6, group=3, refs=3, sao=1,
                                        deblock=1, ctb=16), (136, 72),
                                   ("pictures_10bit", "wpp_pictures", "b_slices", "bipred_pus",
                                    "sao_band_ctbs", "sao_edge_ctbs", "sao_offsets_above_7",
                                    "deblocked_slices", "negative_qp_cus")),
    "main10_b_weighted_bipred_tmvp": (dict(bit_depth=10, bslices=1, weighted_bipred=1, tmvp=1,
                                           col_l1=1, refs=3, group=3), SIZE,
                                      ("pictures_10bit", "weighted_bipred_slices", "bipred_pus",
                                       "tmvp_candidates")),
    "main9": (dict(bit_depth=9, bslices=0.5, group=2, refs=2, sao=1, deblock=1, pcm=1,
                   cu_qp_delta=1, weighted=1), SIZE,
              ("pictures_9bit", "sao_offsets_above_7", "negative_qp_cus", "qp_delta_cus")),
    # an iPhone's HDR recording: Main 10, BT.2020 matrix and primaries, HLG
    # named by the alternative transfer characteristics SEI over the VUI's
    # BT.2020 transfer, Dolby Vision 8.4's RPU units and dvvC box
    "hlg_bt2020_main10_dolby": (dict(bit_depth=10, matrix=9, primaries=9, transfer=14, atc_sei=18,
                                     dv_rpu=1, dvcc=8, bslices=0.5, group=2, refs=2, sao=1,
                                     deblock=1), SIZE,
                                ("colour_managed_pictures", "alternative_transfer_seis",
                                 "dolby_vision_rpus", "pictures_10bit", "b_slices")),
    "hlg_bt709_8bit": (dict(matrix=1, primaries=1, transfer=18, full_range=1, refs=2, pcm=1),
                       SIZE, ("colour_managed_pictures",)),
}
# counters that every stream holds at 0
ZERO_COUNTERS = ("entry_point_mismatches", "hvcc_bit_depth_mismatches")


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
    for key in ZERO_COUNTERS:
        assert stats[key] == 0, (key, stats)
    if name == "cra_first_skipped_rasl":  # cv2 counts the samples, not the frames it returns
        assert len(got) <= FRAMES - stats["skipped_rasl_pictures"]
    data = open(path, "rb").read()
    if name == "cra_first_hev1":
        assert data.count(b"hev1") == 1 and data.count(b"hvc1") == 0
    if name == "inband_qt_len2_crop":
        assert data[8:12] == b"qt  " and data.count(b"hvc1") == 1


def test_every_counter_is_held_against_cv2():
    """The decoder claims no tool that no feature set exercises (or holds at 0)."""
    held = {key for _, _, used in FEATURE_SETS.values() for key in used} | set(ZERO_COUNTERS)
    assert held == set(HEVC_STAT_NAMES), set(HEVC_STAT_NAMES) - held


@pytest.mark.parametrize("ctb, extra", [(16, {}), (64, {}),
                                       (64, dict(bit_depth=10, bframes=4, pyramid=1, refs=3))],
                         ids=["16", "64", "main10_ipb"])
def test_frames_mode_round_trip(ctb, extra, tmp_path):
    """I/P, and Main 10 I/P/B (the source frames scaled up to 10 bits with
    detail in the lowest bit)."""
    frames = smooth_frames(72, 136, 6)
    path = str(tmp_path / f"frames_{ctb}.mp4")
    write_frames(path, frames, fps=24, qp=24, ctb=ctb, **extra)
    want, props = cv2_read(path)
    assert props == (len(frames), 24.0, 136, 72)
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    assert stats["skip_cus"] + stats["merge_pus"] > 0 and stats["p_slices"] > 0
    if extra:
        assert stats["pictures_10bit"] == len(frames) and stats["b_slices"] > 0
    assert min(psnr(a, b) for a, b in zip(got, frames)) >= 30.0


@pytest.mark.parametrize("gop", ["open", "closed"])
def test_frames_mode_ipb_round_trip(gop, tmp_path):
    """B pictures as x265 writes them by default (4 between anchors, a B
    pyramid, 3 references), every 6 frames a CRA whose B pictures are RASL
    (open GOP) or an IDR_W_RADL whose B pictures are RADL (closed)."""
    frames = smooth_frames(72, 136, 14)
    path = str(tmp_path / f"ipb_{gop}.mp4")
    write_frames(path, frames, fps=24, qp=24, ctb=64, bframes=4, pyramid=1, refs=3, gop=6,
                 cra=int(gop == "open"))
    want, props = cv2_read(path)
    assert props == (len(frames), 24.0, 136, 72) and video_info(path) == props
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    leading = "rasl_pictures" if gop == "open" else "radl_pictures"
    for key in ("b_slices", "bipred_pus", "p_slices", leading, "ctb64_pictures"):
        assert stats[key] > 0, (key, stats)
    assert min(psnr(a, b) for a, b in zip(got, frames)) >= 30.0


PARALLEL_FRAMES = {
    # x265's defaults: WPP, 4 B pictures between anchors, a B pyramid, 3 references
    "wpp_ipb": (dict(wpp=1, bframes=4, pyramid=1, refs=3, gop=8, cra=1, ctb=32),
                ("wpp_pictures", "wpp_synced_rows", "b_slices", "entry_points")),
    "tiles_dependent": (dict(tiles=1, tile_cols=3, tile_rows=2, lf_across_tiles=0, slices=10,
                             dependent=0.5, ctb=16),
                        ("tile_pictures", "tile_edges_unfiltered", "dependent_slice_segments",
                         "entry_points")),
}


@pytest.mark.parametrize("name", sorted(PARALLEL_FRAMES))
def test_frames_mode_parallel_tools_round_trip(name, tmp_path):
    features, used = PARALLEL_FRAMES[name]
    frames = smooth_frames(72, 136, 10)
    path = str(tmp_path / f"{name}.mp4")
    write_frames(path, frames, fps=24, qp=24, **features)
    want, props = cv2_read(path)
    assert props == (len(frames), 24.0, 136, 72) and video_info(path) == props
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    for key in used:
        assert stats[key] > 0, (key, stats)
    assert stats["entry_point_mismatches"] == 0
    assert min(psnr(a, b) for a, b in zip(got, frames)) >= 30.0


@pytest.mark.parametrize("features, seed", [(dict(), 6), (dict(leading=6, cra=1, gop=3), 18)],
                         ids=["groups", "cra"])
def test_non_reference_pictures_keep_pocs_in_range(features, seed, tmp_path):
    """Sub-layer non-reference pictures leave prevTid0Pic behind: with 4 POC
    bits the writer keeps each next anchor, or CRA, at most 8 above it (a
    smaller group, fewer leading pictures, or an IDR), where it once wrote a
    POC that decodes 16 lower."""
    path = str(tmp_path / "nonref.mp4")
    write_random(path, (64, 48), 10, seed=seed, group=4, nonref=0.5, poc_bits=4, refs=2,
                 **features)
    want, _ = cv2_read(path)
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    assert stats["trail_n_pictures"] > 0


def test_wrong_hvcc_bit_depth_is_counted(tmp_path):
    """cv2's FFmpeg decodes by the SPS and reads nothing of hvcC's bit
    depths; the decoder does too, and counts an SPS that disagrees."""
    path = str(tmp_path / "hvcc_bd.mp4")
    write_random(path, (64, 48), 3, seed=2, bit_depth=10, hvcc_bd=8)
    want, _ = cv2_read(path)
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    assert stats["hvcc_bit_depth_mismatches"] == 1 and stats["pictures_10bit"] == 3


def test_wrong_entry_points_are_counted(tmp_path):
    """cv2's FFmpeg decodes a stream whose first entry point of each slice is
    one byte off as it decodes a right one; the decoder does too, and counts
    each wrong one."""
    path = str(tmp_path / "bad_entry.mp4")
    write_random(path, (72, 40), 4, seed=3, wpp=1, ctb=16, bad_entry=1)
    want, _ = cv2_read(path)
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    assert stats["entry_point_mismatches"] == 4 and stats["entry_points"] == 8


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


COLOURS = [dict(full_range=1), dict(matrix=1), dict(matrix=6, full_range=1)]


@pytest.mark.parametrize("colour, bit_depth", [(c, d) for d in (8, 10) for c in COLOURS],
                         ids=[f"colour{i}{'' if d == 8 else '-10'}" for d in (8, 10)
                              for i in range(len(COLOURS))])
def test_signalled_colour_converts_as_cv2(colour, bit_depth, tmp_path):
    """At 8 bits swscale's unscaled yuv2rgb; at 10 bits its general scaler
    (mp4.h: yuv420_high_to_bgr), each with the matrix and range signalled."""
    path = str(tmp_path / "colour.mp4")
    write_random(path, (64, 48), 3, seed=7, bit_depth=bit_depth, **colour)
    want, _ = cv2_read(path)
    assert_same_frames(list(read_video(path)), want)


@pytest.mark.parametrize("loc", range(7))
def test_chroma_location_converts_as_cv2(loc, tmp_path):
    """At 10 bits swscale interpolates the chroma from where the VUI's
    chroma_sample_loc_type puts it (types 0-5; above 5 cv2 takes it as
    unspecified, the centre); at 8 bits its unscaled yuv2rgb ignores it."""
    path = str(tmp_path / "loc.mp4")
    for bit_depth in (8, 10):
        write_random(path, (64, 48), 2, seed=loc, bit_depth=bit_depth, chroma_loc_type=loc,
                     pcm=1, pcm_share=0.3)
        want, _ = cv2_read(path)
        assert_same_frames(list(read_video(path)), want)


REFUSED = {
    # name: (writer features, the words the error names)
    "bla_pictures": (dict(refuse="bla"), "BLA pictures"),
    "tsa_stsa_pictures": (dict(refuse="tsa_stsa"), "TSA/STSA pictures"),
    "wpp_and_tiles": (dict(refuse="wpp_tiles"), "tiles and WPP in one PPS"),
    "long_term_refs": (dict(refuse="long_term"), "long-term reference pictures"),
    "rext_profile": (dict(refuse="rext"), "profiles other than Main"),
    "bit_depth_mixed": (dict(refuse="bit_depth_mixed"), r"bit depths that differ \(luma 10, chroma 8\)"),
    "bit_depth12": (dict(refuse="bit_depth12"), "bit depth 12"),
    # swscale converts 10-bit pictures of fewer than 10 rows by other paths
    "short_main10_picture": (dict(bit_depth=10), "8 rows at 10 bits"),
    "chroma422": (dict(refuse="chroma422"), "chroma_format_idc 2"),
    "missing_reference": (dict(refuse="missing_ref"), "missing reference picture"),
    "idr_over_generated_refs": (dict(refuse="idr_over_generated", cra=3, leading=2),
                                "references generated for the CRA that starts the stream"),
    "left_crop": (dict(crop_left=2), "conf_win_left_offset"),
    # BT.2020 primaries with a transfer whose EOTF is not BT.1886's or HLG's
    "bt2020_primaries": (dict(matrix=1, primaries=9, transfer=8),
                         "colour_primaries 9 with transfer_characteristics 8"),
    "pq_transfer": (dict(matrix=1, primaries=1, transfer=16), "transfer_characteristics 16"),
    "hlg_transfer": (dict(matrix=1, primaries=5, transfer=18),
                     "transfer_characteristics 18 with colour_primaries 5"),
    "gbr_matrix": (dict(matrix=0, primaries=1, transfer=1), "matrix_coefficients 0"),
    "ycgco_matrix": (dict(matrix=8, primaries=1, transfer=1), "matrix_coefficients 8"),
    # constant luminance: cv2's swscale does not convert it
    "bt2020_matrix": (dict(matrix=10, primaries=9, transfer=14), "matrix_coefficients 10"),
    "other_primaries": (dict(matrix=9, primaries=11, transfer=1), "colour_primaries 11"),
    "pq_from_sei": (dict(matrix=9, primaries=9, transfer=14, atc_sei=16, atc_aus="2"),
                    "transfer_characteristics 16 from the alternative transfer characteristics SEI"),
    "reserved_transfer_from_sei": (dict(matrix=1, primaries=1, transfer=1, atc_sei=0),
                                   "transfer_characteristics 0 from the alternative transfer"),
    "hlg_luminance_seis": (dict(matrix=9, primaries=9, transfer=18, luminance_sei=1),
                           "mastering display colour volume or content light level SEI"),
    "short_hlg_picture": (dict(matrix=1, primaries=1, transfer=18), "8 rows with BT.2020"),
    "dolby_vision_profile5": (dict(dvcc=5, dv_entry="dvh1", dv_rpu=1), "Dolby Vision profile 5"),
    "dolby_vision_profile7": (dict(dvcc=7, dv_rpu=1), "Dolby Vision profile 7"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_features_raise_by_name(name, tmp_path):
    features, words = REFUSED[name]
    path = str(tmp_path / f"{name}.mp4")
    size = {"left_crop": (56, 40), "short_main10_picture": (64, 8),
            "short_hlg_picture": (64, 8)}.get(name, (64, 48))
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
    with pytest.raises(UnsupportedVideoError, match=r"'vp09'.*mp4v, avc1, avc3, hvc1, hev1, dvh1, dvhe"):
        VideoReader(str(bad))


@pytest.mark.parametrize("rotation, b", [(0, {}), (90, {}),
                                         (0, dict(bframes=4, pyramid=1, refs=3, gop=8, cra=1)),
                                         (0, dict(bframes=4, pyramid=1, refs=3, gop=8, cra=1,
                                                  wpp=1)),
                                         (0, dict(bframes=4, pyramid=1, refs=3, gop=8, cra=1,
                                                  wpp=1, bit_depth=10))],
                         ids=["0", "90", "b_frames", "x265_defaults", "main10"])
def test_extract_sharpest_frames_keeps_the_jax_frames(rotation, b, tmp_path):
    """On an HEVC file, the port keeps the frames the JAX package's
    extract_sharpest_frames keeps (cv2.VideoCapture there), with the same
    pixels; with a portrait display matrix both keep portrait frames; and
    so on an I/P/B stream (B pyramid, an open GOP with RASL pictures), with
    WPP too as x265 writes by default, and so at 10 bits (Main 10)."""
    import cv2
    import numpy as np

    from monohair_tpu.video import extract_sharpest_frames as jax_extract
    from monohair_tpu_torch.video import extract_sharpest_frames
    from tests.test_torch_video import sharp_and_blurred

    video = str(tmp_path / "v.mp4")
    write_frames(video, sharp_and_blurred(13), fps=30, qp=20, ctb=16, rotation=rotation, **b)
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


# ---------------------------------------------- HDR and wide gamut --
# cv2's swscale converts BT.2020 primaries and HLG through colour
# management (csrc/mp4.h: three passes around a 3D LUT); the decoder holds
# each held combination bit for bit, and refuses the others by name (REFUSED).

def _decode(path):
    with VideoReader(path) as reader:
        return list(reader), reader.stats


@pytest.mark.parametrize("at", ["first", "later_reordered", "later_no_vui_colour"])
def test_alternative_transfer_sei_replaces_the_vui_transfer(at, tmp_path):
    """FFmpeg hands cv2 the transfer of the alternative transfer
    characteristics SEI (payload 147) in place of the VUI's, from the picture
    of its access unit on (it persists): a BT.709 stream whose VUI says
    BT.2020's transfer (14) and whose SEI says HLG (18), as cameras write
    HLG, is tone-mapped by cv2, and so by the decoder. With pictures out of
    decode order, each frame keeps what was in effect at its decoding; one
    whose VUI names no colours takes the last SEI read when it is output."""
    features = dict(first=dict(atc_aus="first", gop=3),
                    later_reordered=dict(atc_aus="3", group=3, refs=3),
                    later_no_vui_colour=dict(atc_aus="3", group=4, refs=2))[at]
    base = (dict(pcm=1, pcm_share=0.3) if at == "later_no_vui_colour" else
            dict(matrix=1, primaries=1, transfer=14, pcm=1, pcm_share=0.3))
    plain, with_sei = str(tmp_path / "plain.mp4"), str(tmp_path / "sei.mp4")
    write_random(plain, (64, 48), 6, seed=5, **base, **features)
    write_random(with_sei, (64, 48), 6, seed=5, atc_sei=18, **base, **features)
    want, _ = cv2_read(with_sei)
    unmapped, _ = cv2_read(plain)
    mapped = [not np.array_equal(a, b) for a, b in zip(want, unmapped)]
    assert mapped[-1] and (all(mapped) or at != "first")
    got, stats = _decode(with_sei)
    assert_same_frames(got, want)
    assert stats["alternative_transfer_seis"] >= 1
    assert stats["colour_managed_pictures"] == sum(mapped)


@pytest.mark.parametrize("sei", [2, 19])
def test_alternative_transfer_sei_naming_no_transfer_changes_nothing(sei, tmp_path):
    """An SEI naming "unspecified" (2) or no transfer at all (19) leaves
    FFmpeg's frames with the VUI's transfer: HLG here, as without the SEI."""
    plain, with_sei = str(tmp_path / "plain.mp4"), str(tmp_path / "sei.mp4")
    base = dict(matrix=1, primaries=1, transfer=18, atc_aus="2", group=2, refs=2)
    write_random(plain, (64, 48), 5, seed=8, **base)
    write_random(with_sei, (64, 48), 5, seed=8, atc_sei=sei, **base)
    want, _ = cv2_read(with_sei)
    got, stats = _decode(with_sei)
    assert_same_frames(got, want)
    # the pictures without the SEI, through the HLG conversion the other tests hold to cv2's
    assert_same_frames(want, _decode(plain)[0])
    assert stats["alternative_transfer_seis"] == 1 and stats["colour_managed_pictures"] == len(got)


@pytest.mark.parametrize("bit_depth", [8, 9, 10])
@pytest.mark.parametrize("full_range", [0, 1])
def test_bt2020_matrix_converts_as_cv2(bit_depth, full_range, tmp_path):
    """matrix_coefficients 9 (non-constant luminance) with BT.709 primaries:
    swscale's coefficients for it, at each depth and range."""
    path = str(tmp_path / "bt2020.mp4")
    write_random(path, (64, 48), 3, seed=bit_depth, bit_depth=bit_depth, matrix=9, primaries=1,
                 transfer=1, full_range=full_range, pcm=1, pcm_share=0.3)
    want, _ = cv2_read(path)
    got, stats = _decode(path)
    assert_same_frames(got, want)
    assert stats["colour_managed_pictures"] == 0


HDR_COLOURS = {"bt2020_hlg": (9, 9, 18), "bt709_hlg": (1, 1, 18), "bt2020_sdr": (9, 9, 1),
               "bt2020_sdr_10bit_transfer": (9, 9, 14)}


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("name", sorted(HDR_COLOURS))
def test_hdr_probe_pictures_convert_as_cv2(name, bit_depth, tmp_path):
    """PCM pictures of random samples over the whole range (at 10 bits half of
    them on smooth surfaces), each combination in another chroma location and
    range: the three passes and the LUT's interpolation between its nodes,
    out-of-gamut colours and HLG above the SDR white among them."""
    matrix, primaries, transfer = HDR_COLOURS[name]
    k = sorted(HDR_COLOURS).index(name) * 2 + bit_depth // 10
    path = str(tmp_path / "probe.mp4")
    write_random(path, (192, 96), 2, seed=k, bit_depth=bit_depth, intra_only=1, pcm=1, pcm_share=1,
                 matrix=matrix, primaries=primaries, transfer=transfer, full_range=k % 3 == 1,
                 chroma_loc_type=k % 7)
    want, _ = cv2_read(path)
    got, stats = _decode(path)
    assert_same_frames(got, want)
    assert stats["colour_managed_pictures"] == len(got) > 0 and stats["pcm_cus"] > 0


@pytest.mark.parametrize("bit_depth, colour", [(10, (9, 9, 18)), (8, (1, 1, 18))],
                         ids=["main10_bt2020_hlg", "main_bt709_hlg"])
def test_hdr_ipb_stream_converts_as_cv2(bit_depth, colour, tmp_path):
    """An I/P/B stream in HEVC_B's shape with the HDR colours, as cv2 shows it."""
    matrix, primaries, transfer = colour
    path = str(tmp_path / "ipb.mp4")
    frames = smooth_frames(72, 136, 8)
    write_frames(path, frames, fps=24, qp=22, ctb=32, bframes=4, pyramid=1, refs=3, gop=8, cra=1,
                 wpp=1, bit_depth=bit_depth, matrix=matrix, primaries=primaries, transfer=transfer)
    want, props = cv2_read(path)
    assert props == (len(frames), 24.0, 136, 72)
    got, stats = _decode(path)
    assert_same_frames(got, want)
    assert stats["colour_managed_pictures"] == len(frames) and stats["b_slices"] > 0


@pytest.mark.parametrize("entry", ["hvc1", "dvh1", "dvhe"])
def test_dolby_vision_8_4_base_layer_decodes_as_cv2(entry, tmp_path):
    """Dolby Vision profile 8.4 (an HLG base layer any HEVC decoder shows):
    the RPU NAL units (type 62) ending each access unit are skipped, the
    dvvC box in the sample entry is read for its profile, and the dvh1 and
    dvhe entries decode as HEVC, as FFmpeg reads them."""
    path = str(tmp_path / "dolby.mp4")
    write_random(path, (64, 48), 5, seed=3, bit_depth=10, matrix=9, primaries=9, transfer=18,
                 dv_rpu=1, dvcc=8, hev1=int(entry == "dvhe"),
                 **({} if entry == "hvc1" else dict(dv_entry=entry)))
    data = open(path, "rb").read()
    assert data.count(entry.encode()) == 1 and data.count(b"dvvC") == 1
    want, props = cv2_read(path)
    assert video_info(path) == props
    got, stats = _decode(path)
    assert_same_frames(got, want)
    assert stats["dolby_vision_rpus"] == 5 and stats["colour_managed_pictures"] == len(got)


# SHA-256 of video.colour_lut's nodes, each of which equalled swscale's (the
# library cv2 bundles, node by node) when taken; chip_smoke.py holds the
# same digests on the card's host, whose libm builds them there
COLOUR_LUT_SHA256 = {
    (True, False): "45378ca2955d30408a7eef7de8e6dd6b504f2ed547a22a644e1ab47c66114f58",
    (False, True): "e22aa8b92106b58ca6e4c09031cac3b28846652ce49b922b8690238c8f5be08d",
    (True, True): "be9edc8cf25d2e306551795d217346948dc2f0bd328e40c99b0fb6f003b3aa6a"}


@pytest.mark.parametrize("bt2020, hlg", sorted(COLOUR_LUT_SHA256), ids=["hlg", "bt2020", "bt2020_hlg"])
def test_colour_lut_keeps_its_digest(bt2020, hlg):
    """The 3D LUTs of cv2's colour management (BT.2020 primaries to BT.709;
    HLG to BT.1886; both) keep the nodes they had when held against
    swscale's: a change to their construction, or a libm that rounds
    differently, shows here before it shows in a frame."""
    import hashlib

    from monohair_tpu_torch.io.video import colour_lut
    lut = colour_lut(bt2020, hlg)
    assert lut.shape == (65, 65, 65, 3) and lut.dtype == np.uint16
    assert hashlib.sha256(lut.tobytes()).hexdigest() == COLOUR_LUT_SHA256[(bt2020, hlg)]
    # the grey axis keeps its order, black and white at their ends
    grey = lut[np.arange(65), np.arange(65), np.arange(65)].astype(int)
    assert (np.diff(grey, axis=0) >= 0).all() and grey[-1].min() >= 64000 and grey[0].max() < 64
