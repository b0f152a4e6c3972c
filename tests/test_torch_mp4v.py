"""The port's mp4v codec (monohair_tpu_torch/io/video.py, csrc/mp4v.cpp)
against OpenCV's FFmpeg on the CPU.

Held bitwise (max |diff| 0 on every frame, so no tolerance is needed): the
port's decode of files that cv2.VideoWriter(..., "mp4v") writes, against
cv2.VideoCapture's frames: noise (I-VOPs), a smooth scene moving by a
sub-pixel shift a frame (P-VOPs with half-pel vectors under both rounding
types), 72x40 (not a multiple of 16) and two 1920x1080 frames (1080 rows
are not a multiple of 16); frame count, size and fps equal cv2's. On the
port's own files cv2 reads the same count, size and fps, at a PSNR of at
least 30 dB against the source on smooth content, and the port decodes them
to cv2's frames bitwise, also with the stream features that FFmpeg's
default writer does not use (4MV, AC prediction, MPEG quantisation,
intra DC coded as AC). A port file rewritten with moov before mdat, or
with co64 chunk offsets, reads as cv2 reads it. A display matrix of 90, 180
or 270 degrees, on an mp4v file of cv2's and on an H.264 file of the port's
test-stream writer, gives cv2's rotated frames and cv2's video_info. An hvc1
sample entry, a B-VOP and a video packet raise UnsupportedVideoError."""

import os
import struct

import cv2
import numpy as np
import pytest

from monohair_tpu_torch.io.video import (UnsupportedVideoError, VideoReader, VideoWriter,
                                         read_video, video_info)


def smooth_frames(h, w, n, dx=0.37, dy=0.21):
    """A smooth colour pattern moving by (dx, dy) pixels a frame."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for i in range(n):
        x, y = xx - i * dx, yy - i * dy
        b = 128 + 60 * np.sin(x / 7.0) + 40 * np.cos(y / 5.0)
        g = 128 + 50 * np.sin((x + y) / 9.0)
        r = 128 + 70 * np.cos(x / 11.0 - y / 13.0)
        out.append(np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8))
    return out


def noise_frames(h, w, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def cv2_write(path, frames, fps):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(f)
    writer.release()


def cv2_read(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS),
             int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return frames, props


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def assert_same_frames(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, k
        assert np.array_equal(a, b), (k, int(np.abs(a.astype(int) - b).max()))


CV2_FILES = {
    "noise_64x48": (lambda: noise_frames(48, 64, 14), 10),
    "smooth_96x64": (lambda: smooth_frames(64, 96, 20), 10),
    "odd_72x40": (lambda: smooth_frames(40, 72, 10), 10),
    "hd_1920x1080": (lambda: smooth_frames(1080, 1920, 2, dx=1.3, dy=0.7), 30),
}


@pytest.mark.parametrize("name", sorted(CV2_FILES))
def test_decodes_cv2_files_to_cv2_frames_bitwise(name, tmp_path):
    make, fps = CV2_FILES[name]
    path = str(tmp_path / f"{name}.mp4")
    cv2_write(path, make(), fps)
    want, props = cv2_read(path)
    assert video_info(path) == props
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    if name == "noise_64x48":
        assert stats["i_vops"] == len(got) and stats["p_vops"] == 0
    else:  # FFmpeg's P-VOPs: half-pel vectors, vop_rounding_type 0 and 1
        assert stats["p_vops"] > 0 and stats["half_pel_vectors"] > 0
        assert stats["rounding_vops"] > 0
        if stats["p_vops"] > 1:
            assert stats["rounding_vops"] < stats["p_vops"]


PORT_FILES = {
    # name: (frames, writer options, the stats that must be non-zero)
    "default": (lambda: smooth_frames(64, 96, 14), {}, ("p_vops", "half_pel_vectors")),
    "intra_only": (lambda: smooth_frames(48, 72, 5), {"gop": 1}, ("i_vops",)),
    "odd_72x40": (lambda: smooth_frames(40, 72, 8, dx=1.7, dy=-2.3), {}, ("p_vops",)),
    "four_mv": (lambda: noise_frames(40, 72, 6, seed=1), {"qscale": 2, "gop": 5, "four_mv": True},
                ("four_mv_mbs", "intra_mbs", "escape1", "escape2", "escape3")),
    "ac_pred": (lambda: smooth_frames(40, 72, 8), {"qscale": 5, "gop": 4, "ac_pred": True},
                ("ac_pred_mbs", "not_coded_mbs")),
    "mpeg_quant": (lambda: smooth_frames(40, 72, 8), {"qscale": 4, "gop": 6, "quant_type": 1},
                   ("mpeg_quant_vops",)),
    "dc_as_ac": (lambda: smooth_frames(40, 72, 8), {"qscale": 20, "gop": 6, "ac_pred": True,
                                                    "dc_thr": 7}, ("dc_as_ac_blocks",)),
}


@pytest.mark.parametrize("name", sorted(PORT_FILES))
def test_cv2_reads_the_port_files_and_both_decode_alike(name, tmp_path):
    make, opts, used = PORT_FILES[name]
    frames = make()
    h, w = frames[0].shape[:2]
    path = str(tmp_path / f"{name}.mp4")
    with VideoWriter(path, 24, (w, h), **opts) as writer:
        for f in frames:
            writer.write(f)
    want, props = cv2_read(path)
    assert props == (len(frames), 24.0, w, h)
    assert video_info(path) == props
    with VideoReader(path) as reader:
        got = list(reader)
        stats = reader.stats
    assert_same_frames(got, want)
    for key in used:
        assert stats[key] > 0, (key, stats)
    if name in ("default", "intra_only", "odd_72x40"):
        assert min(psnr(a, b) for a, b in zip(got, frames)) >= 30.0


def test_file_size_beside_cv2(tmp_path):
    """Measured on 14 frames of the smooth 96x64 scene: the port's default
    (qscale 3, GOP 12) is within a factor of 2 of cv2's rate-controlled file."""
    frames = smooth_frames(64, 96, 14)
    ours, theirs = str(tmp_path / "ours.mp4"), str(tmp_path / "cv2.mp4")
    with VideoWriter(ours, 10, (96, 64)) as writer:
        for f in frames:
            writer.write(f)
    cv2_write(theirs, frames, 10)
    ratio = os.path.getsize(ours) / os.path.getsize(theirs)
    assert 0.5 < ratio < 2.0, ratio


CONTAINERS = ("moov", "trak", "mdia", "minf", "stbl")


def _boxes(data):
    """[type, payload or children, 64-bit size] of each box."""
    out, i = [], 0
    while i < len(data):
        size, kind = struct.unpack(">I4s", data[i:i + 8])
        head, large = 8, size == 1
        if large:
            size, head = struct.unpack(">Q", data[i + 8:i + 16])[0], 16
        kind = kind.decode("latin-1")
        body = data[i + head:i + size]
        out.append([kind, _boxes(body) if kind in CONTAINERS else body, large])
        i += size
    return out


def _bytes(boxes):
    out = b""
    for kind, body, large in boxes:
        body = _bytes(body) if isinstance(body, list) else body
        head = (struct.pack(">I4sQ", 1, kind.encode("latin-1"), 16 + len(body)) if large
                else struct.pack(">I4s", 8 + len(body), kind.encode("latin-1")))
        out += head + body
    return out


def _find(boxes, kind):
    for box in boxes:
        if box[0] == kind:
            return box
        if isinstance(box[1], list) and (hit := _find(box[1], kind)):
            return hit
    return None


@pytest.mark.parametrize("layout", ["moov_first", "co64"])
def test_demuxer_takes_moov_first_and_co64(layout, tmp_path):
    frames = smooth_frames(48, 72, 4)
    path = str(tmp_path / "v.mp4")
    with VideoWriter(path, 10, (72, 48)) as writer:
        for f in frames:
            writer.write(f)
    boxes = _boxes(open(path, "rb").read())
    names = [b[0] for b in boxes]
    assert names == ["ftyp", "mdat", "moov"]
    stco = _find(boxes, "stco")
    count, = struct.unpack(">I", stco[1][4:8])
    offsets = struct.unpack(f">{count}I", stco[1][8:])
    if layout == "co64":
        stco[0] = "co64"
        stco[1] = stco[1][:8] + struct.pack(f">{count}Q", *offsets)
        boxes = [boxes[0], boxes[1], boxes[2]]
    else:
        shift = len(_bytes([boxes[2]]))
        stco[1] = stco[1][:8] + struct.pack(f">{count}I", *(o + shift for o in offsets))
        boxes = [boxes[0], boxes[2], boxes[1]]
    moved = str(tmp_path / f"{layout}.mp4")
    with open(moved, "wb") as f:
        f.write(_bytes(boxes))
    want, props = cv2_read(moved)
    assert props == (4, 10.0, 72, 48)
    assert video_info(moved) == props
    assert_same_frames(list(read_video(moved)), want)
    assert_same_frames(list(read_video(path)), want)


def _port_file(tmp_path, n=3):
    path = str(tmp_path / "v.mp4")
    with VideoWriter(path, 10, (32, 16), gop=1) as writer:
        for f in smooth_frames(16, 32, n):
            writer.write(f)
    return path


def test_other_sample_entries_raise_unsupported(tmp_path):
    path = _port_file(tmp_path)
    data = open(path, "rb").read()
    assert data.count(b"mp4v") == 1
    bad = tmp_path / "hvc1.mp4"
    bad.write_bytes(data.replace(b"mp4v", b"hvc1"))
    with pytest.raises(UnsupportedVideoError, match="hvc1"):
        VideoReader(str(bad))


# the tkhd matrix of a clockwise rotation, as a phone writes it (FFmpeg's sign
# convention: cv2 rotates 90 degrees clockwise for [0 1; -1 0])
ROTATIONS = {90: [0, 65536, 0, -65536, 0, 0, 0, 0, 1 << 30],
             180: [-65536, 0, 0, 0, -65536, 0, 0, 0, 1 << 30],
             270: [0, -65536, 0, 65536, 0, 0, 0, 0, 1 << 30]}


@pytest.mark.parametrize("codec", ["mp4v", "h264"])
@pytest.mark.parametrize("degrees", sorted(ROTATIONS))
def test_display_matrix_rotates_as_cv2(codec, degrees, tmp_path):
    from monohair_tpu_torch.io.h264_streams import write_random
    path = str(tmp_path / "r.mp4")
    if codec == "mp4v":
        cv2_write(path, smooth_frames(48, 64, 4), 10)
        data = bytearray(open(path, "rb").read())
        tkhd = data.index(b"tkhd") + 4
        off = tkhd + (52 if data[tkhd] == 1 else 40)
        data[off:off + 36] = b"".join(v.to_bytes(4, "big", signed=True)
                                      for v in ROTATIONS[degrees])
        open(path, "wb").write(bytes(data))
    else:
        write_random(path, (64, 48), 4, seed=degrees, rotation=degrees)
    want, props = cv2_read(path)
    assert video_info(path) == props
    assert props[2:] == ((48, 64) if degrees != 180 else (64, 48))
    got = list(read_video(path))
    assert_same_frames(got, want)
    with VideoReader(path) as reader:
        assert (reader.width, reader.height) == props[2:]


def test_a_b_vop_raises_unsupported(tmp_path):
    path = _port_file(tmp_path)
    data = bytearray(open(path, "rb").read())
    vop = data.index(b"\x00\x00\x01\xb6", data.index(b"mdat"))
    data[vop + 4] = (data[vop + 4] & 0x3F) | 0x80  # vop_coding_type 2: B
    bad = tmp_path / "b.mp4"
    bad.write_bytes(bytes(data))
    with pytest.raises(UnsupportedVideoError, match="B-VOP"):
        list(read_video(str(bad)))


def _bits(value, n):
    return format(value, f"0{n}b")


def test_video_packets_raise_unsupported(tmp_path):
    """A VOL with resync markers enabled and an I-VOP whose second macroblock
    starts a video packet (stuffing, then 16 zeros and a one)."""
    path = _port_file(tmp_path, n=1)
    data = bytearray(open(path, "rb").read())
    vol = data.index(b"\x00\x00\x01\x20") + 4
    # the writer's VOL: resync_marker_disable is its 83rd bit
    data[vol + 82 // 8] &= ~(0x80 >> (82 % 8))
    vop = data.index(b"\x00\x00\x01\xb6", data.index(b"mdat"))
    size = data.index(b"moov") - 4 - vop
    bits = ("00" "0" "1" + _bits(0, 4) + "1" "1"   # I-VOP, time 0, coded
            + "000" + _bits(3, 5)                    # intra_dc_vlc_thr 0, vop_quant 3
            + "1" "0" "0011"                         # MCBPC intra cbpc 0, no ac_pred, CBPY 0
            + "011" * 4 + "11" * 2)                  # six DC sizes of 0
    bits += "0" + "1" * ((-len(bits) - 1) % 8)       # stuffing to the byte boundary
    bits += "0" * 16 + "1"                           # the resync marker
    bits += "0" * (-len(bits) % 8)
    body = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    assert len(body) <= size - 4
    data[vop + 4:vop + size] = body + bytes(size - 4 - len(body))
    bad = tmp_path / "packets.mp4"
    bad.write_bytes(bytes(data))
    with pytest.raises(UnsupportedVideoError, match="video packets"):
        list(read_video(str(bad)))


def test_a_file_that_is_not_mp4_raises(tmp_path):
    bad = tmp_path / "x.mp4"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(64))
    with pytest.raises(ValueError, match="MP4"):
        video_info(str(bad))
