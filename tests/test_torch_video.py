"""The port's video functions against the JAX package's on the CPU:
monohair_tpu_torch.video.extract_sharpest_frames (monohair_tpu/video.py) and
monohair_tpu_torch.nerf.pipeline.render_camera_path_video
(monohair_tpu/nerf/pipeline.py:24-43).

Held: on the same cv2-written video, the port keeps the JAX function's frame
names, and its PNGs hold the same pixels (the decoder gives cv2's frames
bitwise, so no tolerance) and its JPEGs the same bytes; tests/test_video.py's
case. The same on an H.264 file of the port's test-stream writer, on one
with B pictures (two between anchors, coded out of display order), on one
whose display matrix turns it by 90 degrees (a portrait phone video: the
kept frames are portrait in both packages) and on an mp4v file so turned. The fly-through's frames before encoding, on a small Fourier field
carried across with nerf/convert.py along a 3-pose path: the same count and
size as the JAX function's, and the same uint8 values but for truncation at
the edge of a quantisation step (the renders agree to ~1e-6 relative, so a
value may fall on either side of k/255: allowed max |diff| 1 on under 1% of
values; measured equal on this field); the written mp4 decodes to that many
frames at that size, at >= 30 dB against them."""

import os
import types

import cv2
import numpy as np
import pytest
import torch

from monohair_tpu.nerf import pipeline as jpipe
from monohair_tpu.video import extract_sharpest_frames as jax_extract
from monohair_tpu_torch.io.h264_streams import write_frames
from monohair_tpu_torch.io.video import read_video
from monohair_tpu_torch.nerf import pipeline
from monohair_tpu_torch.nerf.poses import save_base_cam
from monohair_tpu_torch.video import extract_sharpest_frames
from tests.test_torch_mp4v import cv2_write, psnr, smooth_frames
from tests.test_torch_nerf_render import orbit_c2w, small_fourier  # noqa: F401  (fixture)

torch.set_num_threads(1)

BG = [0.92, 0.92, 0.92]


def blurred(img, k=5):
    out = np.zeros(img.shape, np.float64)
    pad = np.pad(img.astype(np.float64), ((k // 2,) * 2, (k // 2,) * 2, (0, 0)), mode="edge")
    for dy in range(k):
        for dx in range(k):
            out += pad[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return (out / (k * k)).astype(np.uint8)


def sharp_and_blurred(n, sharp_every=5, h=48, w=64):
    """n frames of a textured scene; frame i is sharp when i % sharp_every ==
    (i // sharp_every) % sharp_every, box-blurred otherwise."""
    rng = np.random.default_rng(3)
    base = smooth_frames(h, w, n, dx=0.6, dy=0.3)
    out = []
    for i, f in enumerate(base):
        tex = np.clip(f.astype(int) + rng.integers(-40, 40, f.shape), 0, 255).astype(np.uint8)
        out.append(tex if i % sharp_every == (i // sharp_every) % sharp_every else blurred(tex))
    return out


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_extract_sharpest_frames_keeps_the_jax_frames(ext, tmp_path):
    video = str(tmp_path / "v.mp4")
    cv2_write(video, sharp_and_blurred(13), 30)   # 13: the last partial interval is dropped
    fmt = "frame_{:05d}" + ext
    want = jax_extract(video, str(tmp_path / "jax"), interval=5, name_fmt=fmt)
    got = extract_sharpest_frames(video, str(tmp_path / "port"), interval=5, name_fmt=fmt,
                                  device="cpu")
    assert got == want and len(got) == 2
    for name in got:
        a, b = (str(tmp_path / d / name) for d in ("port", "jax"))
        if ext == ".png":
            assert np.array_equal(cv2.imread(a), cv2.imread(b)), name
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), name
    # the sharp frames were kept: frames 0 and 6 of the video
    frames = list(read_video(video))
    kept = cv2.imread(str(tmp_path / "jax" / got[1])) if ext == ".png" else None
    if kept is not None:
        assert np.array_equal(kept, frames[6])


def _rotate_90(path):
    data = bytearray(open(path, "rb").read())
    tkhd = data.index(b"tkhd") + 4
    off = tkhd + (52 if data[tkhd] == 1 else 40)
    data[off:off + 36] = b"".join(v.to_bytes(4, "big", signed=True)
                                  for v in [0, 65536, 0, -65536, 0, 0, 0, 0, 1 << 30])
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("ext", [".png", ".jpg"])
@pytest.mark.parametrize("kind", ["h264", "h264_b", "h264_rotated", "mp4v_rotated"])
def test_extract_sharpest_frames_from_h264_and_rotated_videos(kind, ext, tmp_path):
    video = str(tmp_path / "v.mp4")
    frames = sharp_and_blurred(13)
    if kind == "mp4v_rotated":
        cv2_write(video, frames, 30)
        _rotate_90(video)
    elif kind == "h264_b":  # I/P/B as x264 writes it: B references, implicit weights
        write_frames(video, frames, fps=30, qp=20, gop=6, bframes=2, pyramid=1, bipred_idc=2,
                     refs=3)
    else:
        write_frames(video, frames, fps=30, qp=20, gop=4,
                     rotation=90 if kind == "h264_rotated" else 0)
    fmt = "frame_{:05d}" + ext
    want = jax_extract(video, str(tmp_path / "jax"), interval=5, name_fmt=fmt)
    got = extract_sharpest_frames(video, str(tmp_path / "port"), interval=5, name_fmt=fmt,
                                  device="cpu")
    assert got == want and len(got) == 2
    shape = (64, 48, 3) if kind.endswith("rotated") else (48, 64, 3)
    for name in got:
        a, b = (str(tmp_path / d / name) for d in ("port", "jax"))
        if ext == ".png":
            assert cv2.imread(a).shape == shape
            assert np.array_equal(cv2.imread(a), cv2.imread(b)), name
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), name
    if ext == ".png":  # the sharp frame of the second window: frame 6
        assert np.array_equal(cv2.imread(str(tmp_path / "port" / got[1])),
                              list(read_video(video))[6])


def test_the_jax_packages_case(tmp_path, rng):
    """tests/test_video.py: frames 2 and 7 are noise, the others flat gray."""
    path = str(tmp_path / "v.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
    for i in range(12):
        if i in (2, 7):
            frame = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
        else:
            frame = np.full((64, 64, 3), 128, np.uint8)
        w.write(frame)
    w.release()
    out = str(tmp_path / "frames")
    kept = extract_sharpest_frames(path, out, interval=6, device="cpu")
    assert len(kept) == 2
    for name in kept:
        img = cv2.imread(os.path.join(out, name), cv2.IMREAD_GRAYSCALE)
        assert img.std() > 20


class CaptureWriter:
    """Stands in for a video writer: keeps the frames handed to it."""

    def __init__(self, path, *args, **kwargs):
        self.written = []
        CaptureWriter.last = self

    def write(self, frame):
        self.written.append(np.array(frame))

    def release(self):
        pass

    @property
    def frames(self):
        return len(self.written)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def test_fly_through_frames_match_the_jax_render(small_fourier, tmp_path,  # noqa: F811
                                                 monkeypatch):
    from monohair_tpu_torch.coords import nerf_to_ngp
    from monohair_tpu_torch.nerf.poses import _se3
    jfield, variables, field = small_fourier
    poses = [nerf_to_ngp(orbit_c2w(a, radius=2.2)) for a in (0.2, 0.9, 1.5)]
    path = str(tmp_path / "base_cam.json")
    save_base_cam(path, [_se3(p[:, :3], p[:, 3]) for p in poses], [35.0, 40.0, 30.0])
    size = dict(H=12, W=16, frames_per_seg=3, fps=24, background=BG)
    monkeypatch.setattr(jpipe, "cv2", types.SimpleNamespace(
        VideoWriter=CaptureWriter, VideoWriter_fourcc=lambda *c: 0))
    jpipe.render_camera_path_video(jfield, variables, path, str(tmp_path / "j.mp4"), **size)
    want = CaptureWriter.last.written
    with monkeypatch.context() as m:
        m.setattr(pipeline, "VideoWriter", CaptureWriter)
        n = pipeline.render_camera_path_video(field, path, str(tmp_path / "p.mp4"), **size)
    got = CaptureWriter.last.written
    assert n == len(want) == len(got) == 6
    diff = np.abs(np.stack(got).astype(int) - np.stack(want))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())
    # the real writer: the file decodes to those frames
    out = str(tmp_path / "fly.mp4")
    assert pipeline.render_camera_path_video(field, path, out, **size) == 6
    decoded = list(read_video(out))
    assert len(decoded) == 6 and decoded[0].shape == (12, 16, 3)
    assert min(psnr(a, b) for a, b in zip(decoded, got)) >= 30.0
