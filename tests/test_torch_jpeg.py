"""The port's baseline JPEG codec (monohair_tpu_torch/io/jpeg.py,
csrc/jpeg.cpp) against OpenCV, on the CPU.

OpenCV writes the test files; the port's decoder must give cv2's decoded
pixels bitwise (gray, 4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling, odd sizes,
restart intervals, qualities 50, 95 and 100), and its encoder must write
cv2's own file byte for byte at the same quality and sampling, so that cv2
decodes both to the same pixels. A grayscale read of a colour file is its Y
plane, EXIF orientation turns the image as cv2.imread does, and files of a
kind the codec does not take raise UnsupportedJPEGError by name. Then a JPEG
capture through the port's prepare_data against the JAX package's."""

import json
import os
import shutil
import struct

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import cv2
import numpy as np
import pytest
import torch

from monohair_tpu_torch.io.image_io import imread_bgr, imread_gray, imread_rgb, imwrite
from monohair_tpu_torch.io.jpeg import (UnsupportedJPEGError, decode_jpeg, encode_jpeg,
                                        read_jpeg)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {k: os.path.join(REPO, "trained/hair_parser", k + ".npz") for k in ("modnet", "bisenet")}

CV_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
               "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
               "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
               "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(61, 97), (48, 64), (1, 1), (2, 3), (17, 5)]


def picture(h, w, c, seed=0):
    """Smooth bands plus noise: texture at every frequency, no flat blocks."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def cv_encode(img_bgr, quality, sampling=None, rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV_SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img_bgr, params)
    assert ok
    return buf.tobytes()


def cv_decode(data, flag=cv2.IMREAD_COLOR):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", ["gray", "444", "422", "420", "440"])
def test_decoder_gives_cv2_pixels(sampling, quality):
    for k, (h, w) in enumerate(SIZES):
        for rst in (0, 3):
            if sampling == "gray":
                data = cv_encode(picture(h, w, 1, k), quality, rst=rst)
            else:
                data = cv_encode(picture(h, w, 3, k), quality, sampling, rst)
            np.testing.assert_array_equal(decode_jpeg(data), cv_decode(data),
                                          err_msg=f"{h}x{w} rst {rst}")
            np.testing.assert_array_equal(decode_jpeg(data, gray=True),
                                          cv_decode(data, cv2.IMREAD_GRAYSCALE),
                                          err_msg=f"{h}x{w} rst {rst} gray")


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", ["gray", "444", "422", "420"])
def test_encoder_writes_cv2s_file(sampling, quality):
    """Byte for byte the file cv2.imencode writes, so cv2 decodes both to the
    same pixels; also with restart intervals."""
    for k, (h, w) in enumerate(SIZES):
        for rst in (0, 2):
            if sampling == "gray":
                img = picture(h, w, 1, k)
                want, got = cv_encode(img, quality, rst=rst), encode_jpeg(img, quality,
                                                                          restart_interval=rst)
            else:
                img = picture(h, w, 3, k)           # RGB; cv2 takes BGR
                want = cv_encode(np.ascontiguousarray(img[..., ::-1]), quality, sampling, rst)
                got = encode_jpeg(img, quality, sampling, rst)
            assert got == want, (h, w, rst)
            np.testing.assert_array_equal(cv_decode(got), cv_decode(want))


def test_grayscale_read_of_a_colour_file_is_its_y_plane():
    """cv2.IMREAD_GRAYSCALE of a YCbCr JPEG is libjpeg's grayscale output, the
    Y plane, not BGR2GRAY of the colour decode: the two differ on this file."""
    data = cv_encode(picture(61, 97, 3), 95, "420")
    y_plane = decode_jpeg(data, gray=True)
    np.testing.assert_array_equal(y_plane, cv_decode(data, cv2.IMREAD_GRAYSCALE))
    from_colour = cv2.cvtColor(cv_decode(data, cv2.IMREAD_COLOR)[..., ::-1], cv2.COLOR_BGR2GRAY)
    assert (from_colour != y_plane).any()


def with_exif_orientation(data, orientation, little_endian):
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    app1 = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_turns_the_image_as_cv2_does(orientation):
    data = cv_encode(picture(24, 40, 3, 1), 90)
    for le in (True, False):
        f = with_exif_orientation(data, orientation, le)
        np.testing.assert_array_equal(decode_jpeg(f), cv_decode(f))
        np.testing.assert_array_equal(decode_jpeg(f, gray=True),
                                      cv_decode(f, cv2.IMREAD_GRAYSCALE))


def test_unsupported_files_raise_a_named_error():
    img = picture(40, 56, 3)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(UnsupportedJPEGError, match="progressive"):
        decode_jpeg(prog.tobytes())
    base = cv_encode(img, 90)
    sof = base.index(b"\xff\xc0")
    for marker, what in ((b"\xff\xc9", "arithmetic"), (b"\xff\xc3", "lossless"),
                         (b"\xff\xc5", "hierarchical")):
        with pytest.raises(UnsupportedJPEGError, match=what):
            decode_jpeg(base[:sof] + marker + base[sof + 2:])
    twelve = bytearray(base)
    twelve[sof + 4] = 12                               # the sample precision
    with pytest.raises(UnsupportedJPEGError, match="12-bit"):
        decode_jpeg(bytes(twelve))
    assert issubclass(UnsupportedJPEGError, ValueError)
    # a malformed file is a plain ValueError, never a crash
    for bad in (base[:len(base) // 2], b"\xff\xd8\xff", b"not a jpeg"):
        with pytest.raises(ValueError):
            decode_jpeg(bad)


def test_restart_intervals_decode_equal_to_the_file_without():
    img = picture(1080 // 8, 1920 // 8, 3)
    plain = encode_jpeg(img, 95)
    for rst in (1, 5, 64):
        with_rst = encode_jpeg(img, 95, restart_interval=rst)
        assert b"\xff\xdd" in with_rst and len(with_rst) > len(plain)
        np.testing.assert_array_equal(decode_jpeg(with_rst), decode_jpeg(plain))
        np.testing.assert_array_equal(cv_decode(with_rst), decode_jpeg(plain))


def test_imread_and_imwrite_dispatch_on_the_suffix(tmp_path):
    rgb = picture(30, 44, 3, 2)
    for name in ("a.JPG", "b.jpg", "c.jpeg"):
        p = str(tmp_path / name)
        imwrite(p, rgb)                               # cv2's default quality, 95
        assert open(p, "rb").read() == cv_encode(np.ascontiguousarray(rgb[..., ::-1]), 95, "420")
        np.testing.assert_array_equal(imread_rgb(p), cv2.imread(p)[..., ::-1])
        np.testing.assert_array_equal(imread_bgr(p), cv2.imread(p))
        np.testing.assert_array_equal(imread_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    p = str(tmp_path / "q.JPG")
    imwrite(p, rgb[..., 0], quality=100)
    assert open(p, "rb").read() == cv_encode(rgb[..., 0], 100)
    np.testing.assert_array_equal(read_jpeg(p, gray=True), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    p = str(tmp_path / "d.png")
    imwrite(p, rgb)
    np.testing.assert_array_equal(cv2.imread(p)[..., ::-1], rgb)
    with pytest.raises(ValueError, match="quality"):
        imwrite(p, rgb, quality=90)


# ---------------------------------------------------------------------------
# a JPEG capture through prepare_data, against the JAX package
# ---------------------------------------------------------------------------

def dqt(data):
    """The quantisation tables' segments of a JPEG file."""
    out, i = [], 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] == 0xDB:
            out.append(data[i:i + 2 + n])
        i += 2 + n
    return out


def test_jpeg_capture_through_prepare_data_matches_jax(tmp_path):
    """A 4-frame capture at 96x128 whose frames are JPEG (quality 95, the
    port's encoder), with the image half of stage 1 on in both packages: the
    kept frames are the same files; best_ori/, conf/, Ori/ and the masks are
    JPEG under the frames' names at the JAX package's qualities (100 for
    best_ori/ and Ori/, 95 for conf/ and the masks: the same DQT segments);
    every written file decodes to cv2's pixels through the port's decoder, so
    PMVO's maps loaded from either package's files by the port's loaders equal
    the JAX package's loaders' bitwise. Between the packages the maps differ
    only where the Gabor bins and masks do on PNG
    (tests/test_torch_prepare_data.py: one bin, one LSB), and the DCT spreads
    such a difference over its block: after decoding, conf within 1 LSB,
    best_ori equal on >= 98% of the pixels with a confidence and within 3 bins
    there (measured: 1.4-1.6% differ, by at most 3), the masks as on PNG."""
    from monohair_tpu.config import Config as JaxConfig
    from monohair_tpu.io import image_io as jax_io
    from monohair_tpu.pipeline.prepare_data_stage import run_prepare_data as jax_stage
    from monohair_tpu_torch.io import image_io
    from monohair_tpu_torch.pipeline.common import case_paths
    from monohair_tpu_torch.pipeline.prepare_data_stage import run_prepare_data
    from monohair_tpu_torch.synthetic import write_capture_case
    port, ref = tmp_path / "port", tmp_path / "ref"
    out = write_capture_case(str(port), "cap", num_frames=4, H=96, W=128, ext=".JPG",
                             modnet=SHIPPED["modnet"], parser=SHIPPED["bisenet"])
    shutil.copytree(port, ref)
    cfg = out["config"]
    cfg.prepare_data.update(process_camera=True, render_depth=True)
    jcfg = JaxConfig(json.loads(json.dumps(cfg.to_dict()).replace(str(port), str(ref))))
    run_prepare_data(case_paths(cfg), device="cpu")
    jcfg.data["root"] = os.path.join(jcfg.data.root, jcfg.data.case)
    jax_stage(jcfg)
    port, ref = port / "cap", ref / "cap"
    frames = sorted(os.listdir(ref / "capture_images"))
    assert frames == sorted(os.listdir(port / "capture_images")) and len(frames) == 2
    assert all(f.endswith(".JPG") for f in frames)
    for f in frames:
        assert (port / "capture_images" / f).read_bytes() == (ref / "capture_images" / f).read_bytes()
        view = f[:-4]
        preview = (port / "render_depth" / (view + ".JPG")).read_bytes()
        assert preview[:2] == b"\xff\xd8"
        for sub, quality in (("best_ori", 100), ("Ori", 100), ("conf", 95), ("hair_mask", 95),
                             ("mask", 95)):
            a, b = ((d / sub / f).read_bytes() for d in (port, ref))
            assert a[:2] == b[:2] == b"\xff\xd8", (sub, f)
            assert dqt(a) == dqt(b) == dqt(encode_jpeg(np.zeros((8, 8, 3), np.uint8), quality)
                                           )[:len(dqt(a))], (sub, f)
            for data in (a, b):
                np.testing.assert_array_equal(decode_jpeg(data), cv_decode(data))
                np.testing.assert_array_equal(decode_jpeg(data, gray=True),
                                              cv_decode(data, cv2.IMREAD_GRAYSCALE))
    views = [f[:-4] for f in frames]
    for d in (port, ref):
        o_port, c_port = image_io.load_orientation_and_confidence(views, str(d / "best_ori"),
                                                                  str(d / "conf"))
        o_jax, c_jax = jax_io.load_orientation_and_confidence(views, str(d / "best_ori"),
                                                              str(d / "conf"))
        np.testing.assert_array_equal(o_port, o_jax)
        np.testing.assert_array_equal(c_port, c_jax)
        np.testing.assert_array_equal(image_io.load_masks(views, str(d / "hair_mask")),
                                      jax_io.load_masks(views, str(d / "hair_mask")))
    for f in frames:
        conf = [cv2.imread(str(d / "conf" / f), cv2.IMREAD_GRAYSCALE).astype(int) for d in (port, ref)]
        assert np.abs(conf[0] - conf[1]).max() <= 1, f
        ori = [cv2.imread(str(d / "best_ori" / f), cv2.IMREAD_GRAYSCALE).astype(int)
               for d in (port, ref)]
        diff = np.abs(ori[0] - ori[1])
        diff = np.minimum(diff, 180 - diff)
        seen = conf[1] > 0
        assert seen.mean() > 0.3 and (diff[seen] == 0).mean() >= 0.98, f
        assert diff[seen].max() <= 3, f
        m = [cv2.imread(str(d / "hair_mask" / f), cv2.IMREAD_GRAYSCALE).astype(int) for d in (port, ref)]
        d = np.abs(m[0] - m[1])
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, f
