"""Stage 1's image ops in the port against what the JAX package runs, on the
CPU: OpenCV's resizes, gray conversions and sharpness (ops/resize.py) against
cv2 itself, and the Gabor bank (ops/gabor.py) against monohair_tpu.ops.gabor.

Tolerances: every uint8 result is bitwise; float INTER_AREA and INTER_LINEAR
within 1e-6, INTER_CUBIC within 1e-3 (OpenCV's cubic sums differ from plain f32
sums by up to 2.2e-4 on 19 channels of unit-variance logits); the Laplacian
variance within 1e-9 relative. Gabor: DoG within 1e-6; bins equal on >= 99% of
the pixels whose written confidence is nonzero and within one bin there; conf
within 1e-4 where the bins agree."""

import math

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.io.image_io import encode_orientation_image as jax_encode
from monohair_tpu.ops import gabor as jax_gabor
from monohair_tpu_torch.io.image_io import encode_orientation_image, imread_gray, write_png
from monohair_tpu_torch.ops import gabor, resize

torch.set_num_threads(1)

# (H, W) -> (h, w): the capture frame to MODNet's input and back, the test
# case's frame (MODNet enlarges it), odd sizes, and exact factors (2x, 4x)
SIZES = [((720, 1280), (512, 896)), ((96, 128), (512, 672)), ((37, 53), (11, 20)),
         ((100, 150), (50, 50)), ((64, 80), (32, 40)), ((64, 80), (16, 20))]


def planar(img: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(img))
    return (t[..., None] if t.dim() == 2 else t).permute(2, 0, 1)[None]


def hwc(t: torch.Tensor) -> np.ndarray:
    return t[0].permute(1, 2, 0).numpy().squeeze(-1) if t.shape[1] == 1 \
        else t[0].permute(1, 2, 0).numpy()


@pytest.mark.parametrize("src,dst", SIZES)
def test_area_resize_matches_opencv(src, dst):
    rng = np.random.default_rng(0)
    (H, W), (h, w) = src, dst
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    for a, size in ((img, (h, w)), (img[:h, :w], (H, W))):     # shrink, enlarge
        ref = cv2.resize(a, size[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(hwc(resize.resize_area(planar(a), size)), ref)
    for a, size in ((rng.random((H, W)).astype(np.float32), (h, w)),
                    (rng.random((h, w)).astype(np.float32), (H, W))):
        ref = cv2.resize(a, size[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_allclose(hwc(resize.resize_area(planar(a), size)), ref,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", SIZES)
def test_linear_and_cubic_resize_match_opencv(src, dst):
    rng = np.random.default_rng(1)
    (H, W), (h, w) = src, dst
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    for size in ((512, 512), (h, w), (H + 7, W + 5)):
        ref = cv2.resize(img, size[::-1], interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(hwc(resize.resize_linear(planar(img), size)), ref)
    f = rng.normal(size=(H, W, 3)).astype(np.float32)
    ref = cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(hwc(resize.resize_linear(planar(f), (h, w))), ref,
                               rtol=0, atol=1e-6)
    logits = rng.normal(size=(h, w, 19)).astype(np.float32)
    ref = cv2.resize(logits, (W, H), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(hwc(resize.resize_cubic(planar(logits), (H, W))), ref,
                               rtol=0, atol=1e-3)


def test_gray_conversions_and_sharpness_match_opencv(tmp_path):
    """cvtColor(BGR2GRAY) and imread(IMREAD_GRAYSCALE) differ by 1 on about half
    of a random colour image's pixels; each is reproduced bitwise."""
    rng = np.random.default_rng(2)
    rgb = (rng.random((61, 83, 3)) * 255).astype(np.uint8)
    rgb[:5] = rgb[:5, :, :1]                                   # some gray pixels
    bgr = rgb[..., ::-1].copy()
    cv_gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(resize.bgr_to_gray(torch.from_numpy(bgr)).numpy(), cv_gray)
    path = str(tmp_path / "frame.png")
    write_png(path, rgb)
    cv_read = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(imread_gray(path), cv_read)
    np.testing.assert_array_equal(resize.png_rgb_to_gray(torch.from_numpy(rgb)).numpy(),
                                  cv_read)
    assert (cv_read != cv_gray).mean() > 0.3                  # two different rules
    ref = cv2.Laplacian(cv_gray, cv2.CV_64F).var()
    got = float(resize.laplacian_variance(torch.from_numpy(cv_gray)))
    assert abs(got - ref) <= 1e-9 * ref


def stripes(theta_deg, H=64, W=80, lam=4.0):
    t = math.radians(theta_deg)
    r, c = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return (0.5 + 0.5 * np.cos((r * math.cos(t) + c * math.sin(t)) * 2 * math.pi / lam)
            ).astype(np.float32)


def bins(angle: np.ndarray) -> np.ndarray:
    return encode_orientation_image(angle).astype(int)


@pytest.mark.parametrize("image", ["stripes30", "stripes120", "noise"])
def test_gabor_matches_jax(image):
    rng = np.random.default_rng(3)
    img = (rng.random((64, 80)).astype(np.float32) if image == "noise"
           else stripes(int(image[7:])))
    np.testing.assert_allclose(
        gabor.difference_of_gaussians(torch.from_numpy(img)).numpy(),
        np.asarray(jax_gabor.difference_of_gaussians(jnp.asarray(img))), rtol=0, atol=1e-6)
    two_j, ang_j, conf_j = (np.asarray(x) for x in jax_gabor.orientation_maps(jnp.asarray(img)))
    two, ang, conf = (x.numpy() for x in gabor.orientation_maps(torch.from_numpy(img)))
    # the written maps: the encoding of the same f32 angle is the JAX package's
    np.testing.assert_array_equal(encode_orientation_image(ang_j), jax_encode(ang_j))
    d = np.abs(bins(ang) - bins(ang_j))
    d = np.minimum(d, 180 - d)
    seen = (conf_j * 255).astype(np.uint8) > 0
    assert seen.mean() > 0.5
    assert (d[seen] == 0).mean() >= 0.99 and d[seen].max() <= 1
    np.testing.assert_allclose(conf[d == 0], conf_j[d == 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(two[d == 0], two_j[d == 0], rtol=0, atol=1e-6)


def test_gabor_bank_is_the_jax_bank():
    np.testing.assert_array_equal(gabor.gabor_bank(), jax_gabor.gabor_bank())
    np.testing.assert_array_equal(gabor.gaussian_kernel1d(10.0),
                                  jax_gabor.gaussian_kernel1d(10.0))
