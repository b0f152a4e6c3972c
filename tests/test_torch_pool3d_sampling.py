"""The port's training-data modules against the JAX package's on the CPU:
pool3d (monohair_tpu_torch.ops.pool3d) against the torch golden and the JAX
functions, the occ/ori samplers bitwise, union_data's packed files byte for
byte on PNGs written by cv2, and the quality metrics (cv2.blur's box filter
written out for SSIM)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.mvs import sampling as jsampling
from monohair_tpu.mvs import union_data as junion
from monohair_tpu.ops import pool3d as jpool
from monohair_tpu.utils import metrics as jmetrics
from monohair_tpu_torch.mvs import sampling as tsampling
from monohair_tpu_torch.mvs import union_data as tunion
from monohair_tpu_torch.ops import pool3d as tpool
from monohair_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def _golden(name):
    return np.load(os.path.join(os.path.dirname(__file__), "golden", name))


@pytest.mark.parametrize("k", [3, 5])
def test_pool3d_matches_the_torch_golden(k):
    """tests/golden/pool3d.npz (torch's F.max_pool3d/avg_pool3d, stride 1,
    same padding): the max pool exact, the average within 1e-6."""
    d = _golden("pool3d.npz")
    vol = torch.from_numpy(d["vol"])
    np.testing.assert_array_equal(tpool.max_pool3d(vol, k).numpy(), d[f"max{k}"])
    np.testing.assert_allclose(tpool.avg_pool3d(vol, k).numpy(), d[f"avg{k}"],
                               rtol=1e-6, atol=1e-6)


def occupancy(rng, shape=(20, 18, 16), p=0.08):
    occ = (rng.random(shape) < p).astype(np.float32)
    occ[6:12, 5:11, 4:10] = 1.0
    return occ


@pytest.mark.parametrize("k", [3, 5])
def test_pool3d_matches_jax(k):
    """On a random occupancy with a solid block: the max pool, closing and
    shell (with and without closing and erosion) exact; the average within
    1e-6 (the sums of 0/1 voxels are exact, the division is rounded once)."""
    occ = occupancy(np.random.default_rng(k))
    t, j = torch.from_numpy(occ), jnp.asarray(occ)
    np.testing.assert_array_equal(tpool.max_pool3d(t, k).numpy(),
                                  np.asarray(jpool.max_pool3d(j, k)))
    np.testing.assert_allclose(tpool.avg_pool3d(t, k).numpy(),
                               np.asarray(jpool.avg_pool3d(j, k)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tpool.close_volume(t, k).numpy(),
                                  np.asarray(jpool.close_volume(j, k)))
    for close in (True, False):
        for erosion in (True, False):
            np.testing.assert_array_equal(
                tpool.shell_voxels(t, k, close, erosion).numpy(),
                np.asarray(jpool.shell_voxels(j, k, close, erosion)))


@pytest.mark.parametrize("seed", [0, 7])
def test_occ_sampler_is_bitwise_the_jax_one(seed):
    """sample_occ_training_points: the points and labels equal the JAX
    package's bitwise (the draws are numpy's default_rng in both), with 6
    positives a voxel first."""
    occ = occupancy(np.random.default_rng(seed + 1))
    pts, labels = tsampling.sample_occ_training_points(occ, seed=seed)
    jpts, jlabels = jsampling.sample_occ_training_points(occ, seed=seed)
    assert pts.dtype == jpts.dtype == np.float32 and labels.dtype == np.int32
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(labels, jlabels)
    assert labels[:6 * int(occ.sum())].all() and not labels[6 * int(occ.sum()):].any()


def test_ori_sampler_is_bitwise_the_jax_one():
    """sample_ori_training_points on a closed occupancy whose interior holds no
    direction: only the voxels with |ori| > 1e-6 are sampled, bitwise as the
    JAX package samples them."""
    rng = np.random.default_rng(3)
    occ = occupancy(rng)
    ori = rng.normal(size=occ.shape + (3,)).astype(np.float32) * (rng.random(occ.shape) < 0.5)[..., None]
    pts, dirs = tsampling.sample_ori_training_points(occ, ori, seed=2)
    jpts, jdirs = jsampling.sample_ori_training_points(occ, ori, seed=2)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(dirs, jdirs)
    assert 0 < len(pts) < 6 * int(occ.sum())


def write_views(root, rng, views=3, H=12, W=10):
    """PNGs written by cv2: dense.png RGB, raw_conf/mask gray, the two depth
    maps RGB (read as gray with libpng's weights) and one gray-valued RGB."""
    import cv2
    for v in range(views):
        vd = os.path.join(root, f"{v:03d}")
        os.makedirs(vd)
        cv2.imwrite(os.path.join(vd, "dense.png"), rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        for name in ("raw_conf", "mask"):
            cv2.imwrite(os.path.join(vd, name + ".png"),
                        rng.integers(0, 256, (H, W), dtype=np.uint8))
        cv2.imwrite(os.path.join(vd, "bust_depth.png"),
                    rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        gray = rng.integers(0, 256, (H, W, 1), dtype=np.uint8)
        cv2.imwrite(os.path.join(vd, "bust_hair_depth.png"), np.repeat(gray, 3, -1))


def test_union_packing_is_byte_for_byte_the_jax_one(tmp_path):
    """pack_case on cv2-written PNGs: every .dat file (and the copied
    model_tsfm.dat) equal to the JAX package's byte for byte; load_union_case
    reads both back equal; a missing PNG raises FileNotFoundError, as cv2's
    None does in the JAX package."""
    rng = np.random.default_rng(4)
    write_views(str(tmp_path / "views"), rng)
    tsfm = tmp_path / "model_tsfm.dat"
    rng.normal(size=16).astype(np.float32).tofile(tsfm)
    t_names = tunion.pack_case(str(tmp_path / "views"), str(tmp_path / "t"),
                               model_tsfm_src=str(tsfm))
    j_names = junion.pack_case(str(tmp_path / "views"), str(tmp_path / "j"),
                               model_tsfm_src=str(tsfm))
    assert t_names == j_names and len(t_names) == 6
    for name in t_names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    t = tunion.load_union_case(str(tmp_path / "t"), 3, (12, 10))
    j = junion.load_union_case(str(tmp_path / "j"), 3, (12, 10))
    assert sorted(t) == sorted(j) == ["conf", "depth", "hair_depth", "mask", "model_tsfm",
                                      "orient"]
    for key in t:
        np.testing.assert_array_equal(t[key], j[key])
    os.remove(tmp_path / "views" / "001" / "raw_conf.png")
    with pytest.raises(FileNotFoundError):
        tunion.pack_case(str(tmp_path / "views"), str(tmp_path / "x"), modalities=("conf",))


def test_metrics_match_the_jax_functions():
    """OccMetric, direction_cosine_error and psnr equal the JAX package's;
    ssim (cv2.blur written out with BORDER_REFLECT_101) within 1e-12, on gray
    and RGB images whose sides are not multiples of the window."""
    rng = np.random.default_rng(5)
    tm, jm = tmetrics.OccMetric(), jmetrics.OccMetric()
    for _ in range(3):
        pred, gt = rng.random(50) - 0.5, rng.random(50) - 0.4
        tm.update(pred, gt)
        jm.update(pred, gt)
    assert tm.summary() == jm.summary()
    a, b = rng.normal(size=(40, 3)), rng.normal(size=(40, 3))
    assert tmetrics.direction_cosine_error(a, b) == jmetrics.direction_cosine_error(a, b)
    for shape in ((23, 31), (17, 29, 3)):
        img = rng.random(shape)
        ref = np.clip(img + rng.normal(size=shape) * 0.05, 0, 1)
        assert tmetrics.psnr(img, ref) == jmetrics.psnr(img, ref)
        assert abs(tmetrics.ssim(img, ref) - jmetrics.ssim(img, ref)) <= 1e-12
        assert abs(tmetrics.ssim(img, img) - 1.0) < 1e-12


@pytest.mark.parametrize("shape", [(32, 32), (9, 14), (5, 5)])
def test_box_blur_is_cv2_blur(shape):
    """box_blur against cv2.blur(img, (7, 7)) on float64 images, within 1e-12:
    the reflected border (no repeated edge pixel) decides the rim."""
    import cv2
    img = np.random.default_rng(6).random(shape)
    np.testing.assert_allclose(tmetrics.box_blur(img, 7), cv2.blur(img, (7, 7)),
                               rtol=0, atol=1e-12)
