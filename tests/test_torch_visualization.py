"""The port's debug exports (monohair_tpu_torch/visualization.py) write the
JAX package's bytes on the same arrays; the occupancy slices, PNGs from two
writers, are compared as decoded pixels."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import cv2
import numpy as np
import pytest

from monohair_tpu import visualization as jvis
from monohair_tpu_torch import visualization as tvis


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ply_exports_write_the_jax_bytes(tmp_path, rng, dtype):
    pts = (rng.random((40, 3)) - 0.5).astype(dtype)
    dirs = (rng.random((40, 3)) * 2 - 1).astype(dtype)
    colors = rng.random((40, 3)) * 1.2 - 0.1           # clipped to [0, 1] in both
    strands = [rng.random((n, 3)).astype(dtype) for n in (5, 1, 3, 9)]
    for name, fn, args in (("p", "save_ply_points", (pts,)),
                           ("c", "save_ply_points", (pts, colors)),
                           ("o", "save_oriented_points", (pts, dirs)),
                           ("s", "save_strands_ply", (strands,))):
        a, b = tmp_path / f"{name}_t.ply", tmp_path / f"{name}_j.ply"
        getattr(tvis, fn)(str(a), *args)
        getattr(jvis, fn)(str(b), *args)
        assert a.read_bytes() == b.read_bytes(), name
    assert b"element edge 14" in (tmp_path / "s_t.ply").read_bytes()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_occ_slices_decode_to_the_jax_pixels(tmp_path, rng, axis):
    occ = (rng.random((20, 24, 16)) > 0.6).astype(np.float32)
    tvis.save_occ_slices(str(tmp_path / "t"), occ, axis=axis, num=4)
    jvis.save_occ_slices(str(tmp_path / "j"), occ, axis=axis, num=4)
    for i in range(4):
        a = cv2.imread(str(tmp_path / f"t_slice{i}.png"), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / f"j_slice{i}.png"), cv2.IMREAD_UNCHANGED)
        assert a.dtype == np.uint8 and a.shape == b.shape and a.ndim == 2
        np.testing.assert_array_equal(a, b)
