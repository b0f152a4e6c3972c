"""The port's rasterizer and render passes (monohair_tpu_torch.ops.rasterize,
monohair_tpu_torch.render) against the JAX package's on the CPU, on small
scenes, including pixels that several fragments win at one depth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.camera import Cameras as JCameras
from monohair_tpu.ops import rasterize as jr
from monohair_tpu.render import render_data as j_render_data
from monohair_tpu.render import strands_to_segments as j_segments
from monohair_tpu_torch.camera import Cameras
from monohair_tpu_torch.io.image_io import read_png
from monohair_tpu_torch.ops import rasterize as tr
from monohair_tpu_torch.render import MAP_NAMES, render_data, strands_to_segments
from monohair_tpu_torch.synthetic import ring_camera_list

torch.set_num_threads(1)


def cameras(num_views=3):
    cl = ring_camera_list(num_views)
    return JCameras.from_json_list(cl), Cameras.from_json_list(cl, "cpu")


def blob_mesh(rng, n=300, faces=500, scale=0.15):
    return ((rng.normal(size=(n, 3)) * scale).astype(np.float32),
            rng.integers(0, n, (faces, 3)))


@pytest.mark.parametrize("size", [(96, 80), (75, 41)])
def test_mesh_depth_matches_jax(rng, size):
    """Same coverage, depths within rtol 1e-5; one size is not a power-of-two
    multiple of the coarse levels."""
    jc, tc = cameras()
    verts, faces = blob_mesh(rng)
    for v in range(3):
        zj = np.asarray(jr.rasterize_mesh_depth(jc[v], verts, faces, size))
        zt = tr.rasterize_mesh_depth(tc[v], verts, faces, size).numpy()
        np.testing.assert_array_equal(np.isfinite(zt), np.isfinite(zj))
        assert np.isfinite(zj).mean() > 0.1
        fin = np.isfinite(zj)
        np.testing.assert_allclose(zt[fin], zj[fin], rtol=1e-5, atol=0)


def test_strand_depth_colors_and_tangent_colors_match_jax(rng):
    jc, tc = cameras()
    M = 3000
    s = (rng.normal(size=(M, 3)) * 0.1).astype(np.float32)
    e = s + (rng.normal(size=(M, 3)) * 0.02).astype(np.float32)
    for v in range(3):
        for mode in (1, 2, 3):
            np.testing.assert_allclose(
                tr.segment_tangent_colors(tc[v], s, e - s, mode).numpy(),
                np.asarray(jr.segment_tangent_colors(jc[v], s, e - s, mode)), atol=1e-4)
        colors = np.array(jr.segment_tangent_colors(jc[v], s, e - s, 2))
        zj, cj = jr.rasterize_strands(jc[v], None, s, e, jnp.asarray(colors), (96, 80),
                                      chunk=1000)
        zt, ct = tr.rasterize_strands(tc[v], s, e, torch.from_numpy(colors), (96, 80),
                                      chunk=1000)
        zj, zt = np.asarray(zj), zt.numpy()
        np.testing.assert_array_equal(np.isfinite(zt), np.isfinite(zj))
        fin = np.isfinite(zj)
        np.testing.assert_allclose(zt[fin], zj[fin], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("chunk", [2, 5, 262144])
def test_duplicate_winners_resolve_as_jax_does(chunk):
    """Overlapping segments of distinct colors at one depth: every pixel takes
    the last winning fragment in fragment order, across chunks in chunk order,
    which is what the JAX package's scatter gives on the CPU."""
    jc, tc = cameras(1)
    base_s = np.array([[-0.05, 0.0, 0.0], [0.0, -0.05, 0.0]], np.float32)
    base_e = np.array([[0.05, 0.0, 0.0], [0.0, 0.05, 0.0]], np.float32)
    s = np.concatenate([base_s] * 3 + [base_s[:1] + [0.0, 0.002, 0.0]])
    e = np.concatenate([base_e] * 3 + [base_e[:1] + [0.0, 0.002, 0.0]])
    colors = ((np.arange(len(s))[:, None] + np.array([1, 2, 3])) / 10).astype(np.float32)
    zj, cj = jr.rasterize_strands(jc[0], None, s, e, jnp.asarray(colors), (64, 64), chunk=chunk)
    zt, ct = tr.rasterize_strands(tc[0], s, e, torch.from_numpy(colors), (64, 64), chunk=chunk)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # the earlier copies of a segment never win; the last vertical copy does
    won = {int(round(c[0] * 10)) - 1 for c in ct.numpy().reshape(-1, 3) if c.any()}
    assert won <= {4, 5, 6} and 5 in won


def test_compose_and_segments_match_jax(rng):
    z = np.array([[1.0, np.inf], [0.3, 2.5]], np.float32)
    np.testing.assert_array_equal(
        tr.compose_depth_to_image(torch.from_numpy(z), 1.0, 2.0).numpy(),
        np.asarray(jr.compose_depth_to_image(jnp.asarray(z), 1.0, 2.0)))
    strands = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 1, 9, 2)]
    for a, b in zip(strands_to_segments(strands), j_segments(strands)):
        np.testing.assert_array_equal(a, b)
    for a in strands_to_segments([]):
        assert a.shape == (0, 3)


def head_scene(rng):
    """A bust quad behind a ball of short strands."""
    bv = np.array([[-0.3, -0.3, -0.1], [0.3, -0.3, -0.1], [0.3, 0.3, -0.1],
                   [-0.3, 0.3, -0.1]], np.float32)
    bf = np.array([[0, 1, 2], [0, 2, 3]])
    verts, faces = blob_mesh(rng, 200, 300, 0.06)
    roots = (rng.normal(size=(150, 3)) * 0.08).astype(np.float32)
    steps = (rng.normal(size=(150, 1, 3)) * 0.01).astype(np.float32)
    strands = list(roots[:, None] + np.cumsum(np.repeat(steps, 8, 1), 1))
    return (np.concatenate([bv, verts]), np.concatenate([bf, faces + 4]), strands)


def test_render_data_and_its_pngs_match_jax(rng, tmp_path):
    """The four maps per view within 2e-5 (the double-angle colors come from
    atan2/cos/sin), and the written PNGs: >= 99.9% of pixels equal, none more
    than one step apart (the truncating 8-bit write moves a value that
    straddles a step)."""
    jc, tc = cameras(3)
    bust_v, bust_f, strands = head_scene(rng)
    names = ["000", "001", "002"]
    ours = render_data(tc, names, strands, bust_v, bust_f, (72, 56), str(tmp_path / "t"))
    theirs = j_render_data(jc, names, strands, bust_v, bust_f, (72, 56), str(tmp_path / "j"))
    for view in names:
        assert 0 < ours[view]["mask"].mean() < 1
        for name in MAP_NAMES:
            np.testing.assert_allclose(ours[view][name], theirs[view][name], rtol=0, atol=2e-5)
            a = read_png(str(tmp_path / "t" / view / f"{name}.png")).astype(int)
            b = read_png(str(tmp_path / "j" / view / f"{name}.png")).astype(int)
            assert a.shape == b.shape
            assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1, (view, name)
