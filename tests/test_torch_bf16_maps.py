"""PMVO.bf16_maps in the port against the JAX package's, on the CPU.

The maps are stored in bf16 and every consumer follows the JAX package's
promotion (monohair_tpu/pmvo/solver.py: the gathered windows are upcast to
f32; a bf16 map value meets f32 camera math as f32). What is exact: the plain
bf16 gather (gather, then .float()) equals the JAX reference's gather and
cast bit for bit, since bf16 -> f32 loses nothing, and the maps' bf16 values
are the same in both (both round f32 to nearest even). What is not: the f32
arithmetic after the gather differs between PyTorch and XLA's CPU code as it
does with f32 maps, so the line search is held at the f32 tolerances of
tests/test_torch_pmvo_stage.py (orientations within cos 0.999 on >= 99% of
the points, losses within 1e-5 where they agree), and the stage's grids at
IoU >= 0.99 and median |cos| >= 0.999. The maps are bf16 only after the f32
gather has rounded them, so XLA's excess precision in fused bf16 code has no
bf16 arithmetic to act on: the gather only moves bf16 values."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.ops.pallas_kernels import patch_gather_reference
from monohair_tpu.pmvo import driver as jdrv, solver as js
from monohair_tpu_torch.ops import patch_kernels as pk
from monohair_tpu_torch.pmvo import driver as tdrv, solver as ts
from tests.test_torch_pmvo_cli import WIG, synthwig_case  # noqa: F401  (fixture)
from tests.test_torch_pmvo_stage import iou, wig_scene

torch.set_num_threads(1)


def test_plain_bf16_gather_equals_the_jax_reference():
    rng = np.random.default_rng(4)
    V, H, W, N, patch = 3, 40, 52, 300, 7
    maps = (rng.normal(size=(V, H + patch - 1, W + patch - 1, 8)) * 50).astype(np.float32)
    maps[0, 0, 0, :3] = [np.inf, -np.inf, 1e-40]          # specials and a subnormal
    rc = np.stack([rng.integers(0, H, (V, N)), rng.integers(0, W, (V, N))], -1).astype(np.int32)
    jm = jnp.asarray(maps).astype(jnp.bfloat16)
    want = np.asarray(patch_gather_reference(jm, jnp.asarray(rc), patch).astype(jnp.float32))
    tm = torch.from_numpy(maps).to(torch.bfloat16)
    got = pk.patch_gather(tm, torch.from_numpy(rc), patch)      # CPU: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # the stored values round as JAX rounds them
    np.testing.assert_array_equal(tm.float().numpy(), np.asarray(jm.astype(jnp.float32)))


@pytest.fixture(scope="module")
def wig_bf16():
    jmaps, tmaps, queries = wig_scene()
    return jmaps.astype(jnp.bfloat16), tmaps.astype(torch.bfloat16), queries


def test_observe_points_and_filters_on_bf16_maps(wig_bf16):
    jmaps, tmaps, queries = wig_bf16
    assert tmaps.depth.dtype == tmaps.ori2d.dtype == tmaps.conf.dtype == torch.bfloat16
    assert tmaps.cameras.w2c.dtype == torch.float32
    pts = queries[::7]
    a = js.observe_points(jmaps, jnp.asarray(pts), 3, use_pallas=False)
    b = ts.observe_points(tmaps, torch.from_numpy(pts), 3)
    np.testing.assert_array_equal(b["rc"].numpy(), np.asarray(a["rc"]))
    for k in ("depth", "ori", "conf", "mask", "ori_patch", "conf_patch"):
        assert b[k].dtype == torch.float32, k
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)
    np.testing.assert_allclose(b["visible"].numpy(), np.asarray(a["visible"]),
                               rtol=1e-5, atol=1e-5)
    sj, fj = jdrv.filter_raw_points(jmaps, queries, 3, 0.4, 1.0, chunk=2048)
    st, ft = tdrv.filter_raw_points(tmaps, queries, 3, 0.4, 1.0, chunk=2048)
    assert (st == sj).mean() > 0.999 and (ft == fj).mean() > 0.999
    uj = np.asarray(js.compute_unvisible_points(jmaps, jnp.asarray(queries)))
    ut = ts.compute_unvisible_points(tmaps, torch.from_numpy(queries)).numpy()
    assert (uj == ut).mean() > 0.999


def test_pmvo_forward_and_drivers_on_bf16_maps(wig_bf16):
    jmaps, tmaps, queries = wig_bf16
    sj, _ = jdrv.filter_raw_points(jmaps, queries, 3, 0.4, 1.0, chunk=2048)
    pts = queries[sj][::3]
    pj, oj, lj, _ = js.pmvo_forward(jmaps, jnp.asarray(pts), 3, 0.4, use_pallas=False)
    pt, ot, lt, _ = ts.pmvo_forward(tmaps, torch.from_numpy(pts), 3, 0.4)
    cos = np.abs(np.sum(ot.numpy() * np.asarray(oj), -1))
    assert (cos > 0.999).mean() >= 0.99, (cos > 0.999).mean()
    np.testing.assert_allclose(lt.numpy()[cos > 0.999], np.asarray(lj)[cos > 0.999],
                               rtol=1e-5, atol=1e-5)
    # refine + voxelize on the JAX line search's result, in both packages
    pj, oj, lj, _ = jdrv.optimize_points(jmaps, pts, 3, 0.4, chunk=2048)
    occ_j, ori_j = jdrv.refine_and_voxelize(jmaps, pj, oj, lj, None, 3, 0.4, 1.0,
                                            threshold=0.1, chunk=2048)
    occ_t, ori_t = tdrv.refine_and_voxelize(tmaps, pj, oj, lj, None, 3, 0.4, 1.0,
                                            threshold=0.1, chunk=2048)
    a, b = occ_j > 0, occ_t > 0
    assert iou(a, b) >= 0.99 and a.sum() > 500
    assert np.median(np.abs(np.sum(ori_j[a & b] * ori_t[a & b], -1))) >= 0.999


def test_run_pmvo_with_bf16_maps_matches_jax(synthwig_case):
    """The stage on the written synthwig case, --PMVO.bf16_maps in both
    packages: the same refine/ grids up to the line search's f32 differences."""
    from monohair_tpu.io.mat_io import load_occ_mat, load_ori_mat
    from monohair_tpu.pipeline.common import resolve_config as jax_resolve
    from monohair_tpu.pipeline.pmvo_stage import run_pmvo as jax_run_pmvo
    from monohair_tpu_torch.pipeline.common import resolve_config
    from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
    flags = ["--yaml=configs/reconstruct/synthwig", "--PMVO.bf16_maps"]
    out = synthwig_case / "data/synthwig/output/verify/refine"
    jax_run_pmvo(jax_resolve(flags))
    occ_j, ori_j = load_occ_mat(str(out / "Occ3D.mat")), load_ori_mat(str(out / "Ori3D.mat"))
    run_pmvo(resolve_config(flags), device="cpu")
    occ_t, ori_t = load_occ_mat(str(out / "Occ3D.mat")), load_ori_mat(str(out / "Ori3D.mat"))
    a, b = occ_j > 0, occ_t > 0
    assert iou(a, b) >= 0.99 and b.sum() > 500, iou(a, b)
    assert np.median(np.abs(np.sum(ori_j[a & b] * ori_t[a & b], -1))) >= 0.999
    assert np.median(np.abs(ori_t[b] @ WIG)) > 0.95
