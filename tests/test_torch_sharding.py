"""The point-axis sharding (monohair_tpu_torch/parallel/sharding.py) on the
CPU: a mesh of k shards, here (cpu,) * 3, gives the unsharded results bit
for bit through the PMVO drivers, the stage and deep_mvs_eval, and equals the
JAX package's run on its 8-device CPU mesh within the parity tolerances of
tests/test_torch_pmvo_stage.py and tests/test_torch_mvs_eval.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.mvs import eval as jeval
from monohair_tpu.parallel.sharding import data_mesh as jax_mesh
from monohair_tpu.pmvo import driver as jdrv
from monohair_tpu_torch.mvs import eval as teval
from monohair_tpu_torch.parallel import sharding
from monohair_tpu_torch.pmvo import driver as tdrv
from tests.test_torch_mvs_eval import tiny_nets
from tests.test_torch_pmvo_stage import iou, wig_scene

torch.set_num_threads(1)
CPU3 = (torch.device("cpu"),) * 3


def test_shard_batch_and_replicate():
    x = torch.arange(20.0).reshape(10, 2)
    parts = sharding.shard_batch(x, CPU3)
    assert [len(p) for p in parts] == [4, 3, 3]
    assert torch.equal(torch.cat(parts), x)
    assert sharding.shard_batch(x, None)[0] is x
    _, tmaps, _ = wig_scene()
    reps = sharding.replicate(tmaps, CPU3)
    assert len(reps) == 3 and all(r is reps[0] for r in reps)     # one copy a device
    assert reps[0].depth is tmaps.depth                            # already there
    assert sharding.replicate(tmaps, None) == (tmaps,)
    assert [tuple(t.shape) for t in sharding.concat_shards([(x[:4], x[:4, 0]),
                                                            (x[4:], x[4:, 0])])] == [(10, 2), (10,)]
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.data_mesh()


@pytest.fixture(scope="module")
def wig():
    jmaps, tmaps, queries = wig_scene()
    return jmaps, tmaps, queries


def test_pmvo_drivers_sharded_equal_unsharded_and_jax(wig):
    jmaps, tmaps, queries = wig
    s1, f1 = tdrv.filter_raw_points(tmaps, queries, 3, 0.4, 1.0, chunk=2048)
    s3, f3 = tdrv.filter_raw_points(tmaps, queries, 3, 0.4, 1.0, chunk=2048, mesh=CPU3)
    np.testing.assert_array_equal(s3, s1)
    np.testing.assert_array_equal(f3, f1)
    pts = queries[s1]
    one = tdrv.optimize_points(tmaps, pts, 3, 0.4, chunk=1000)
    three = tdrv.optimize_points(tmaps, pts, 3, 0.4, chunk=1000, mesh=CPU3)
    for a, b in zip(three, one):
        np.testing.assert_array_equal(a, b)
    pj, oj, lj, _ = jdrv.optimize_points(jmaps, pts, 3, 0.4, chunk=1024, mesh=jax_mesh())
    np.testing.assert_array_equal(three[0], pj)
    cos = np.abs(np.sum(three[1] * oj, -1))
    assert (cos > 0.999).mean() >= 0.99, (cos > 0.999).mean()
    np.testing.assert_allclose(three[2][cos > 0.999], lj[cos > 0.999], rtol=1e-5, atol=1e-5)

    _, p, o, l = (None,) + one[:3]
    coarse = np.concatenate([queries[::5], np.tile([[0.0, -1.0, 0.0, 1.0]],
                                                   (len(queries[::5]), 1))], 1).astype(np.float32)
    grids = [tdrv.refine_and_voxelize(tmaps, p, o, l, queries[f1], 3, 0.4, 1.0, threshold=0.1,
                                      coarse_raw=coarse, chunk=700, mesh=mesh)
             for mesh in (None, CPU3)]
    np.testing.assert_array_equal(grids[1][0], grids[0][0])
    np.testing.assert_array_equal(grids[1][1], grids[0][1])
    assert grids[0][0].sum() > 500


def test_run_pmvo_on_a_mesh_equals_the_unsharded_stage(tmp_path):
    from monohair_tpu_torch.io.mat_io import load_occ_mat, load_ori_mat
    from monohair_tpu_torch.pipeline.common import case_paths
    from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
    from monohair_tpu_torch.synthetic import write_synthwig_case
    cfg = case_paths(write_synthwig_case(str(tmp_path), num_views=6))
    grids = []
    for mesh in (None, CPU3):
        run_pmvo(cfg, device="cpu", mesh=mesh)
        out = tmp_path / "synthwig" / "output" / "verify" / "refine"
        grids.append((load_occ_mat(str(out / "Occ3D.mat")), load_ori_mat(str(out / "Ori3D.mat"))))
    np.testing.assert_array_equal(grids[1][0], grids[0][0])
    np.testing.assert_array_equal(grids[1][1], grids[0][1])
    assert grids[0][0].sum() > 100


def test_deep_mvs_eval_sharded_equals_unsharded_and_jax(tmp_path, rng):
    j_in, t_in, ((jo, jov, to), (jr, jrv, tr)) = tiny_nets(rng)
    queries = ((rng.random((70, 3)) - 0.5) * 0.2).astype(np.float32)
    queries[:, 2] -= 1.0
    kw = dict(query_points=queries, batch=32, vsize=0.1,
              bbox_min=np.array([-0.32, -0.32, -1.24], np.float32),
              bbox_max=np.array([0.32, 0.32, -0.76], np.float32))
    one = teval.deep_mvs_eval(t_in, to, tr, **kw)
    three = teval.deep_mvs_eval(t_in, to, tr, mesh=CPU3, **kw)
    for a, b in zip(three, one):
        np.testing.assert_array_equal(a, b)
    jp, jori, jocc = jeval.deep_mvs_eval(j_in, jo, jov, jr, jrv, mesh=jax_mesh(), **kw)
    np.testing.assert_array_equal(three[0], jp)
    assert (three[2] == jocc).mean() >= 0.999
    np.testing.assert_allclose(three[1], jori, rtol=1e-4, atol=1e-5)
