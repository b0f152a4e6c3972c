"""The last public functions of the JAX package that had no counterpart in the
port, each against the JAX function on the CPU on seeded numpy inputs:
camera.projection_matrix / normalized_depth / depth_to_z,
coords.grid_world_bounds, io.mesh_io.face_normals / vertex_normals,
ops.voxelize.mean_direction, nerf.train.psnr (utils.metrics' own),
segment.annotations.landmarks_to_training_targets,
segment.runners.save_flax_tree / load_flax_tree, models.unet.ShallowEncoder
and checkpoint.save_nerf_snapshot / load_nerf_snapshot.

Tolerances: float32 arithmetic of the same formulas, rtol 1e-6 (exact where
the operation is; the ShallowEncoder's two 5x5 convolutions a stage within
rtol 1e-4 / atol 1e-5). The flax-tree files hold the same members in the same
order with the same bytes in both directions (the zip's timestamps aside);
a NeRF snapshot written by either package loads in the other to the same
weights and the same treedef string."""

import zipfile

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu import camera as jcamera
from monohair_tpu import coords as jcoords
from monohair_tpu.io import mesh_io as jmesh_io
from monohair_tpu.nerf import train as jtrain
from monohair_tpu.ops import voxelize as jvoxelize
from monohair_tpu.segment import annotations as jannotations
from monohair_tpu_torch import camera, coords
from monohair_tpu_torch.io import mesh_io
from monohair_tpu_torch.nerf import train
from monohair_tpu_torch.ops import voxelize
from monohair_tpu_torch.segment import annotations
from monohair_tpu_torch.utils import metrics

torch.set_num_threads(1)


def _mesh(rng):
    v = rng.normal(size=(30, 3))
    f = np.stack([rng.permutation(30)[:3] for _ in range(50)])
    return v, f


def _dirs(rng):
    d = rng.normal(size=(40, 6, 3)).astype(np.float32)
    d[0, 1] = -d[0, 0]               # a member opposite the first one
    d[1, 2] = 0.0                    # a zero member (sign 0)
    return d


CASES = {
    "projection_matrix": (lambda rng: (rng.normal(size=(5, 4)).astype(np.float32),),
                          jcamera.projection_matrix, camera.projection_matrix),
    "normalized_depth": (lambda rng: (-rng.random((4, 7)).astype(np.float32) * 2,),
                         jcamera.normalized_depth, camera.normalized_depth),
    "depth_to_z": (lambda rng: (rng.random((4, 7)).astype(np.float32) * 255,),
                   jcamera.depth_to_z, camera.depth_to_z),
    "grid_world_bounds": (lambda rng: (), jcoords.grid_world_bounds, coords.grid_world_bounds),
    "face_normals": (_mesh, jmesh_io.face_normals, mesh_io.face_normals),
    "vertex_normals": (_mesh, jmesh_io.vertex_normals, mesh_io.vertex_normals),
    "mean_direction": (lambda rng: (_dirs(rng),), jvoxelize.mean_direction,
                       voxelize.mean_direction),
    "psnr": (lambda rng: (rng.random((6, 8, 3)), rng.random((6, 8, 3))), jtrain.psnr,
             train.psnr),
}


def _as_port(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) and x.dtype == np.float32 else x


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name, rng):
    make, jfn, fn = CASES[name]
    args = make(rng)
    want = jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray) and a.dtype == np.float32 else a
                 for a in args])
    got = fn(*[_as_port(a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    if name == "psnr":
        assert train.psnr is metrics.psnr


def test_landmarks_to_training_targets_matches_jax(tmp_path, rng):
    views = ["000", "003", "007"]
    for v in views:
        np.save(tmp_path / f"{v}.npy", rng.normal(size=(68, 2)))
    want = jannotations.landmarks_to_training_targets(str(tmp_path), views)
    got = annotations.landmarks_to_training_targets(str(tmp_path), views)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def test_flax_tree_files_cross_load(tmp_path, rng):
    from monohair_tpu.segment import runners as jrunners
    from monohair_tpu_torch.segment import runners
    tree = {"params": {"conv": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                                "bias": np.zeros(4, np.float32)}},
            "batch_stats": {"bn": {"mean": rng.normal(size=4), "var": np.ones(4)}}}
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    runners.save_flax_tree(ours, tree)
    jrunners.save_flax_tree(theirs, tree)
    assert _members(ours) == _members(theirs)
    for load in (runners.load_flax_tree, jrunners.load_flax_tree):
        for path in (ours, theirs):
            back = load(path)
            assert back.keys() == tree.keys()
            np.testing.assert_array_equal(back["params"]["conv"]["kernel"],
                                          tree["params"]["conv"]["kernel"])
            np.testing.assert_array_equal(back["batch_stats"]["bn"]["mean"],
                                          tree["batch_stats"]["bn"]["mean"])


def test_shallow_encoder_matches_jax(rng):
    from monohair_tpu.models.unet import ShallowEncoder as JaxShallow
    from monohair_tpu_torch.models.convert import load_weights, shallow_encoder_state_from_flax
    from monohair_tpu_torch.models.unet import ShallowEncoder
    x = rng.normal(size=(2, 20, 24, 4)).astype(np.float32)
    jnet = JaxShallow()
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial running statistics
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.random(a.shape).astype(np.float32) * 0.5,
        variables["batch_stats"])
    want = jnet.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    net = ShallowEncoder(in_feat=4)
    load_weights(net, shallow_encoder_state_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), stats))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert net.output_feat == jnet.output_feat == 112
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("key", ["fourier_small", "ngp_small", "dense_small"])
def test_nerf_snapshots_cross_load(key, tmp_path):
    from monohair_tpu import checkpoint as jcheckpoint
    from monohair_tpu_torch import checkpoint
    from tests.test_torch_nerf_fields import FIELDS, flax_variables, port_field
    _, make_jax, make_port = FIELDS[key]
    variables = flax_variables(make_jax(), seed=4)
    config = {"field": key, "steps": 3}
    # JAX -> port
    theirs = str(tmp_path / "theirs.npz")
    jcheckpoint.save_nerf_snapshot(theirs, variables, config)
    field = checkpoint.load_nerf_snapshot(theirs, make_port())
    want = port_field(key, variables).state_dict()
    for k, v in field.state_dict().items():
        assert torch.equal(v, want[k]), k
    # port -> JAX
    ours = str(tmp_path / "ours.npz")
    checkpoint.save_nerf_snapshot(ours, field, config)
    back = jcheckpoint.load_nerf_snapshot(ours, variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(ours, allow_pickle=True) as o, np.load(theirs, allow_pickle=True) as t:
        assert sorted(o.files) == sorted(t.files)
        assert str(o["__treedef__"]) == str(t["__treedef__"])
        assert np.array_equal(o["__config__"], t["__config__"])
