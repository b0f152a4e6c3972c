"""The committed trained/mvs/{occ,ori}.npz against the orbax trees they were
exported from (tools/export_mvs_weights.py), and the port's full-width nets on
them against the JAX package's nets on the trees, on the CPU."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.models.convert import convert_pifu_checkpoint
from monohair_tpu.models.pifu import OccAttn as JOcc, OriAttn as JOri
from monohair_tpu_torch.models.convert import load_weights, read_state_dict, weights_path
from monohair_tpu_torch.models.pifu import OccAttn, OriAttn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "trained", "mvs")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_mvs_weights", os.path.join(REPO, "tools", "export_mvs_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees():
    restore = _tool().restore_tree
    return {kind: restore(os.path.join(TRAINED, kind)) for kind in ("occ", "ori")}


def assert_tree_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("kind,prefix,count", [("occ", "occ_vit", 2_824_290),
                                               ("ori", "vit", 2_824_419)])
def test_committed_npz_is_the_orbax_tree_bitwise(trees, kind, prefix, count):
    path = weights_path(os.path.join(TRAINED, kind))
    assert path == os.path.join(TRAINED, kind + ".npz")
    sd = {k: v.numpy() for k, v in read_state_dict(path).items()}
    params, stats = convert_pifu_checkpoint(sd, prefix)
    assert_tree_equal(params, trees[kind]["params"])
    assert_tree_equal(stats, trees[kind]["batch_stats"])
    assert params["vit"]["pos_embedding"].shape == (1, 17, 128)
    assert params["vit"]["block2"]["attn"]["to_qkv"]["kernel"].shape == (128, 3072)
    assert sum(x.size for x in jax.tree_util.tree_leaves(params)) == count


def mvs_inputs(rng, V=16, H=32, W=32, N=1024):
    """Render-like maps (orientation in [-1, 1], depths in [0, 2]) and query
    points that project inside most views of a ring of cameras."""
    from monohair_tpu_torch.synthetic import cameras_numpy, ring_camera_list
    imgs = np.concatenate([rng.uniform(-1, 1, (V, H, W, 2)),
                           rng.uniform(0, 2, (V, H, W, 2))], -1).astype(np.float32)
    ndc, w2c = (a.astype(np.float32) for a in cameras_numpy(ring_camera_list(V)))
    pts = (rng.normal(size=(N, 3)) * 0.08).astype(np.float32)
    return imgs, ndc, w2c, pts


def test_full_width_nets_on_the_trained_weights_match_jax(trees, rng):
    """Both shipped nets (16 views, ViT dim 128, depth 3, 8 heads) on 16
    32x32 maps: logits and orientations within rtol 1e-4 / atol 1e-5, and the
    occupancy decision at the shipped margin equal on >= 99.9% of queries."""
    from monohair_tpu.models.pifu import mvs_projection as j_proj
    from monohair_tpu_torch.models.pifu import mvs_projection, occ_decision
    imgs, ndc, w2c, pts = mvs_inputs(rng)
    coord, cam = j_proj(jnp.asarray(w2c), jnp.asarray(ndc), jnp.asarray(pts))
    with open(os.path.join(TRAINED, "occ_margin.json")) as f:
        margin = float(json.load(f)["margin"])
    tcoord, tcam = mvs_projection(torch.from_numpy(w2c), torch.from_numpy(ndc),
                                  torch.from_numpy(pts))
    for kind, jcls, tcls in (("occ", JOcc, OccAttn), ("ori", JOri, OriAttn)):
        jm = jcls(num_views=16)
        variables = {"params": trees[kind]["params"], "batch_stats": trees[kind]["batch_stats"]}
        j_out = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(imgs), jnp.asarray(pts),
                                             cam, coord))
        net = load_weights(tcls(num_views=16),
                           read_state_dict(weights_path(os.path.join(TRAINED, kind)))).eval()
        with torch.no_grad():
            out = net(torch.from_numpy(imgs), torch.from_numpy(pts), tcam, tcoord)
        np.testing.assert_allclose(out.numpy(), j_out, rtol=1e-4, atol=1e-5)
        if kind == "occ":
            ours = occ_decision(out, margin).numpy()
            theirs = (j_out[:, 1] - j_out[:, 0]) > margin
            assert (ours == theirs).mean() >= 0.999
            assert 0 < theirs.mean() < 1
