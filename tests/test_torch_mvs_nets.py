"""The port's DeepMVSHair nets (monohair_tpu_torch.models) against the JAX
package's on the CPU: the weight carrier both ways, the UNet features, the
fusion transformer and both heads on the same numpy inputs, the torch goldens,
and the random initialisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.models import pifu as jpifu
from monohair_tpu.models.convert import _convT, convert_pifu_checkpoint
from monohair_tpu.models.unet import ConvTranspose2dTorch
from monohair_tpu_torch.models import pifu as tpifu
from monohair_tpu_torch.models.convert import (_conv_t, load_weights, read_state_dict,
                                               state_dict_from_flax, weights_path)
from monohair_tpu_torch.models.unet import DoubleConv, Up
from monohair_tpu_torch.ops.grid_sample import grid_sample_2d

torch.set_num_threads(1)

NETS = [("occ", jpifu.OccAttn, tpifu.OccAttn, "occ_vit"),
        ("ori", jpifu.OriAttn, tpifu.OriAttn, "vit")]
SMALL = dict(num_views=4, vit_depth=2, vit_dim=32, vit_heads=4)


def _golden(name):
    import os
    return np.load(os.path.join(os.path.dirname(__file__), "golden", name))


def random_stats(stats, rng):
    """BatchNorm running stats that are not 0/1, so eval-mode mix-ups show."""
    if "mean" in stats:
        return {"mean": (rng.normal(size=stats["mean"].shape) * 0.3).astype(np.float32),
                "var": (rng.random(stats["var"].shape) + 0.5).astype(np.float32)}
    return {k: random_stats(v, rng) for k, v in stats.items()}


def small_case(jcls, rng, V=4, H=32, W=32, N=64):
    """A small flax net with random weights and stats, and its inputs."""
    imgs = rng.normal(size=(V, H, W, 4)).astype(np.float32)
    pts = ((rng.random((N, 3)) - 0.5) * 0.4).astype(np.float32)
    pts_view = (rng.normal(size=(V, N, 3)) * 0.3).astype(np.float32)
    coord = (rng.random((V, N, 2)) * 2.4 - 1.2).astype(np.float32)
    model = jcls(**SMALL)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(imgs), jnp.asarray(pts),
                           jnp.asarray(pts_view), jnp.asarray(coord))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = random_stats(jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), rng)
    return model, params, stats, (imgs, pts, pts_view, coord)


def assert_tree_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("kind,jcls,tcls,prefix", NETS)
def test_weight_carrier_round_trips_bitwise(kind, jcls, tcls, prefix, rng):
    """state_dict_from_flax is the inverse of convert_pifu_checkpoint, and its
    keys and shapes are exactly the port's modules' state dict."""
    _, params, stats, _ = small_case(jcls, rng)
    sd = state_dict_from_flax(params, stats, prefix)
    p2, s2 = convert_pifu_checkpoint(sd, prefix)
    assert_tree_equal(params, p2)
    assert_tree_equal(stats, s2)
    ours = tcls(**SMALL).state_dict()
    assert set(sd) == set(ours)
    assert all(tuple(sd[k].shape) == tuple(ours[k].shape) for k in sd)


@pytest.mark.parametrize("kind,jcls,tcls,prefix", NETS)
def test_small_nets_match_jax(kind, jcls, tcls, prefix, rng):
    """UNet features, the fusion head and the whole net at V=4, 32x32 images,
    ViT dim 32, depth 2, 4 heads: within rtol 1e-4 / atol 1e-5."""
    model, params, stats, (imgs, pts, pts_view, coord) = small_case(jcls, rng)
    variables = {"params": params, "batch_stats": stats}
    j_feats = model.apply(variables, jnp.asarray(imgs), method=model.get_feat)
    j_out = np.asarray(model.apply(variables, jnp.asarray(imgs), jnp.asarray(pts),
                                   jnp.asarray(pts_view), jnp.asarray(coord)))
    net = load_weights(tcls(**SMALL), state_dict_from_flax(params, stats, prefix)).eval()
    with torch.no_grad():
        feats = net.get_feat(torch.from_numpy(imgs))
        out = net.forward_with_feat(feats, torch.from_numpy(pts), torch.from_numpy(pts_view),
                                    torch.from_numpy(coord)).numpy()
    assert [tuple(f.shape) for f in feats] == [(4, 128, 4, 4), (4, 64, 8, 8), (4, 32, 16, 16),
                                               (4, 16, 32, 32)]
    for a, b in zip(j_feats, feats):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), np.asarray(a),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, j_out, rtol=1e-4, atol=1e-5)
    if kind == "ori":
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("which,tcls", [("pifu_occ.npz", tpifu.OccAttn),
                                        ("pifu_ori.npz", tpifu.OriAttn)])
def test_reference_torch_state_dict_loads_as_is(which, tcls):
    """The torch golden nets (the reference's state_dict naming) load with
    load_state_dict and give their outputs within the JAX package's own
    tolerance for this golden (LayerNorm eps and GELU follow flax)."""
    d = _golden(which)
    sd = {k[3:]: d[k] for k in d.files if k.startswith("sd.")}
    net = load_weights(tcls(**SMALL), sd).eval()
    with torch.no_grad():
        out = net(torch.from_numpy(d["in.imgs"].transpose(0, 2, 3, 1)),
                  torch.from_numpy(d["in.pts_world"]), torch.from_numpy(d["in.pts_view"]),
                  torch.from_numpy(d["in.coord"][:, :, 0, :])).numpy()
    np.testing.assert_allclose(out, d["out.out"], rtol=3e-2, atol=2e-2)


def test_double_conv_and_conv_transpose_match_torch_goldens():
    d = _golden("double_conv.npz")
    block = DoubleConv(3, 8, 5).eval()
    block.load_state_dict({k[len("sd.p."):]: torch.from_numpy(np.array(d[k]))
                           for k in d.files if k.startswith("sd.")})
    with torch.no_grad():
        out = block(torch.from_numpy(d["x"]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, d["ref"], rtol=1e-5, atol=1e-5)

    d = _golden("convtranspose.npz")
    # the decoder's up-sampler (models/unet.py Up) at the golden's widths
    up = Up(6, 3).up
    up.load_state_dict({"weight": torch.from_numpy(d["weight"]),
                        "bias": torch.from_numpy(d["bias"])})
    with torch.no_grad():
        out = up(torch.from_numpy(d["x"]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, d["ref"], rtol=1e-5, atol=1e-5)
    # the JAX kernel layout carried back gives the torch kernel
    jk = _convT(d["weight"])
    np.testing.assert_array_equal(_conv_t(jk), d["weight"])
    jout = ConvTranspose2dTorch(3).apply({"params": {"kernel": jk, "bias": d["bias"]}},
                                         jnp.asarray(d["x"]))
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)


def test_grid_sample_matches_torch_golden_and_jax(rng):
    d = _golden("grid_sample.npz")
    feat = torch.from_numpy(d["feat"][0])
    coords = torch.from_numpy(d["coords"][0, :, 0, :])
    np.testing.assert_allclose(grid_sample_2d(feat, coords).numpy(), d["ref"],
                               rtol=1e-5, atol=1e-5)
    from monohair_tpu.ops.grid_sample import grid_sample_views as j_views
    from monohair_tpu_torch.ops.grid_sample import grid_sample_views
    feats = rng.normal(size=(3, 5, 9, 7)).astype(np.float32)
    co = (rng.random((3, 40, 2)) * 2.6 - 1.3).astype(np.float32)
    co[:, :4] = [[-1, -1], [1, 1], [0.999, -1.0], [-1.2, 0.3]]
    ours = grid_sample_views(torch.from_numpy(feats), torch.from_numpy(co)).numpy()
    plain = np.stack([grid_sample_2d(torch.from_numpy(f), torch.from_numpy(c)).numpy()
                      for f, c in zip(feats, co)])
    np.testing.assert_allclose(ours, plain, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, np.asarray(j_views(jnp.asarray(feats), jnp.asarray(co))),
                               rtol=1e-5, atol=1e-6)


def test_encoding_projection_and_frustum_match_jax(rng):
    x = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(tpifu.positional_encoding(torch.from_numpy(x)).numpy(),
                               np.asarray(jpifu.positional_encoding(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    from monohair_tpu_torch.synthetic import cameras_numpy, ring_camera_list
    ndc, w2c = (a.astype(np.float32) for a in cameras_numpy(ring_camera_list(5)))
    pts = (rng.normal(size=(40, 3)) * 0.2).astype(np.float32)
    jc, jcam = jpifu.mvs_projection(jnp.asarray(w2c), jnp.asarray(ndc), jnp.asarray(pts))
    tc, tcam = tpifu.mvs_projection(torch.from_numpy(w2c), torch.from_numpy(ndc),
                                    torch.from_numpy(pts))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), rtol=1e-5, atol=1e-6)
    for mode in ("any", "all"):
        np.testing.assert_array_equal(tpifu.check_pts_in_views(tc, mode).numpy(),
                                      np.asarray(jpifu.check_pts_in_views(jc, mode)))


def test_random_init_follows_its_generator_only():
    torch.manual_seed(123)
    a = tpifu.random_init(tpifu.OccAttn(**SMALL), torch.Generator().manual_seed(5)).state_dict()
    torch.manual_seed(456)
    b = tpifu.random_init(tpifu.OccAttn(**SMALL), torch.Generator().manual_seed(5)).state_dict()
    c = tpifu.random_init(tpifu.OccAttn(**SMALL), torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["occ_vit.pos_embedding"], c["occ_vit.pos_embedding"])
    assert torch.all(a["backbone.inc.double_conv.1.running_var"] == 1)


def test_weight_files_and_orbax_directories(tmp_path):
    net = tpifu.OriAttn(**SMALL)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    np.savez(tmp_path / "ori.npz", **sd)
    torch.save({"model_state_dict": net.state_dict()}, tmp_path / "ori.pth")
    for path in (tmp_path / "ori.npz", tmp_path / "ori.pth"):
        loaded = read_state_dict(str(path))
        assert all(torch.equal(loaded[k], net.state_dict()[k]) for k in sd)
    tree = tmp_path / "tree" / "ori"
    tree.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="export_mvs_weights"):
        weights_path(str(tree))
    np.savez(tmp_path / "tree" / "ori.npz", **sd)
    assert weights_path(str(tree) + "/") == str(tmp_path / "tree" / "ori.npz")
    assert weights_path(str(tmp_path / "ori.pth")) == str(tmp_path / "ori.pth")
