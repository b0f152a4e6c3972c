"""The port's NeRF fields (monohair_tpu_torch/nerf/{ngp,fourier,dense_grid,
convert}.py) against the JAX package's on the CPU, on the same numpy inputs
and the same weights (flax variables through field_state_from_flax).

Held: the Fourier matrix B bitwise against JAX's draw; the SH encoding; the
hash indices bitwise; density and colour of the three fields at a small
width and of the Fourier field at its full width within rtol 1e-5 /
atol 1e-6; the parameter gradients of a render_rays loss against jax.grad
within rtol 1e-4 (the stratified draws made by jax.random and passed in); and
flax's initialisation statistics."""

import math

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.nerf import dense_grid as jdense
from monohair_tpu.nerf import fourier as jfourier
from monohair_tpu.nerf import ngp as jngp
from monohair_tpu_torch.nerf import dense_grid, fourier, ngp
from monohair_tpu_torch.nerf.convert import field_state_from_flax

torch.set_num_threads(1)

SMALL_HASH = dict(num_levels=4, features_per_level=2, log2_table_size=12,
                  base_resolution=8, finest_resolution=96)
SMALL_DENSE = (8, 12, 20)

FIELDS = {
    "fourier_full": ("fourier", lambda: jfourier.FourierField(),
                     lambda: fourier.FourierField()),
    "fourier_small": ("fourier",
                      lambda: jfourier.FourierField(num_features=32, hidden=32, depth=3,
                                                    geo_feat=7),
                      lambda: fourier.FourierField(num_features=32, hidden=32, depth=3,
                                                   geo_feat=7)),
    "ngp_small": ("ngp", lambda: jngp.NGPField(cfg=jngp.HashGridConfig(**SMALL_HASH), hidden=32),
                  lambda: ngp.NGPField(ngp.HashGridConfig(**SMALL_HASH), hidden=32)),
    "dense_small": ("dense",
                    lambda: jdense.DenseGridField(cfg=jdense.DenseGridConfig(SMALL_DENSE),
                                                  hidden=32),
                    lambda: dense_grid.DenseGridField(dense_grid.DenseGridConfig(SMALL_DENSE),
                                                      hidden=32)),
}


def flax_variables(jfield, seed=0):
    """Initialised flax variables as numpy, with the tables and grids drawn
    at O(1) so that the encodings carry the output (flax starts them near 0)."""
    v = jfield.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    params = dict(v["params"])
    for name, leaf in params.items():
        if not isinstance(leaf, dict):
            params[name] = rng.normal(scale=0.5, size=leaf.shape).astype(np.float32)
    return {"params": params}


def port_field(key, variables):
    kind, _, make = FIELDS[key]
    field = make()
    field.load_state_dict(field_state_from_flax(kind, variables))
    return field


def unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_fourier_matrix_is_jax_draw_bitwise():
    for F in (128, 32, 256):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (3, F)))
        np.testing.assert_array_equal(fourier.fourier_normal(F), want)
    field = fourier.FourierField()
    want = np.asarray(jnp.asarray(jax.random.normal(jax.random.PRNGKey(11), (3, 128)) * 16.0,
                                  jnp.float32))
    np.testing.assert_array_equal(field.B.numpy(), want)
    with pytest.raises(ValueError, match="export_fourier_b"):
        fourier.FourierField(num_features=257)


def test_sh_encoding_matches_jax(rng):
    d = unit_dirs(rng, 2000)
    np.testing.assert_allclose(ngp.sh_encoding_deg4(torch.from_numpy(d)).numpy(),
                               np.asarray(jngp.sh_encoding_deg4(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-7)


def test_hash_indices_are_jax_bitwise(rng):
    cfg = jngp.HashGridConfig()
    pts = rng.uniform(0.0, 1.0, (5000, 3)).astype(np.float32)
    mask = jnp.uint32(2 ** cfg.log2_table_size - 1)
    for r in jngp.level_resolutions(cfg)[::3].astype(np.float32):
        p = jnp.asarray(pts) * r
        i = jnp.floor(p).astype(jnp.uint32)
        idx, w = ngp.hash_corners(torch.from_numpy(pts), r, cfg.log2_table_size)
        k = 0
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    h = (((i[:, 0] + cx) * jngp._PRIMES[0]) ^ ((i[:, 1] + cy) * jngp._PRIMES[1])
                         ^ ((i[:, 2] + cz) * jngp._PRIMES[2]))
                    np.testing.assert_array_equal(idx[k].numpy(),
                                                  np.asarray(h & mask).astype(np.int64))
                    k += 1
        np.testing.assert_allclose(w.sum(0).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(ngp.level_resolutions(ngp.HashGridConfig()),
                                  jngp.level_resolutions(cfg))


def test_hash_encode_matches_jax(rng):
    cfg = jngp.HashGridConfig(**SMALL_HASH)
    table = rng.normal(size=(cfg.num_levels, cfg.features_per_level,
                             2 ** cfg.log2_table_size)).astype(np.float32)
    pts = rng.uniform(0.0, 1.0, (3000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ngp.hash_encode(torch.from_numpy(table), torch.from_numpy(pts),
                        ngp.HashGridConfig(**SMALL_HASH)).numpy(),
        np.asarray(jngp.hash_encode(jnp.asarray(table), jnp.asarray(pts), cfg)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", list(FIELDS))
def test_field_density_and_colour_match_jax(key, rng):
    _, make_jax, _ = FIELDS[key]
    jfield = make_jax()
    variables = flax_variables(jfield)
    field = port_field(key, variables)
    pts = rng.uniform(0.02, 0.98, (4096, 3)).astype(np.float32)
    d = unit_dirs(rng, 4096)
    sigma, rgb = jfield.apply(variables, jnp.asarray(pts), jnp.asarray(d))
    with torch.no_grad():
        t_sigma, t_rgb = field(torch.from_numpy(pts), torch.from_numpy(d))
        t_dens, t_feat = field.density(torch.from_numpy(pts))
    _, feat = jfield.apply(variables, jnp.asarray(pts), method=jfield.density)
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(sigma), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_dens.numpy(), np.asarray(sigma), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(feat), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(rgb), rtol=1e-5, atol=1e-6)
    assert np.ptp(np.asarray(sigma)) > 1e-2     # the inputs exercise the field


def test_dense_grid_tv_matches_jax(rng):
    grids = [rng.normal(size=(r, r, r * 4)).astype(np.float32) for r in SMALL_DENSE]
    np.testing.assert_allclose(
        float(dense_grid.grid_tv_loss([torch.from_numpy(g) for g in grids])),
        float(jdense.grid_tv_loss([jnp.asarray(g) for g in grids])), rtol=1e-6)


def _render_loss_inputs(rng, n=64):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, -0.1, 2.5]
    pix = np.stack([rng.uniform(0, 32, n), rng.uniform(0, 32, n)], -1).astype(np.float32)
    o, d = jngp.camera_rays(jnp.asarray(c2w), 30.0, 30.0, 16.0, 16.0, jnp.asarray(pix))
    return np.asarray(o), np.asarray(d)


@pytest.mark.parametrize("key", ["fourier_small", "ngp_small", "dense_small"])
def test_render_rays_loss_gradients_match_jax_grad(key, rng):
    """d/dparams of sum(rgb * c) + mean(depth) through render_rays with a
    background, the stratified draws made by jax.random and passed in."""
    kind, make_jax, _ = FIELDS[key]
    jfield = make_jax()
    variables = flax_variables(jfield)
    field = port_field(key, variables)
    o, d = _render_loss_inputs(rng)
    S = 32
    key_u = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key_u, (o.shape[0], S)))
    coef = rng.normal(size=(o.shape[0], 3)).astype(np.float32)
    bg = jnp.asarray([0.92, 0.92, 0.92], jnp.float32)

    def jloss(v):
        rgb, depth, _ = jngp.render_rays(jfield, v, jnp.asarray(o), jnp.asarray(d), S,
                                         rng=key_u, background=bg)
        return jnp.sum(rgb * coef) + jnp.mean(depth)

    jl, jgrads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, variables))
    want = field_state_from_flax(kind, jax.tree_util.tree_map(np.asarray, jgrads))
    rgb, depth, _ = ngp.render_rays(field, torch.from_numpy(o), torch.from_numpy(d), S,
                                    u=torch.from_numpy(u), background=ngp.as_background(
                                        [0.92] * 3, "cpu"))
    loss = torch.sum(rgb * torch.from_numpy(coef)) + torch.mean(depth)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    got = dict(field.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        scale = float(np.abs(w.numpy()).max())
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def test_initialisation_is_flax_style():
    g = torch.Generator().manual_seed(0)
    field = fourier.FourierField(generator=g)
    jv = jfourier.FourierField().init(jax.random.PRNGKey(0), jnp.zeros((8, 3)),
                                      jnp.zeros((8, 3)))["params"]
    for name, layer in (("trunk_0", field.trunk[0]), ("trunk_1", field.trunk[1]),
                        ("skip", field.skip), ("sigma_head", field.sigma_head),
                        ("rgb1", field.rgb1)):
        w = layer.weight.detach().numpy()
        fan_in = w.shape[1]
        sd = math.sqrt(1.0 / fan_in)
        jw = np.asarray(jv[name]["kernel"])
        assert abs(w.std() / sd - 1) < 0.06 and abs(jw.std() / sd - 1) < 0.06, name
        bound = 2 * sd / ngp._TRUNC_STD
        assert np.abs(w).max() <= bound * (1 + 1e-6) and np.abs(w).max() > 0.9 * bound, name
        assert abs(w.mean()) < 0.05 * sd, name
        if layer.bias is not None:
            assert not layer.bias.detach().numpy().any()
    table = ngp.NGPField(ngp.HashGridConfig(**SMALL_HASH), generator=g).hash_table.detach()
    assert float(table.min()) >= 0.0 and float(table.max()) < 2e-4
    assert abs(float(table.mean()) - 1e-4) < 5e-6
    grid = dense_grid.DenseGridField(dense_grid.DenseGridConfig(SMALL_DENSE),
                                     generator=g).grids[2].detach()
    assert float(grid.min()) >= 0.0 and float(grid.max()) < 2e-4
    # the same generator state gives the same field
    a = fourier.FourierField(generator=torch.Generator().manual_seed(3))
    b = fourier.FourierField(generator=torch.Generator().manual_seed(3))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
