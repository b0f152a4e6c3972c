"""The port's NeRF renderer (monohair_tpu_torch/nerf/ngp.py, train.render_image)
against the JAX package's on the CPU, on the same numpy inputs, weights and
jax.random draws (passed in to the port).

Held: camera_rays and ray_aabb (miss rays clamped to a positive segment)
within 1e-6; render_rays with and without a background, stratified and at
midpoints, within rtol 1e-5 / atol 1e-6; the occupancy update, the grid's
sample distances and render_rays_occ; density_grid on a 24^3 grid within
rtol 1e-4, and render_image on a 24 x 32 frame within rtol 1e-4 / atol 1e-5:
sigma = exp(h), so the last-place differences of two f32 summation orders in
the MLP's products (~1e-5 of h) become relative errors of sigma."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.nerf import ngp as jngp
from monohair_tpu.nerf import train as jtrain
from monohair_tpu_torch.nerf import ngp, train
from tests.test_torch_nerf_fields import FIELDS, flax_variables, port_field

torch.set_num_threads(1)

BG = [0.92, 0.92, 0.92]


@pytest.fixture(scope="module")
def small_fourier():
    _, make_jax, _ = FIELDS["fourier_small"]
    jfield = make_jax()
    variables = flax_variables(jfield, seed=2)
    return jfield, variables, port_field("fourier_small", variables)


def orbit_c2w(angle, radius=2.5, elev=0.3):
    eye = np.array([np.cos(angle), elev, np.sin(angle)]) * radius
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], 1)
    c2w[:3, 3] = eye
    return c2w


def rays(rng, n=256, angle=0.4):
    c2w = orbit_c2w(angle)
    pix = np.stack([rng.uniform(0, 24, n), rng.uniform(0, 32, n)], -1).astype(np.float32)
    o, d = jngp.camera_rays(jnp.asarray(c2w), 28.0, 27.0, 16.0, 12.0, jnp.asarray(pix))
    return c2w, pix, np.asarray(o), np.asarray(d)


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_camera_rays_match_jax(rng):
    c2w, pix, o, d = rays(rng)
    to, td = ngp.camera_rays(torch.from_numpy(c2w), 28.0, 27.0, 16.0, 12.0,
                             torch.from_numpy(pix))
    close(to.numpy(), o, 0, 0)
    close(td.numpy(), d, 0, 1e-6)


def test_ray_aabb_matches_jax_with_miss_rays(rng):
    o = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:5] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0.6, 0.8, 0], [0, 0, 1]]
    jmin, jmax = jngp.ray_aabb(jnp.asarray(o), jnp.asarray(d))
    tmin, tmax = ngp.ray_aabb(torch.from_numpy(o), torch.from_numpy(d))
    close(tmin.numpy(), jmin, 1e-6, 1e-6)
    close(tmax.numpy(), jmax, 1e-6, 1e-6)
    miss = np.asarray(jmax) - np.asarray(jmin) < 0.0100001
    # a miss gets [tmin, tmin + 0.01] (equal in f32 where tmin is huge)
    assert miss.sum() > 50 and bool((tmax >= tmin).all())


@pytest.mark.parametrize("background", [None, BG])
@pytest.mark.parametrize("stratified", [True, False])
def test_render_rays_matches_jax(small_fourier, rng, background, stratified):
    jfield, variables, field = small_fourier
    _, _, o, d = rays(rng)
    S = 48
    key = jax.random.PRNGKey(7) if stratified else None
    u = torch.tensor(np.asarray(jax.random.uniform(key, (len(o), S)))) if stratified else None
    jbg = None if background is None else jnp.asarray(background, jnp.float32)
    want = jngp.render_rays(jfield, variables, jnp.asarray(o), jnp.asarray(d), S, key,
                            background=jbg)
    with torch.no_grad():
        got = ngp.render_rays(field, torch.from_numpy(o), torch.from_numpy(d), S, u=u,
                              background=ngp.as_background(background, "cpu"))
    for g, w in zip(got, want):
        close(g.numpy(), w)
    assert np.asarray(want[2]).max() > 0.5        # some rays are mostly absorbed


def test_occupancy_update_and_sampling_match_jax(small_fourier, rng):
    jfield, variables, field = small_fourier
    R = 12
    old = rng.uniform(0, 4, (R, R, R)).astype(np.float32)
    k = jax.random.PRNGKey(3)
    jitter = np.asarray(jax.random.uniform(k, (R ** 3, 3)))
    want = np.asarray(jngp.update_occupancy_grid(jfield, variables, jnp.asarray(old), k))
    with torch.no_grad():
        got = ngp.update_occupancy_grid(field, torch.from_numpy(old),
                                        torch.from_numpy(jitter)).numpy()
    close(got, want)
    close(float(ngp.occupancy_threshold(torch.from_numpy(want))),
          float(jngp.occupancy_threshold(jnp.asarray(want))))
    # a grid with a clearly occupied core, so the PDF is not uniform
    grid = np.full((R, R, R), 0.1, np.float32)
    grid[4:8, 4:8, 4:8] = 30.0
    _, _, o, d = rays(rng, 128)
    for key in (jax.random.PRNGKey(9), None):
        u = None if key is None else torch.from_numpy(
            np.asarray(jax.random.uniform(key, (len(o), 40))))
        want_t = jngp.occupancy_sample_ts(jnp.asarray(grid), jnp.asarray(o), jnp.asarray(d),
                                          64, 40, 1.5, key)
        got_t = ngp.occupancy_sample_ts(torch.from_numpy(grid), torch.from_numpy(o),
                                        torch.from_numpy(d), 64, 40, 1.5, u=u)
        close(got_t.numpy(), want_t, 1e-5, 1e-5)
        want_r = jngp.render_rays_occ(jfield, variables, jnp.asarray(grid), jnp.asarray(o),
                                      jnp.asarray(d), 64, 40, key,
                                      background=jnp.asarray(BG, jnp.float32))
        with torch.no_grad():
            got_r = ngp.render_rays_occ(field, torch.from_numpy(grid), torch.from_numpy(o),
                                        torch.from_numpy(d), 64, 40, u=u,
                                        background=ngp.as_background(BG, "cpu"))
        for g, w in zip(got_r, want_r):
            close(g.numpy(), w, 1e-5, 1e-5)


def test_density_grid_matches_jax(small_fourier):
    jfield, variables, field = small_fourier
    want = jngp.density_grid(jfield, variables, 24, chunk=4096)
    got = ngp.density_grid(field, 24, chunk=4096)
    assert got.shape == (24, 24, 24) and got.dtype == np.float32
    close(got, want, 1e-4, 1e-6)


@pytest.mark.parametrize("occ", [False, True])
def test_render_image_matches_jax(small_fourier, occ):
    jfield, variables, field = small_fourier
    c2w = orbit_c2w(1.1)
    grid = None
    if occ:
        grid = np.full((16, 16, 16), 0.1, np.float32)
        grid[5:11, 5:11, 5:11] = 30.0
    want = jtrain.render_image(jfield, variables, c2w, 24, 32, 30.0, 30.0, 16.0, 12.0,
                               chunk=512, occ_grid=None if grid is None else jnp.asarray(grid),
                               num_fine=32, background=BG)
    got = train.render_image(field, c2w, 24, 32, 30.0, 30.0, 16.0, 12.0, chunk=512,
                             occ_grid=None if grid is None else torch.from_numpy(grid),
                             num_fine=32, background=BG)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, 1e-4, 1e-5)
