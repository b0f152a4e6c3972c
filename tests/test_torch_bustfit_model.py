"""The port's SMPL-X model, texture/SH shading and soft rasteriser
(monohair_tpu_torch/bustfit/{smplx,texture,soft_raster}.py) against the JAX
package's, on the CPU, with the same seeded numpy inputs.

Tolerances and why:
- LBS, Rodrigues and the SH shading: 1e-6 absolute (f32; the products sum in
  other orders than XLA's).
- vertex normals 1e-6; silhouettes and colour renders 1e-5 absolute: they sum
  thousands of log(1 - D) terms and softmax weights, in the same fragment
  order but through other f32 reductions.
- gradients (torch autograd against jax.grad): 1e-4 of the gradient's largest
  magnitude, as each is a sum over every fragment of a pixel.
"""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.bustfit import smplx as jsmplx
from monohair_tpu.bustfit import soft_raster as jraster
from monohair_tpu.bustfit import texture as jtexture
from monohair_tpu.camera import Cameras as JaxCameras
from monohair_tpu_torch.bustfit import smplx, soft_raster, texture
from monohair_tpu_torch.camera import Cameras

torch.set_num_threads(1)


def camera_pair(rng, num_views):
    """The same random look-at ring as tests/test_camera.py::make_cameras, as
    JAX and port camera sets."""
    cam_list = []
    for v in range(num_views):
        angle = 2 * np.pi * v / num_views + 0.1 + rng.normal() * 0.01
        eye = np.array([np.cos(angle), 0.15, np.sin(angle)]) * 1.2
        forward = -eye / np.linalg.norm(eye)
        right = np.cross(forward, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        mat = np.eye(4)
        mat[:3, :3] = np.stack([right, np.cross(right, forward), -forward], axis=1)
        mat[:3, 3] = eye
        cam_list.append({"file": f"{v:03d}", "pose": mat.tolist(),
                         "ndc_prj": [1.55 + 0.1 * v, 1.05, 0.01 * v, -0.02 * v]})
    return JaxCameras.from_json_list(cam_list), Cameras.from_json_list(cam_list, "cpu")


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), rtol=rtol, atol=atol)


def grad_close(a, b, rel=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-12))


def test_rodrigues_matches_jax(rng):
    vecs = rng.normal(size=(12, 3)).astype(np.float32)
    vecs[0] = 0.0
    vecs[1] = [1e-7, 0, 0]
    close(smplx.rodrigues(torch.from_numpy(vecs)), jsmplx.rodrigues(jnp.asarray(vecs)), 1e-6)
    t = torch.from_numpy(vecs).requires_grad_()
    g = torch.autograd.grad(smplx.rodrigues(t).sum(), t)[0]
    jg = jax.grad(lambda x: jsmplx.rodrigues(x).sum())(jnp.asarray(vecs))
    grad_close(g, jg)


@pytest.mark.parametrize("num_joints,num_expr", [(8, 6), (4, 0)])
def test_lbs_forward_matches_jax(num_joints, num_expr):
    jm = jsmplx.random_test_model(np.random.default_rng(3), num_joints=num_joints,
                                  num_expr=num_expr)
    tm = smplx.random_test_model(np.random.default_rng(3), num_joints=num_joints,
                                 num_expr=num_expr, device="cpu")
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    r = np.random.default_rng(4)
    betas = r.normal(size=5).astype(np.float32) * 0.5
    pose = r.normal(size=(num_joints, 3)).astype(np.float32) * 0.3
    expr = r.normal(size=max(num_expr, 1)).astype(np.float32)
    transl = r.normal(size=3).astype(np.float32) * 0.1
    jv, jj = jsmplx.lbs_forward(jm, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(expr),
                                jnp.asarray(transl))
    tv, tj = smplx.lbs_forward(tm, torch.from_numpy(betas), torch.from_numpy(pose),
                               torch.from_numpy(expr), torch.from_numpy(transl))
    close(tv, jv, 1e-6)
    close(tj, jj, 1e-6)
    # the gradient of a vertex functional in pose and betas
    tp, tb = torch.from_numpy(pose).requires_grad_(), torch.from_numpy(betas).requires_grad_()
    loss = (smplx.lbs_forward(tm, tb, tp, torch.from_numpy(expr))[0] ** 2).sum()
    gp, gb = torch.autograd.grad(loss, [tp, tb])
    jgp, jgb = jax.grad(lambda p, b: (jsmplx.lbs_forward(jm, b, p, jnp.asarray(expr))[0] ** 2)
                        .sum(), argnums=(0, 1))(jnp.asarray(pose), jnp.asarray(betas))
    grad_close(gp, jgp)
    grad_close(gb, jgb)


def test_load_smplx_npz_official_layout(tmp_path, rng):
    """An npz in the official key layout: 300 shape + 100 expression dirs,
    posedirs (V, 3, P), the kinematic table's first row as parents."""
    V, J, F = 40, 5, 30
    path = str(tmp_path / "SMPLX_TEST.npz")
    np.savez(path, v_template=rng.normal(size=(V, 3)).astype(np.float32),
             f=rng.integers(0, V, (F, 3)),
             J_regressor=rng.random((J, V)).astype(np.float32),
             weights=rng.random((V, J)).astype(np.float32),
             kintree_table=np.stack([np.array([-1, 0, 0, 1, 2]), np.arange(J)]),
             shapedirs=rng.normal(size=(V, 3, 400)).astype(np.float32),
             posedirs=rng.normal(size=(V, 3, (J - 1) * 9)).astype(np.float32))
    for nb, ne in ((10, 10), (7, 0)):
        a = jsmplx.load_smplx_npz(path, num_betas=nb, num_expr=ne)
        b = smplx.load_smplx_npz(path, num_betas=nb, num_expr=ne, device="cpu")
        for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)))
        np.testing.assert_array_equal(b.parents, a.parents)
        np.testing.assert_array_equal(b.faces, a.faces)
        assert (b.expr_dirs is None) == (a.expr_dirs is None) and b.num_expr == ne
        if ne:
            np.testing.assert_array_equal(b.expr_dirs.numpy(), np.asarray(a.expr_dirs))


def test_texture_and_sh_shading_match_jax(rng):
    V, T = 30, 6
    basis = rng.normal(size=(V, 3, T)).astype(np.float32) * 0.3
    mean = rng.random((V, 3)).astype(np.float32)
    tex = rng.normal(size=T).astype(np.float32)
    jt = jtexture.FlameTex(jnp.asarray(mean), jnp.asarray(basis))
    tt = texture.FlameTex(torch.from_numpy(mean), torch.from_numpy(basis))
    close(texture.albedo_from_tex(tt, torch.from_numpy(tex)),
          jtexture.albedo_from_tex(jt, jnp.asarray(tex)), 1e-6)
    n = rng.normal(size=(V, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    sh = rng.normal(size=(3, 9, 3)).astype(np.float32)
    alb = rng.random((V, 3)).astype(np.float32)
    batched = texture.shaded_vertex_colors(torch.from_numpy(alb), torch.from_numpy(n),
                                           torch.from_numpy(sh))
    for v in range(3):
        close(batched[v], jtexture.shaded_vertex_colors(jnp.asarray(alb), jnp.asarray(n),
                                                        jnp.asarray(sh[v])), 1e-6)
    empty = texture.load_flame_tex(None, V, n_tex=4, device="cpu")
    jempty = jtexture.load_flame_tex(None, V, n_tex=4)
    close(empty.mean, jempty.mean, 0)
    close(empty.basis, jempty.basis, 0)


def sphere_and_degenerate(subdiv=8):
    jm = jsmplx.sphere_head_model(subdiv=subdiv)
    tm = smplx.sphere_head_model(subdiv=subdiv, device="cpu")
    np.testing.assert_array_equal(tm.v_template.numpy(), np.asarray(jm.v_template))
    np.testing.assert_array_equal(tm.faces, jm.faces)
    return np.array(jm.v_template), jm.faces


def jittered_sphere(rng, subdiv=8):
    verts, faces = sphere_and_degenerate(subdiv)
    return (verts + rng.normal(size=verts.shape).astype(np.float32) * 0.004), faces


def test_vertex_normals_match_jax_with_an_isolated_vertex(rng):
    verts, faces = jittered_sphere(rng)
    verts = np.concatenate([verts, [[0.5, 0.5, 0.5]]]).astype(np.float32)   # isolated
    close(soft_raster.vertex_normals(torch.from_numpy(verts), faces),
          jraster.vertex_normals(jnp.asarray(verts), faces), 1e-6)
    t = torch.from_numpy(verts).requires_grad_()
    w = rng.normal(size=verts.shape).astype(np.float32)
    g = torch.autograd.grad((soft_raster.vertex_normals(t, faces) * torch.from_numpy(w)).sum(),
                            t)[0]
    jg = jax.grad(lambda v: (jraster.vertex_normals(v, faces) * w).sum())(jnp.asarray(verts))
    grad_close(g, jg)


@pytest.mark.parametrize("scale,window,chunk", [(4, 8, 8192), (2, 6, 100)])
def test_soft_silhouette_mesh_matches_jax(rng, scale, window, chunk):
    jc, tc = camera_pair(rng, 3)
    verts, faces = jittered_sphere(rng)
    size = (96, 80)
    a = soft_raster.soft_silhouette_mesh(tc, torch.from_numpy(verts), faces, size, scale=scale,
                                         window=window, chunk=chunk)
    b = jraster.soft_silhouette_mesh(jc, jnp.asarray(verts), faces, size, scale=scale,
                                     window=window, chunk=chunk)
    assert a.shape == b.shape and float(a.max()) > 0.9
    close(a, b, 1e-5)
    w = rng.random(tuple(b.shape)).astype(np.float32)
    t = torch.from_numpy(verts).requires_grad_()
    g = torch.autograd.grad((soft_raster.soft_silhouette_mesh(
        tc, t, faces, size, scale=scale, window=window, chunk=chunk) * torch.from_numpy(w)).sum(),
        t)[0]
    jg = jax.grad(lambda v: (jraster.soft_silhouette_mesh(
        jc, v, faces, size, scale=scale, window=window, chunk=chunk) * w).sum())(jnp.asarray(verts))
    grad_close(g, jg)


def test_soft_render_colors_matches_jax_per_view(rng):
    """(N, C) colours for every view, and (V, N, C) per-view colours against
    one JAX call per view (the fit's batched lights)."""
    jc, tc = camera_pair(rng, 3)
    verts, faces = jittered_sphere(rng)
    size = (96, 80)
    cols = rng.random((3, len(verts), 4)).astype(np.float32)
    a = soft_raster.soft_render_colors(tc, torch.from_numpy(verts), faces,
                                       torch.from_numpy(cols[0]), size, scale=4, window=8)
    b = jraster.soft_render_colors(jc, jnp.asarray(verts), faces, jnp.asarray(cols[0]), size,
                                   scale=4, window=8)
    close(a, b, 1e-5)
    a = soft_raster.soft_render_colors(tc, torch.from_numpy(verts), faces,
                                       torch.from_numpy(cols), size, scale=4, window=8,
                                       background=0.3)
    for v in range(3):
        b = jraster.soft_render_colors(jc[v], jnp.asarray(verts), faces, jnp.asarray(cols[v]),
                                       size, scale=4, window=8, background=0.3)
        close(a[v], b[0], 1e-5)
    w = rng.random(tuple(a.shape)).astype(np.float32)
    t, tcol = torch.from_numpy(verts).requires_grad_(), torch.from_numpy(cols).requires_grad_()
    g, gc = torch.autograd.grad((soft_raster.soft_render_colors(
        tc, t, faces, tcol, size, scale=4, window=8) * torch.from_numpy(w)).sum(), [t, tcol])

    def jloss(v, c):
        return sum((jraster.soft_render_colors(jc[k], v, faces, c[k], size, scale=4,
                                               window=8)[0] * w[k]).sum() for k in range(3))
    jg, jgc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(verts), jnp.asarray(cols))
    grad_close(g, jg)
    grad_close(gc, jgc)


def test_degenerate_face_and_invalid_fragments_keep_gradients_finite(rng):
    """tests/test_bustfit.py's NaN regression in the port: a zero-area face
    (three equal ids) and fragments off the image (a 24x24 target that the
    sphere overflows) give finite, nonzero gradients equal to JAX's. The
    overflowing case takes random vertex colours: a flat colour over a fully
    covered image has a gradient of rounding noise only."""
    jc, tc = camera_pair(rng, 2)
    verts, faces = sphere_and_degenerate(8)
    faces = np.concatenate([faces, [[0, 0, 0]]], 0)
    flat = np.tile([[0.8, 0.4, 0.2]], (len(verts), 1)).astype(np.float32)
    for size, colors in (((96, 96), flat),
                         ((24, 24), rng.random((len(verts), 3)).astype(np.float32))):
        t = torch.from_numpy(verts.copy()).requires_grad_()
        out = soft_raster.soft_render_colors(tc, t, faces, torch.from_numpy(colors), size,
                                             scale=4, window=8)
        g = torch.autograd.grad(out.mean(), t)[0]
        jg = jax.grad(lambda v: jnp.mean(jraster.soft_render_colors(
            jc, v, faces, jnp.asarray(colors), size, scale=4, window=8)))(jnp.asarray(verts))
        assert torch.isfinite(g).all() and float(g.abs().max()) > 1e-4
        grad_close(g, jg)
        t = torch.from_numpy(verts.copy()).requires_grad_()
        g = torch.autograd.grad(soft_raster.soft_silhouette_mesh(tc, t, faces, size, scale=4)
                                .mean(), t)[0]
        jg = jax.grad(lambda v: jnp.mean(jraster.soft_silhouette_mesh(
            jc, v, faces, size, scale=4)))(jnp.asarray(verts))
        assert torch.isfinite(g).all() and float(g.abs().max()) > 1e-4
        grad_close(g, jg)
