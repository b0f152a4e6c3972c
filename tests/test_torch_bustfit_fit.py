"""The port's bust-fit objective and optimiser (monohair_tpu_torch/bustfit/
optimize.py, optim.py) against the JAX package's, on the CPU.

Two fixtures with the full target set (landmarks, iris, masks, hair and face
masks, images): the JAX tests' sphere head (one joint, 4 views at 96x96,
silhouette scale 4) and a random 20-joint model with expressions and a
random triangle list of distinct ids (the shoulder anchor needs joints 16
and 17).

Tolerances and why:
- each weighted loss term at a random state: 1e-5 relative (f32 sums in
  other orders); its gradient in every FitParams leaf: 1e-4 of the term's
  largest gradient element over all leaves, 1e-3 for the image and albedo
  terms, whose depth softmax multiplies an ulp of zn by 1/gamma = 100 (sums over every fragment of a
  pixel; the sphere's image hardly moves under a rotation about its centre,
  so its rotation gradients are what cancellation leaves of larger sums).
- one optimiser step against optax's chain (zero_nans, clip, Adam, decay):
  1e-6 relative / 1e-7 absolute (the same f32 arithmetic).
- a 30-step fit: each logged loss within 1e-3 relative and the similarity
  within 10 lr; an element whose gradient is rounding noise can take Adam's
  +-lr step in either package, and the differences grow along the run.
"""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monohair_tpu.bustfit import optimize as jopt
from monohair_tpu.bustfit import smplx as jsmplx
from monohair_tpu.bustfit import texture as jtexture
from monohair_tpu_torch.bustfit import optimize as opt
from monohair_tpu_torch.bustfit import smplx, texture
from monohair_tpu_torch.optim import OptaxAdam
from tests.test_torch_bustfit_model import camera_pair

torch.set_num_threads(1)
SIZE = (96, 96)
# gradient tolerance of each term, a fraction of its largest gradient element:
# the colour terms' softmax multiplies an ulp of zn by 1/gamma = 100
TOL = {"lmk": 1e-4, "mesh_mask": 1e-4, "reg_shoulder": 1e-4, "image": 1e-3, "albedo": 1e-3}


def torch_model(jm, device="cpu"):
    """The port's SMPLXModel holding the JAX model's arrays."""
    def t(x):
        return None if x is None else torch.as_tensor(np.array(x), device=device)
    return smplx.SMPLXModel(t(jm.v_template), t(jm.shapedirs), t(jm.posedirs),
                            t(jm.J_regressor), jm.parents, t(jm.lbs_weights), jm.faces,
                            t(jm.expr_dirs))


def make_case(kind, seed=0):
    """(jax model, jax cameras, port cameras, numpy targets, landmark ids,
    iris ids, numpy tex (mean, basis), a random state's 8 leaves)."""
    rng = np.random.default_rng(seed)
    if kind == "sphere":
        jm = jsmplx.sphere_head_model(subdiv=8)
    else:
        jm = jsmplx.random_test_model(rng, num_verts=80, num_joints=20, num_betas=4,
                                      num_expr=3)
        # three distinct ids a face: XLA's CPU code fuses the area's products
        # into an FMA, so a face with a repeated id gets a rounding-sized area
        # and passes the degenerate test in the JAX package only
        jm = jm._replace(faces=np.stack([rng.permutation(80)[:3] for _ in range(120)]))
    jc, tc = camera_pair(rng, 4)
    V = jm.v_template.shape[0]
    lmk_ids = np.linspace(0, V - 1, 68).astype(np.int64)
    iris_ids = np.array([3, V - 4], np.int64)
    h, w = SIZE[0] // 4, SIZE[1] // 4
    targets = dict(
        lmk_px=(rng.random((4, 68, 2)) * SIZE[0]).astype(np.float32),
        iris_px=(rng.random((4, 2, 2)) * SIZE[0]).astype(np.float32),
        mask=(rng.random((4, h, w)) > 0.4).astype(np.float32),
        hair_mask=(rng.random((4, h, w)) > 0.8).astype(np.float32),
        face_mask=(rng.random((4, h, w)) > 0.5).astype(np.float32),
        image=rng.random((4, h, w, 3)).astype(np.float32))
    tex = (np.full((V, 3), 0.5, np.float32),
           rng.normal(size=(V, 3, 5)).astype(np.float32) * 0.05)
    sh = rng.normal(size=(4, 9, 3)) * 0.3
    sh[:, 0] += 1.5
    leaves = [rng.normal(size=jm.num_betas) * 0.3, rng.normal(size=max(jm.num_expr, 1)) * 0.3,
              rng.normal(size=5) * 0.5, sh,
              rng.normal(size=(jm.num_joints, 3)) * 0.1, rng.normal(size=3) * 0.05,
              rng.normal(size=3) * 0.02, np.float32(0.05)]
    leaves = [np.asarray(x, np.float32) for x in leaves]
    return jm, jc, tc, targets, lmk_ids, iris_ids, tex, leaves


def losses_both(kind, fix_shoulder=True):
    jm, jc, tc, targets, lmk_ids, iris_ids, (mean, basis), leaves = make_case(kind)
    init = jopt.default_init_pose(jm.num_joints)
    jmask = jopt.free_joint_mask(jm.num_joints, fix_shoulder)
    jtex = jtexture.FlameTex(jnp.asarray(mean), jnp.asarray(basis))
    jtgt = jopt.FitTargets(**{k: jnp.asarray(v) for k, v in targets.items()})

    def jterms(p):
        return jopt.fit_losses(jm, p, jc, SIZE, jtgt, lmk_ids, iris_ids, jnp.asarray(init),
                               jnp.asarray(jmask), jtex, jopt.DEFAULT_WEIGHTS, sil_scale=4)
    jp = jopt.FitParams(*(jnp.asarray(x) for x in leaves))
    jvals = {k: float(v) for k, v in jterms(jp).items()}
    tm = torch_model(jm)
    ttex = texture.FlameTex(torch.from_numpy(mean), torch.from_numpy(basis))
    ttgt = opt.FitTargets(**targets).to("cpu")
    tp = opt.fit_params_from_numpy(leaves, "cpu")
    for p in tp:
        p.requires_grad_(True)

    def tterms(p):
        return opt.fit_losses(tm, p, tc, SIZE, ttgt, lmk_ids, iris_ids, torch.from_numpy(init),
                              torch.from_numpy(jmask), ttex, opt.DEFAULT_WEIGHTS, sil_scale=4)
    return jterms, jp, jvals, tterms, tp


@pytest.mark.parametrize("kind", ["sphere", "joints20"])
def test_fit_losses_terms_and_gradients_match_jax(kind):
    jterms, jp, jvals, tterms, tp = losses_both(kind)
    terms = tterms(tp)
    assert list(terms) == list(jvals), (list(terms), list(jvals))
    expected = ["lmk", "eyed", "inside_mask", "mesh_mask", "image", "albedo", "reg_shape",
                "reg_exp", "reg_tex", "reg_scale"] + (["reg_shoulder"] if kind != "sphere" else [])
    assert list(terms) == expected
    for k, v in terms.items():
        np.testing.assert_allclose(float(v), jvals[k], rtol=1e-5, atol=1e-9, err_msg=k)
    for name in ("lmk", "mesh_mask", "image", "albedo", "reg_shoulder"):
        if name not in terms:
            continue
        grads = torch.autograd.grad(tterms(tp)[name], list(tp), allow_unused=True)
        jgrads = [np.asarray(g) for g in jax.grad(lambda p: jterms(p)[name])(jp)]
        scale = max(max((np.abs(g).max() for g in jgrads if g.size), default=0.0), 1e-9)
        for field, g, jg in zip(opt.FitParams._fields, grads, jgrads):
            g = np.zeros_like(jg) if g is None else g.numpy()
            assert np.isfinite(g).all(), (name, field)
            np.testing.assert_allclose(g, jg, rtol=0, atol=TOL[name] * scale,
                                       err_msg=f"{name} d/d{field}")


def test_loss_primitives_match_jax(rng):
    pred = rng.normal(size=(3, 70, 2)).astype(np.float32) * 5
    gt = rng.normal(size=(3, 70, 2)).astype(np.float32) * 5
    w = opt.landmark_point_weights(70)
    np.testing.assert_array_equal(w, jopt.landmark_point_weights(70))
    assert float(opt.weighted_lmk_l1(torch.from_numpy(pred), torch.from_numpy(gt),
                                     torch.from_numpy(w))) == pytest.approx(
        float(jopt.weighted_lmk_l1(pred, gt, jnp.asarray(w))), rel=1e-6)
    assert float(opt.eyed_loss(torch.from_numpy(pred[:, :68]), torch.from_numpy(gt[:, :68]))) \
        == pytest.approx(float(jopt.eyed_loss(pred[:, :68], gt[:, :68])), rel=1e-6)
    a, b = rng.normal(size=50).astype(np.float32) * 2, rng.normal(size=50).astype(np.float32)
    assert float(opt.huber(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jopt.huber(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
    for fs in (False, True):
        np.testing.assert_array_equal(opt.free_joint_mask(55, fs), jopt.free_joint_mask(55, fs))
    np.testing.assert_array_equal(opt.default_init_pose(55), jopt.default_init_pose(55))
    leaves = [np.zeros(2), np.zeros(1), np.zeros(0), np.zeros((1, 9, 3)), np.zeros((1, 3)),
              np.array([0.1, -0.2, 0.3]), np.array([0.01, 0.02, -0.03]), np.float32(0.05)]
    tp = opt.fit_params_from_numpy(leaves, "cpu")
    jp = jopt.FitParams(*(jnp.asarray(np.asarray(x, np.float32)) for x in leaves))
    np.testing.assert_allclose(opt.model_tsfm_matrix(tp).numpy(),
                               np.asarray(jopt.model_tsfm_matrix(jp)), rtol=0, atol=1e-7)


def test_optimiser_step_matches_optax_and_zeroes_nans(rng):
    """zero_nans + clip_by_global_norm(1) + Adam with a 0.03 decay over the 8
    FitParams leaves (one of them empty, one a scalar); step 1's gradients
    hold NaNs, step 2's are large enough to clip."""
    shapes = [(4,), (1,), (0,), (2, 9, 3), (5, 3), (3,), (3,), ()]
    params = [np.asarray(rng.normal(size=s), np.float32) for s in shapes]
    grads = []
    for k in range(4):
        g = [np.asarray(rng.normal(scale=5.0 if k == 2 else 0.05, size=s), np.float32)
             for s in shapes]
        if k == 1:
            g[4][1, 2] = np.nan
            g[7] = np.array(np.nan, np.float32)
        grads.append(g)
    tx = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(1.0),
                     optax.adam(optax.exponential_decay(5e-3, 4, 0.03)))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(np.array(p)) for p in params]
    o = OptaxAdam(tp, 5e-3, 4, max_norm=1.0, decay_rate=0.03, zero_nans=True)
    for k in range(4):
        updates, state = tx.update([jnp.asarray(g) for g in grads[k]], state, jp)
        jp = optax.apply_updates(jp, updates)
        o.step([torch.from_numpy(np.array(g)) for g in grads[k]])
        for a, b in zip(tp, jp):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def fit_both(kind, iters, **kw):
    jm, jc, tc, targets, lmk_ids, iris_ids, (mean, basis), _ = make_case(kind)
    jtex = jtexture.FlameTex(jnp.asarray(mean), jnp.asarray(basis))
    jp, jl = jopt.fit_bust_full(jm, jc, SIZE, jopt.FitTargets(
        **{k: jnp.asarray(v) for k, v in targets.items()}), lmk_ids, iris_vertex_ids=iris_ids,
        tex_model=jtex, iters=iters, sil_scale=4, **kw)
    tp, tl = opt.fit_bust_full(torch_model(jm), tc, SIZE, opt.FitTargets(**targets), lmk_ids,
                               iris_vertex_ids=iris_ids, tex_model=texture.FlameTex(
                                   torch.from_numpy(mean), torch.from_numpy(basis)),
                               iters=iters, sil_scale=4, **kw)
    return jp, jl, tp, tl


def test_fit_bust_full_trajectory_matches_jax():
    jp, jl, tp, tl = fit_both("sphere", 30)
    assert len(tl) == len(jl) == 10 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for field in ("global_rot", "global_transl", "log_scale"):
        np.testing.assert_allclose(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)),
                                   rtol=0, atol=10 * 5e-3, err_msg=field)
    np.testing.assert_allclose(opt.model_tsfm_matrix(tp).numpy(),
                               np.asarray(jopt.model_tsfm_matrix(jp)), rtol=0, atol=10 * 5e-3)


def test_fit_bust_full_survives_hostile_targets(rng):
    """Landmark targets at 1e5 pixels (a failed detector): zero_nans and the
    clip keep every parameter finite, as in the JAX package."""
    jm = jsmplx.random_test_model(rng, num_verts=48, num_joints=3)
    jc, tc = camera_pair(rng, 2)
    lmk_ids = np.linspace(0, 47, 68).astype(np.int64)
    lmk = rng.normal(size=(2, 68, 2)).astype(np.float32) * 1e5
    tp, tl = opt.fit_bust_full(torch_model(jm), tc, (64, 64), opt.FitTargets(lmk_px=lmk),
                               lmk_ids, iters=8)
    jp, jl = jopt.fit_bust_full(jm, jc, (64, 64), jopt.FitTargets(lmk_px=jnp.asarray(lmk)),
                                lmk_ids, iters=8)
    for a, b in zip(tp, jp):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_simple_fit_bust_matches_jax(rng):
    """The landmark + splat-silhouette fit (plain Adam): the similarity fit of
    tests/test_bustfit.py at 60 steps, both packages from the same targets."""
    jm = jsmplx.random_test_model(rng, num_verts=48)
    jc, tc = camera_pair(rng, 4)
    true = jopt.init_params(jm)._replace(
        global_rot=jnp.asarray(np.array([0.05, -0.1, 0.08], np.float32)),
        global_transl=jnp.asarray(np.array([0.02, -0.03, 0.01], np.float32)),
        log_scale=jnp.asarray(np.float32(0.1)))
    verts = jopt.apply_similarity(true, jsmplx.lbs_forward(jm, true.betas, true.pose)[0])
    lmk_ids = np.arange(0, 48, 3)
    target = np.asarray(jopt.project_to_pixels(jc, (128, 128), verts[lmk_ids]))
    masks = (rng.random((4, 16, 16)) > 0.5).astype(np.float32)
    kw = dict(iters=60, lr=2e-2, weights={"lmk": 1.0, "mask": 0.5, "reg": 1e-5})
    jp, jl = jopt.fit_bust(jm, jc, (128, 128), lmk_ids, target, masks, np.arange(48), **kw)
    tp, tl = opt.fit_bust(torch_model(jm), tc, (128, 128), lmk_ids, target, masks,
                          np.arange(48), **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for field in ("global_rot", "global_transl", "log_scale"):
        np.testing.assert_allclose(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)),
                                   rtol=0, atol=1e-4, err_msg=field)
    assert tl[-1] < 0.5 * tl[0]
