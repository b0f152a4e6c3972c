"""The port's MVS training (monohair_tpu_torch.mvs.train, the flax-faithful
BatchNorm, the cosine Adam and the carried state) against the JAX package's
(monohair_tpu.mvs.train) on the CPU, at a small size: 2 views of 32x32, 64-point
batches, the fusion transformer cut to width 32, depth 1 and 4 heads.

Both packages start from one flax TrainState, carried into the port
(`state_dict_from_flax`, `adam_state_from_flax`); the tolerances are stated in
each test. The conv biases in front of a BatchNorm have a true gradient of 0
(the norm subtracts the batch mean), so theirs is rounding noise in either
package and Adam's first step moves them by +-lr either way (the Adam trap of
ROADMAP.md §3): the updated parameters are held on >= 98% of the elements."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monohair_tpu.models import pifu as jpifu
from monohair_tpu.mvs import train as jtrain
from monohair_tpu_torch.models import pifu as tpifu
from monohair_tpu_torch.models.convert import (adam_state_from_flax, load_weights,
                                               state_dict_from_flax)
from monohair_tpu_torch.models.unet import FlaxBatchNorm2d
from monohair_tpu_torch.mvs import train as ttrain
from monohair_tpu_torch.optim import OptaxAdam, cosine_decay_lr
from monohair_tpu_torch.synthetic import cameras_numpy, ring_camera_list

torch.set_num_threads(1)

V, H, W, N = 2, 32, 32, 64
SMALL = dict(vit_dim=32, vit_depth=1, vit_heads=4)
LR, STEPS = 1e-3, 10
KINDS = {"occ": (jpifu.OccAttn, tpifu.OccAttn, "occ_vit"),
         "ori": (jpifu.OriAttn, tpifu.OriAttn, "vit")}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch(rng, is_occ):
    pts = rng.uniform(-0.08, 0.08, (N, 3)).astype(np.float32)
    if is_occ:
        return pts, rng.integers(0, 2, N).astype(np.int32)
    d = rng.normal(size=(N, 3))
    return pts, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def port_state(jstate, kind, with_adam=False):
    """The port's TrainState carried from a flax TrainState."""
    _, tcls, prefix = KINDS[kind]
    model = tcls(num_views=V, **SMALL)
    load_weights(model, state_dict_from_flax(numpy_tree(jstate.params),
                                             numpy_tree(jstate.batch_stats), prefix))
    state = ttrain.TrainState(model, ttrain.make_optimizer(model, LR, STEPS),
                              int(jstate.step))
    if with_adam:
        adam = adam_state_from_flax(numpy_tree(jstate.opt_state),
                                    numpy_tree(jstate.batch_stats), prefix, state.param_names())
        ttrain.load_adam_state(state, adam["mu"], adam["nu"], adam["count"])
    return state


def as_torch_names(jstate, kind, tree=None):
    """A flax state's parameters (or a tree shaped like them) and BatchNorm
    statistics under the port's names."""
    return state_dict_from_flax(numpy_tree(jstate.params if tree is None else tree),
                                numpy_tree(jstate.batch_stats), KINDS[kind][2])


@pytest.fixture(scope="module", params=sorted(KINDS))
def run(request):
    """Two JAX steps (make_train_step) and an eval (make_eval_step) from a
    fresh create_state; the port's step from the carried start state, and its
    gradients."""
    kind = request.param
    is_occ = kind == "occ"
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (V, H, W, 4)).astype(np.float32)
    ndc, w2c = (a.astype(np.float32) for a in cameras_numpy(ring_camera_list(V)))
    b1, b2 = batch(rng, is_occ), batch(rng, is_occ)
    jcls = KINDS[kind][0]
    jmodel = jcls(num_views=V, **SMALL)
    tx = optax.adam(optax.cosine_decay_schedule(LR, STEPS))
    js0, _ = jtrain.create_state(jmodel, jax.random.PRNGKey(0), V, (H, W), optimizer=tx)
    jstep = jtrain.make_train_step(jmodel, tx, is_occ=is_occ)
    cams = tuple(jnp.asarray(a) for a in (imgs, w2c, ndc))
    js1, jloss1 = jstep(js0, *cams, *map(jnp.asarray, b1))
    js2, jloss2 = jstep(js1, *cams, *map(jnp.asarray, b2))
    jeval = jtrain.make_eval_step(jmodel, is_occ)(js1, *cams, *map(jnp.asarray, b2))

    tcams = tuple(torch.from_numpy(a) for a in (imgs, w2c, ndc))
    ts = port_state(js0, kind)
    tloss1, grads = ttrain.loss_and_grads(ts, *tcams, *map(torch.from_numpy, b1))
    ts.opt.step(grads)
    return dict(kind=kind, js0=js0, js1=js1, js2=js2, jloss1=float(jloss1),
                jloss2=float(jloss2), jeval=numpy_tree(jeval), ts=ts, tloss1=float(tloss1),
                grads=dict(zip(ts.param_names(), grads)), tcams=tcams, b2=b2)


def pre_norm_bias(name):
    """A conv bias that a BatchNorm follows (its true gradient is 0)."""
    return name.startswith("backbone.") and name.endswith(".bias") and ".up.bias" not in name


def test_train_step_loss(run):
    """The first step's loss within 1e-5 relative."""
    np.testing.assert_allclose(run["tloss1"], run["jloss1"], rtol=1e-5)


def test_train_step_gradients(run):
    """Each parameter's gradient within 1e-3 of its JAX norm; the pre-norm
    conv biases' (rounding noise in both) within 1e-4 of the whole
    gradient's norm. JAX's gradient is read from Adam's first moment
    (mu = (1 - 0.9) g)."""
    mu = adam_state_from_flax(numpy_tree(run["js1"].opt_state), numpy_tree(run["js1"].batch_stats),
                              KINDS[run["kind"]][2], list(run["grads"]))["mu"]
    jgrads = {k: v / np.float32(0.1) for k, v in mu.items()}
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in jgrads.values()))
    for name, g in run["grads"].items():
        err = float(np.abs(g.numpy() - jgrads[name]).max())
        if pre_norm_bias(name):
            assert err <= 1e-4 * total, name
        else:
            assert err <= 1e-3 * np.linalg.norm(jgrads[name]) + 1e-9 * total, (name, err)


def test_train_step_batch_stats(run):
    """The BatchNorm running statistics after the step within 1e-5: flax's
    biased variance in both the normalisation and the running update."""
    j = as_torch_names(run["js1"], run["kind"])
    sd = run["ts"].model.state_dict()
    keys = [k for k in j if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 2 * 7
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), j[k], rtol=0, atol=1e-5, err_msg=k)


def test_train_step_updated_parameters(run):
    """After one Adam step, >= 98% of the parameters' elements within 1e-6 of
    JAX's (the step moves each by up to lr = 1e-3), and every element within
    2 lr."""
    j = as_torch_names(run["js1"], run["kind"])
    close = total = 0
    for name, p in run["ts"].model.named_parameters():
        d = np.abs(p.detach().numpy() - j[name])
        assert d.max() <= 2 * LR * (1 + 1e-3), name
        close += int((d <= 1e-6).sum())
        total += d.size
    assert close >= 0.98 * total, close / total
    assert run["ts"].opt.count == 1


def test_resumed_step_from_carried_adam_state(run):
    """JAX's state after its first step, Adam's moments and count included,
    carried into the port; the port's second step then agrees with JAX's
    second on the loss (1e-5 relative) and on >= 98% of the parameters'
    elements within 1e-6."""
    kind = run["kind"]
    ts = port_state(run["js1"], kind, with_adam=True)
    assert ts.opt.count == 1 and ts.step == 1
    loss = ttrain.train_step(ts, *run["tcams"], *map(torch.from_numpy, run["b2"]))
    np.testing.assert_allclose(float(loss), run["jloss2"], rtol=1e-5)
    assert ts.step == 2 and ts.opt.count == 2
    j = as_torch_names(run["js2"], kind)
    close = total = 0
    for name, p in ts.model.named_parameters():
        d = np.abs(p.detach().numpy() - j[name])
        close += int((d <= 1e-6).sum())
        total += d.size
    assert close >= 0.98 * total, close / total
    sd = ts.model.state_dict()
    for k in j:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), j[k], rtol=0, atol=1e-5, err_msg=k)


def test_eval_step(run):
    """make_eval_step on the state after one step: the loss within 1e-5
    relative, the outputs within 1e-4 (frozen statistics, nothing moves)."""
    ts = port_state(run["js1"], run["kind"])
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    loss, out = ttrain.eval_step(ts, *run["tcams"], *map(torch.from_numpy, run["b2"]))
    jloss, jout = run["jeval"]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-4)
    for k, v in ts.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    if run["kind"] == "occ":
        labels = run["b2"][1]
        assert ttrain.occ_metrics(out, labels) == pytest.approx(
            jtrain.occ_metrics(jnp.asarray(jout), labels), abs=1e-12)


@pytest.mark.parametrize("fast", [True, False])
def test_flax_batchnorm_train_mode(fast):
    """FlaxBatchNorm2d in train mode against flax's nn.BatchNorm (momentum
    0.9, eps 1e-5) on a 2-view 8x8 map: the output within 1e-5 and the running
    statistics within 1e-6, with flax's default use_fast_variance and with
    the two-pass variance. nn.BatchNorm2d's own running variance is the
    unbiased one, n/(n-1) = 128/127 larger on the update."""
    import flax.linen as nn
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 8, 8, 5)) * 2 + 0.7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      use_fast_variance=fast)
    y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": np.zeros(5, np.float32),
                                       "var": np.ones(5, np.float32)}},
                      jnp.asarray(x), mutable=["batch_stats"])
    m = FlaxBatchNorm2d(5, eps=1e-5).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    out = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    ref = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=0.1).train()
    ref(torch.from_numpy(x).permute(0, 3, 1, 2))
    biased = (m.running_var - 0.9) / 0.1
    np.testing.assert_allclose(((ref.running_var - 0.9) / 0.1).numpy(),
                               biased.numpy() * 128 / 127, rtol=1e-4)


def test_losses_match_the_jax_heads():
    """OccAttn.loss (cross-entropy) and OriAttn.loss (sign-agnostic L1) against
    the flax heads' static losses, within 1e-6 relative."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(64, 2)).astype(np.float32) * 3
    labels = rng.integers(0, 2, 64).astype(np.int32)
    np.testing.assert_allclose(
        float(tpifu.OccAttn.loss(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jpifu.OccAttn.loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    pred, gt = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(tpifu.OriAttn.loss(torch.from_numpy(pred), torch.from_numpy(gt))),
        float(jpifu.OriAttn.loss(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-6)


def test_cosine_schedule_matches_optax_at_every_step():
    """optax.cosine_decay_schedule(lr, T) and the port's at every count of a
    run past its end (0..T+3): within one f32 ulp of the rate's start (XLA's
    f32 cosine is not correctly rounded; the port's is). Then optax.adam with
    it and OptaxAdam with schedule="cosine" on the same gradients for T+3
    steps: the parameters within 1e-7."""
    lr, T = 3e-4, 37
    sched = optax.cosine_decay_schedule(lr, T)
    for k in range(T + 4):
        assert abs(cosine_decay_lr(lr, T, k) - float(sched(jnp.asarray(k, jnp.int32)))) \
            <= 1e-6 * lr, k
    assert cosine_decay_lr(lr, T, T + 3) == 0.0
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    tx = optax.adam(sched)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    opt = OptaxAdam([tp], lr, T, max_norm=None, schedule="cosine")
    for _ in range(T + 3):
        g = rng.normal(size=p0.shape).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g)])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)


def test_flax_init_draws_create_states_distributions():
    """flax_init against the JAX package's create_state at full width: the
    same tensors zero, one or drawn; the standard deviations of the drawn
    tensors of >= 1024 elements within 10% of each other (lecun_normal over
    flax's fan-in), the normal(1.0) ones (cls token, position table,
    re-attention mixes) pooled within 10% of 1; the lecun draws within +-2 of
    their standard deviations; and the draws follow the generator."""
    jmodel = jpifu.OccAttn(num_views=16)
    js, _ = jtrain.create_state(jmodel, jax.random.PRNGKey(0), 16, (32, 32))
    j = as_torch_names(js, "occ")
    model = tpifu.flax_init(tpifu.OccAttn(num_views=16), torch.Generator().manual_seed(0))
    unit = []
    for name, p in model.named_parameters():
        a, b = p.detach().numpy(), j[name]
        if np.all(b == b.flat[0]):
            assert np.array_equal(a, b), name
        elif name.endswith(("cls_token", "pos_embedding", "reattn_weights")):
            unit.append(a.ravel())
        elif b.size >= 1024:
            assert abs(a.std() / b.std() - 1) < 0.1, (name, a.std(), b.std())
    assert len(unit) == 5 and abs(np.concatenate(unit).std() - 1) < 0.1
    w = model.backbone.inc.double_conv[0].weight.detach()        # fan-in 4 * 25
    assert float(w.abs().max()) <= 2 * (1 / 100) ** 0.5 / 0.8796256610342398 + 1e-6
    again = tpifu.flax_init(tpifu.OccAttn(num_views=16), torch.Generator().manual_seed(0))
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
