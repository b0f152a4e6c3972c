"""The segmentation nets' train mode and training step in the port
(segment/{nn_blocks,backbones,bisenet,modnet,fan}.py with ops/norm.py's
flax-faithful BatchNorm, segment/train.py) against the JAX package's flax nets
and tools/train_hair_parser.py's objectives, on the CPU at a small size:
BiSeNet and MODNet at width 0.25 on 64x64 frames, FAN (1 module of depth 2,
width 0.125) on 64x64 crops, batches of 2 and 1.

The flax weights go into the port through the JAX package's tree writer and
the port's loader (segment/convert.py). The tool's loss_fn/m_loss and jitted
steps are rebuilt here from monohair_tpu.segment, because the tool's main is
one function (the MODNet step calls the net without its train flag, so its
BatchNorms run on the running statistics; the port's step keeps that).

The comparisons run in float64 in both packages (jax.enable_x64) and in
float32. These small random nets in train mode are ill-conditioned (BatchNorm
over 2x2 maps at the /32 scale), so each package's float32 result is held
against flax's float64 one, within the stated tolerance or twice flax's own
float32 error where that is larger. Tolerances: train-mode outputs within
1e-9 of the largest output in float64, 1e-4 in float32; a step's loss within
1e-5 relative and each gradient within 1e-4 of its tensor's norm (1e-8 in
float64); after five Adam steps the parameters within 1e-5 on >= 98% of the
elements (an element whose gradient is rounding noise moves by +-lr: the Adam
trap of ROADMAP.md §3); the antialiased resize within 1e-6."""

import os

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import cv2
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monohair_tpu.segment import bisenet as jbisenet, fan as jfan, modnet as jmodnet
from monohair_tpu.segment.runners import IMAGENET_MEAN, IMAGENET_STD, save_flax_tree
from monohair_tpu_torch.mvs.train import TrainState, make_optimizer
from monohair_tpu_torch.ops.norm import FlaxBatchNorm2d
from monohair_tpu_torch.segment import train as strain
from monohair_tpu_torch.segment.bisenet import BiSeNet
from monohair_tpu_torch.segment.convert import flax_npz_to_state_dict, load_flax_npz
from monohair_tpu_torch.segment.fan import FAN
from monohair_tpu_torch.segment.modnet import MODNet

torch.set_num_threads(1)

SIZE = 64
NETS = {
    "bisenet": (lambda: jbisenet.BiSeNet(19, width=0.25), lambda: BiSeNet(19, width=0.25)),
    "modnet": (lambda: jmodnet.MODNet(width=0.25), lambda: MODNet(width=0.25)),
    "fan": (lambda: jfan.FAN(num_modules=1, depth=2, width=0.125),
            lambda: FAN(num_modules=1, depth=2, width=0.125)),
}
LR = 1e-3


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def param_names(params) -> dict:
    """A flax params tree (or one shaped like it) under the port's names and
    layouts, unrounded: conv kernels HWIO -> OIHW, dense kernels transposed,
    scales as weights (the table of segment/convert.py)."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        base, leaf, v = ".".join(p.key for p in path[:-1]), path[-1].key, np.asarray(v)
        if leaf == "kernel":
            out[base + ".weight"] = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        else:
            out[base + (".weight" if leaf == "scale" else "." + leaf)] = v
    return out


def stats_names(batch_stats) -> dict:
    """flax batch_stats as the port's running_mean/running_var, unrounded."""
    return {".".join(p.key for p in path[:-1]) + ".running_" + path[-1].key: np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(batch_stats)[0]}


def port_net(name, tmp_path, variables):
    """The port's net holding the flax variables."""
    path = str(tmp_path / f"net{len(os.listdir(tmp_path))}.npz")
    save_flax_tree(path, numpy_tree(variables))
    return load_flax_npz(NETS[name][1](), path)


def jax_variables(name, seed=0, stats_rng=None):
    """flax's init of the small net; with stats_rng, running statistics
    drawn away from 0 and 1 so their update is seen."""
    net = NETS[name][0]()
    variables = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)), True)
    variables = numpy_tree(variables)
    if stats_rng is not None:
        def perturb(path, v):
            if path[-1].key == "var":
                return stats_rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            return stats_rng.normal(size=v.shape).astype(np.float32)
        variables = dict(variables, batch_stats=jax.tree_util.tree_map_with_path(
            perturb, variables["batch_stats"]))
    return net, variables


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def flax_train_forward(jnet, variables, x, dtype):
    """apply(train=True, mutable=["batch_stats"]) in dtype (float64 inside
    jax.enable_x64): (outputs, updated batch_stats), as numpy."""
    with jax.enable_x64(dtype == np.float64):
        cast = jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v, dtype)), variables)
        out, upd = jnet.apply(cast, jnp.asarray(x.astype(dtype)), True, mutable=["batch_stats"])
        return [np.asarray(o) for o in out], numpy_tree(upd["batch_stats"])


@pytest.mark.parametrize("batch", [2, 1])
@pytest.mark.parametrize("name", sorted(NETS))
def test_train_mode_forward_matches_flax(name, batch, tmp_path):
    """apply(train=True, mutable=["batch_stats"]) against the port's net in
    train mode, with flax's momentum 0.99 on AttentionRefinement.bn_atten and
    FAN's norms and 0.9 elsewhere. At batch 1 BiSeNet's global-pool branches
    hold one value per channel (variance 0).
    - In float64 (both packages): every output within 1e-9 of its largest
      value, the running statistics after the update within 1e-10.
    - In float32, against flax's float64 results: the outputs within 1e-4 of
      their largest value and the running statistics within 1e-5, or within
      twice flax's own float32 error where that is larger. Train-mode
      BatchNorm over 2x2 maps at the /32 scale makes these random nets
      ill-conditioned: each package's f32 outputs are up to ~7e-4 of their
      largest value from float64 there."""
    rng = np.random.default_rng(batch)
    jnet, variables = jax_variables(name, stats_rng=rng)
    x = rng.normal(size=(batch, SIZE, SIZE, 3)).astype(np.float32)
    net = port_net(name, tmp_path, variables).train()
    net64 = port_net(name, tmp_path, variables).train().double()
    j64, upd64 = flax_train_forward(jnet, variables, x, np.float64)
    j32, upd32 = flax_train_forward(jnet, variables, x, np.float32)
    with torch.no_grad():
        out = [o.permute(0, 2, 3, 1).numpy() for o in net(nchw(x))]
        out64 = [o.permute(0, 2, 3, 1).numpy() for o in net64(nchw(x).double())]
    assert len(out) == len(j64) == len(out64)
    for o, o64, ref, jo in zip(out, out64, j64, j32):
        top = np.abs(ref).max()
        assert np.abs(o64 - ref).max() <= 1e-9 * top, (name, np.abs(o64 - ref).max())
        err, jerr = np.abs(o - ref).max() / top, np.abs(jo - ref).max() / top
        assert err <= max(1e-4, 2 * jerr), (name, err, jerr)
    want, want32 = stats_names(upd64), stats_names(upd32)
    got, got64 = net.state_dict(), net64.state_dict()
    assert want and set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got64[k].numpy(), v, rtol=0, atol=1e-10, err_msg=k)
        err, jerr = np.abs(got[k].numpy() - v).max(), np.abs(want32[k] - v).max()
        assert err <= max(1e-5, 2 * jerr), (k, err, jerr)
    momenta = {k: m.flax_momentum for k, m in net.named_modules()
               if isinstance(m, FlaxBatchNorm2d)}
    assert len(momenta) == len(want) // 2
    slow = {k for k, v in momenta.items() if v == 0.99}
    if name == "fan":
        assert slow == set(momenta)
    elif name == "bisenet":
        assert slow == {"cp.arm16.bn_atten", "cp.arm32.bn_atten"}
    else:
        assert not slow


def test_batchnorm_of_one_value_a_channel():
    """A channel holding one value (the (N, C, 1, 1) pool branches at batch 1)
    normalises to its bias and moves the running variance toward 0, where
    nn.BatchNorm2d raises."""
    m = FlaxBatchNorm2d(3, momentum=0.99).train()
    with torch.no_grad():
        m.bias.copy_(torch.tensor([0.5, -1.0, 2.0]))
        y = m(torch.tensor([[[[3.0]], [[-7.0]], [[0.25]]]]))
    assert torch.equal(y.flatten(), torch.tensor([0.5, -1.0, 2.0]))
    np.testing.assert_allclose(m.running_var.numpy(), 0.99, rtol=1e-7)
    np.testing.assert_allclose(m.running_mean.numpy(), [0.03, -0.07, 0.0025], rtol=1e-6)
    with pytest.raises(ValueError):
        torch.nn.BatchNorm2d(3).train()(torch.ones(1, 3, 1, 1))


def test_eval_mode_is_nn_batchnorm2d():
    """Eval mode runs nn.BatchNorm2d's own forward on the running statistics:
    the same bits."""
    g = torch.Generator().manual_seed(0)
    m = FlaxBatchNorm2d(4, momentum=0.99)
    ref = torch.nn.BatchNorm2d(4)
    for bn in (m, ref):
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 2.0, 4))
            bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
            bn.running_mean.copy_(torch.linspace(-0.3, 0.3, 4))
            bn.running_var.copy_(torch.linspace(0.2, 3.0, 4))
    x = torch.randn(2, 4, 5, 7, generator=g)
    assert torch.equal(m.eval()(x), ref.eval()(x))


# ---------------------------------------------------------------------------
# the tool's objectives and steps, rebuilt from monohair_tpu.segment
# ---------------------------------------------------------------------------

def jax_parser_step(net, tx):
    """train_hair_parser.py's loss_fn and jitted step for BiSeNet."""
    def loss_fn(params, stats, x, y):
        (o, o16, o32), new_model = net.apply(
            {"params": params, "batch_stats": stats}, x, True, mutable=["batch_stats"])
        y1 = jax.nn.one_hot(y, 19)

        def ce(o):
            return jnp.mean(optax.softmax_cross_entropy(o, y1))
        return ce(o) + ce(o16) + ce(o32), new_model["batch_stats"]

    @jax.jit
    def step(params, stats, opt, x, y):
        (l, stats), g = jax.value_and_grad(loss_fn, has_aux=True)(params, stats, x, y)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(params, up), stats, opt, l, g

    return step


def jax_matte_step(net, tx):
    """train_hair_parser.py's m_loss and jitted m_step for MODNet (the net
    called without its train flag, as the tool calls it)."""
    def m_loss(params, stats, x, y, band):
        (sem, det, matte), new_model = net.apply(
            {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        sem, det, matte = sem[..., 0], det[..., 0], matte[..., 0]
        sem_gt = jax.image.resize(y, sem.shape, "linear")
        det_gt = jax.image.resize(y, det.shape, "linear")
        det_band = jax.image.resize(band, det.shape, "linear")
        l_sem = jnp.mean((sem - sem_gt) ** 2)
        l_det = jnp.sum(det_band * jnp.abs(det - det_gt)) / jnp.maximum(jnp.sum(det_band), 1.0)
        l_mat = jnp.mean(jnp.abs(matte - y))
        return l_sem + 10.0 * l_det + l_mat, new_model["batch_stats"]

    @jax.jit
    def step(params, stats, opt, x, y, band):
        (l, stats), g = jax.value_and_grad(m_loss, has_aux=True)(params, stats, x, y, band)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(params, up), stats, opt, l, g

    return step


def boundary_band(y: np.ndarray) -> np.ndarray:
    """The tool's dilate-minus-erode band (13x13), through cv2."""
    kern = np.ones((13, 13), np.uint8)
    return np.stack([cv2.dilate(m, kern) - cv2.erode(m, kern) for m in y])


def blob_mattes(rng, n: int, size: int = SIZE) -> np.ndarray:
    """(n, size, size) float32 {0, 1} mattes: a disc each."""
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(0.3, 0.7, 2) * size
        r = rng.uniform(0.15, 0.35) * size
        out.append(((xx - cx) ** 2 + (yy - cy) ** 2 < r * r).astype(np.float32))
    return np.stack(out)


def batches(kind: str, rng, n_steps: int, batch: int = 2):
    """Inputs of n_steps steps as the tool makes them: ImageNet-normalised
    frames and labels in {0, 1, 17} (parser), or [-1, 1] frames, {0, 1}
    mattes and their bands (matte)."""
    out = []
    for _ in range(n_steps):
        frames = rng.integers(0, 256, (batch, SIZE, SIZE, 3)).astype(np.float32) / 255.0
        if kind == "parser":
            x = (frames - IMAGENET_MEAN) / IMAGENET_STD
            y = rng.choice(np.array([0, 1, 17], np.int32), (batch, SIZE, SIZE))
            out.append((x.astype(np.float32), y))
        else:
            y = blob_mattes(rng, batch)
            out.append((((frames - 0.5) / 0.5).astype(np.float32), y, boundary_band(y)))
    return out


KINDS = {"parser": ("bisenet", jax_parser_step, strain.parser_loss, True),
         "matte": ("modnet", jax_matte_step, strain.matte_loss, False)}


def port_batch(b):
    return (nchw(b[0]),) + tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in b[1:])


def run_steps(kind: str, dtype, tmp) -> dict:
    """Five steps of the tool's jitted loop on a 5-step cosine schedule and the
    port's loop from the same weights on the same batches, both in dtype
    (float64 inside jax.enable_x64): each step's loss and gradients, the
    final parameters and running statistics (port names)."""
    name, make_step, loss_fn, batch_stats = KINDS[kind]
    rng = np.random.default_rng(7)
    jnet, variables = jax_variables(name, seed=1)
    data = batches(kind, rng, 5)
    out = dict(jl=[], jg=[], tl=[], tg=[])
    with jax.enable_x64(dtype == np.float64):
        tx = optax.adam(optax.cosine_decay_schedule(LR, 5))
        step = make_step(jnet, tx)
        cast = jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v, dtype)), variables)
        params, stats = cast["params"], cast["batch_stats"]
        opt = tx.init(params)
        for b in data:
            b = [jnp.asarray(a.astype(dtype) if a.dtype.kind == "f" else a) for a in b]
            params, stats, opt, loss, grads = step(params, stats, opt, *b)
            out["jl"].append(float(loss))
            out["jg"].append(param_names(grads))
        out["jstate"] = {**param_names(params), **stats_names(stats)}
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = port_net(name, tmp, variables).to(tdtype)
    state = TrainState(model, make_optimizer(model, LR, 5))
    names = [n for n, _ in model.named_parameters()]
    for b in data:
        x, *targets = (t.to(tdtype) if t.is_floating_point() else t for t in port_batch(b))
        loss, grads = strain.loss_and_grads(state, loss_fn, x, *targets, batch_stats=batch_stats)
        state.opt.step(grads)
        out["tl"].append(float(loss))
        out["tg"].append({n: g.numpy() for n, g in zip(names, grads)})
    out["tstate"] = {k: v.numpy() for k, v in model.state_dict().items()}
    return out


@pytest.fixture(scope="module", params=sorted(KINDS))
def steps(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    return {np.float64: run_steps(request.param, np.float64, tmp),
            np.float32: run_steps(request.param, np.float32, tmp), "kind": request.param}


def test_first_step_loss(steps):
    """The first step's loss from the same weights within 1e-5 relative in
    float32, 1e-10 in float64."""
    np.testing.assert_allclose(steps[np.float32]["tl"][0], steps[np.float32]["jl"][0], rtol=1e-5)
    np.testing.assert_allclose(steps[np.float64]["tl"][0], steps[np.float64]["jl"][0],
                               rtol=1e-10)


def test_first_step_gradients(steps):
    """Each parameter's first-step gradient: in float64 within 1e-8 of its
    norm; in float32 within 1e-4 of its norm of flax's float64 gradient, or
    within twice flax's own float32 error where that is larger (train-mode
    BatchNorm on random labels leaves some of BiSeNet's gradients ~1e-3 from
    float64 in either package)."""
    g64, t64 = steps[np.float64]["jg"][0], steps[np.float64]["tg"][0]
    g32, t32 = steps[np.float32]["jg"][0], steps[np.float32]["tg"][0]
    assert set(g64) == set(t64) == set(t32)
    for k, want in g64.items():
        norm = np.linalg.norm(want)
        assert np.linalg.norm(t64[k] - want) <= 1e-8 * norm + 1e-15, k
        err, jerr = np.linalg.norm(t32[k] - want), np.linalg.norm(g32[k] - want)
        assert err <= max(1e-4 * norm, 2 * jerr) + 1e-12, (k, err, jerr, norm)


def close_share(got: dict, want: dict, atol: float) -> float:
    """The share of the parameters' elements (running statistics left out)
    within atol."""
    close = total = 0
    for k, v in want.items():
        if not k.endswith(("running_mean", "running_var")):
            d = np.abs(got[k] - v)
            close += int((d <= atol).sum())
            total += d.size
    return close / total


def test_five_adam_steps(steps):
    """Five Adam steps on the 5-step cosine schedule. In float64 (both
    packages): every step's loss within 1e-5 relative, the parameters within
    1e-5 on >= 98% of the elements, the running statistics within 1e-3 (the
    learning rate is an f32 scalar in the port, as in optax's f32 run, and
    f64 in optax's x64 run; train-mode BatchNorm over 2x2 maps carries that
    5e-8 into the losses at ~2e-6 by step 5). In float32, the matte (its
    BatchNorms on the running statistics): the same on the losses and the
    parameters, the running statistics never moved. In float32 the parser
    is held on its first step only: Adam's first step moves each element by
    -lr * sign(gradient), and BiSeNet's train-mode gradients at this size
    are ~1e-3 from float64 in either package, so flax's own f32 run agrees
    with its float64 run on ~5% of the elements after five steps."""
    r64, r32 = steps[np.float64], steps[np.float32]
    np.testing.assert_allclose(r64["tl"], r64["jl"], rtol=1e-5)
    assert close_share(r64["tstate"], r64["jstate"], 1e-5) >= 0.98
    for k, v in r64["jstate"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(r64["tstate"][k], v, rtol=0, atol=1e-3, err_msg=k)
    if steps["kind"] == "matte":
        np.testing.assert_allclose(r32["tl"], r32["jl"], rtol=1e-5)
        assert close_share(r32["tstate"], r32["jstate"], 1e-5) >= 0.98
        for k, v in r32["tstate"].items():
            if k.endswith("running_mean"):
                assert not v.any(), k
            elif k.endswith("running_var"):
                assert np.all(v == 1), k


@pytest.mark.parametrize("src,dst", [((64, 64), (8, 8)), ((512, 512), (64, 64)),
                                     ((48, 80), (6, 10)), ((37, 53), (11, 20)),
                                     ((16, 24), (32, 12))])
def test_antialiased_resize_matches_jax(src, dst):
    """jax.image.resize(..., "linear") with its default antialias, within 1e-6,
    and unlike resize_bilinear (antialias off) on a downsample."""
    rng = np.random.default_rng(3)
    y = rng.random((2,) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(y), (2,) + dst, "linear"))
    got = strain.antialiased_linear_resize(torch.from_numpy(y), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if dst[0] < src[0]:
        off = np.asarray(jax.image.resize(jnp.asarray(y), (2,) + dst, "linear",
                                          antialias=False))
        assert np.abs(off - want).max() > 1e-2


@pytest.mark.parametrize("name", ["bisenet", "modnet"])
def test_init_statistics_match_flax(name):
    """The port's flax_init (mvs.train.create_state's) against flax's init at
    the same shapes: the same tensors; kernels zero-mean with flax's
    lecun_normal std (sqrt(1 / fan_in)) within 10% on tensors of >= 2000
    elements, truncated at 2 / 0.8796 of it; biases 0; norm scales 1, shifts
    0; running statistics 0 and 1."""
    jnet, variables = jax_variables(name, seed=3)
    state = strain.create_state(NETS[name][1](), torch.Generator().manual_seed(3), LR, 10)
    with torch.no_grad():
        want = {}
        for k, v in jax.tree_util.tree_flatten_with_path(variables)[0]:
            want["/".join(p.key for p in k)] = np.asarray(v)
    got = {k: v.numpy() for k, v in state.model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert len(got) == len(want)
    checked = 0
    for k, v in got.items():
        if v.ndim >= 2:
            fan_in = v[0].size
            std = fan_in ** -0.5
            jk = next(w for p, w in want.items()
                      if p.startswith("params/") and w.size == v.size and w.ndim == v.ndim
                      and p[len("params/"):].rsplit("/", 1)[0] == k.rsplit(".", 1)[0].replace(
                          ".", "/"))
            for arr in (v, jk):
                assert np.abs(arr).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6), k
                if arr.size >= 2000:
                    assert abs(arr.std() / std - 1) < 0.1, (k, arr.std(), std)
                    assert abs(arr.mean()) < 0.1 * std, k
                    checked += 1
        elif k.endswith("running_var") or (k.endswith("weight") and v.ndim == 1):
            assert np.all(v == 1), k
        else:
            assert not v.any(), k
    assert checked >= 20
