"""python -m monohair_tpu_torch.train_hair_parser on the CPU at a small size
(width 0.25, 64x64 frames, 4 training and 2 eval frames, 3 + 3 steps) against
tools/train_hair_parser.py's loop rebuilt from monohair_tpu.segment (the
tool's main is one function; its step functions are those of
tests/test_torch_segment_train.py).

- The CLI writes bisenet.npz, modnet.npz, stats.txt and meta.json in the
  tool's format.
- The JAX package's ParsingRunner and MattingRunner load the port's .npz and
  give the port runners' outputs within the runner tolerance of
  tests/test_torch_prepare_data_segment.py (class maps equal on >= 99.5% of
  the pixels, the matte within 1e-4, hair masks within 1 LSB where the
  classes agree).
- Started from the JAX package's initial weights, the CLI's first three
  losses of each net equal the rebuilt JAX loop's (within the tolerances of
  test_first_losses_match_the_jax_loop): the frames, the batch indices and
  the flip coins come from one Generator consumed in the tool's order."""

import json
import os

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monohair_tpu.segment import bisenet as jbisenet, modnet as jmodnet
from monohair_tpu.segment.runners import (IMAGENET_MEAN, IMAGENET_STD,
                                          MattingRunner as JaxMattingRunner,
                                          ParsingRunner as JaxParsingRunner)
from monohair_tpu_torch import train_hair_parser as cli
from monohair_tpu_torch.segment import frames as seg_frames
from monohair_tpu_torch.segment.runners import MattingRunner, ParsingRunner
from tests.test_torch_segment_train import (boundary_band, jax_matte_step, jax_parser_step,
                                            numpy_tree, param_names, stats_names)

torch.set_num_threads(1)

SIZE, WIDTH, STEPS, N_TRAIN, N_EVAL, LR = 64, 0.25, 3, 4, 2, 1e-3
ARGV = ["--device", "cpu", "--width", str(WIDTH), "--steps", str(STEPS),
        "--modnet_steps", str(STEPS), "--n_train", str(N_TRAIN), "--n_eval", str(N_EVAL)]


def jax_init():
    """The tool's inits at this size: BiSeNet from PRNGKey(0) (train=True),
    MODNet from PRNGKey(1)."""
    bnet, mnet = jbisenet.BiSeNet(19, width=WIDTH), jmodnet.MODNet(width=WIDTH)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    return (bnet, numpy_tree(bnet.init(jax.random.PRNGKey(0), x, True)),
            mnet, numpy_tree(mnet.init(jax.random.PRNGKey(1), x)))


def state_dict(variables) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            {**param_names(variables["params"]), **stats_names(variables["batch_stats"])}.items()}


def jax_losses(bnet, bvars, mnet, mvars, frames, labels, rng, dtype=np.float32):
    """The tool's two loops (STEPS steps each) on the frames, drawing the
    batches from rng: the losses of each, in dtype (float64 inside
    jax.enable_x64)."""
    with jax.enable_x64(dtype == np.float64):
        return _jax_losses(bnet, cast(bvars, dtype), mnet, cast(mvars, dtype), frames, labels,
                           rng, dtype)


def cast(variables, dtype):
    return jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v, dtype)), variables)


def _jax_losses(bnet, bvars, mnet, mvars, frames, labels, rng, dtype):
    tx = optax.adam(optax.cosine_decay_schedule(LR, STEPS))
    step = jax_parser_step(bnet, tx)
    params, stats = bvars["params"], bvars["batch_stats"]
    opt = tx.init(params)
    tr_f, tr_l = frames[:N_TRAIN], labels[:N_TRAIN]
    parser = []
    for _ in range(STEPS):
        idx = rng.integers(0, N_TRAIN, 4)
        x = tr_f[idx].astype(dtype) / 255.0
        if rng.random() < 0.5:
            x = x[:, :, ::-1]
            y = tr_l[idx][:, :, ::-1]
        else:
            y = tr_l[idx]
        x = ((x - IMAGENET_MEAN) / IMAGENET_STD).astype(dtype)
        params, stats, opt, loss, _ = step(params, stats, opt, jnp.asarray(x), jnp.asarray(y))
        parser.append(float(loss))
    mtx = optax.adam(optax.cosine_decay_schedule(LR, STEPS))
    mstep = jax_matte_step(mnet, mtx)
    params, stats = mvars["params"], mvars["batch_stats"]
    opt = mtx.init(params)
    matte = []
    for _ in range(STEPS):
        idx = rng.integers(0, N_TRAIN, 4)
        x = (tr_f[idx].astype(dtype) / 255.0 - 0.5) / 0.5
        y = (tr_l[idx] > 0).astype(dtype)
        params, stats, opt, loss, _ = mstep(params, stats, opt, jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(boundary_band(y)))
        matte.append(float(loss))
    return parser, matte


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI from the JAX package's initial weights, and the rebuilt JAX
    loop from the same weights on the same frames and draws."""
    out = str(tmp_path_factory.mktemp("hair_parser"))
    mp = pytest.MonkeyPatch()
    mp.setattr(seg_frames, "FRAME_SIZE", SIZE)
    try:
        bnet, bvars, mnet, mvars = jax_init()
        res = cli.main(ARGV + ["--out", out], parser_init=state_dict(bvars),
                       matte_init=state_dict(mvars))
    finally:
        mp.undo()
    rng = np.random.default_rng(0)
    frames, labels = seg_frames.render_frames(rng, N_TRAIN + N_EVAL, SIZE)
    state = rng.bit_generator.state
    jax32 = jax_losses(bnet, bvars, mnet, mvars, frames, labels, rng)
    rng.bit_generator.state = state
    jax64 = jax_losses(bnet, bvars, mnet, mvars, frames, labels, rng, np.float64)
    return dict(res=res, out=out, frames=frames, labels=labels, jax32=jax32, jax64=jax64)


def test_cli_writes_the_tools_four_files(run):
    out = run["out"]
    assert sorted(os.listdir(out)) == ["bisenet.npz", "meta.json", "modnet.npz", "stats.txt"]
    with open(os.path.join(out, "stats.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0] == f"hair_iou {run['res']['iou']:.4f}"
    assert lines[1] == f"matte_mae {run['res']['mae']:.4f}"
    assert lines[2] == f"steps {STEPS} width {WIDTH} train {N_TRAIN} eval {N_EVAL}"
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f) == {"width": WIDTH}
    for net in ("parser", "matte"):
        assert len(run["res"][net]["losses"]) == STEPS
        assert np.isfinite(run["res"][net]["losses"]).all()
        assert run["res"][net]["ms_per_step"] > 0


def test_first_losses_match_the_jax_loop(run):
    """The first loss of each net within 1e-5 relative of the JAX loop's in
    float32; each of the first three within 1e-4 relative of the JAX loop's in
    float64, or within twice the JAX loop's own float32 error where that is
    larger: Adam's first step moves each element by -lr * sign(gradient),
    so the elements whose train-mode gradient is rounding-sized move either
    way in either package (BiSeNet's third loss here: 4e-4 from float64 in
    flax's own float32 run)."""
    for i, net in enumerate(("parser", "matte")):
        got = np.asarray(run["res"][net]["losses"], np.float64)
        j32, j64 = np.asarray(run["jax32"][i]), np.asarray(run["jax64"][i])
        np.testing.assert_allclose(got[0], j32[0], rtol=1e-5, err_msg=net)
        bound = np.maximum(1e-4 * np.abs(j64), 2 * np.abs(j32 - j64))
        assert np.all(np.abs(got - j64) <= bound), (net, got, j32, j64)


def test_jax_runners_load_the_ports_npz(run):
    """The JAX runners on the port's .npz against the port's runners, on the
    eval frames: class maps on >= 99.5% of the pixels, the matte within
    1e-4, hair masks within 1 LSB where the classes agree."""
    ev = run["frames"][N_TRAIN:]
    out = run["out"]
    jparse = JaxParsingRunner(os.path.join(out, "bisenet.npz"), width=WIDTH)
    jmatte = JaxMattingRunner(os.path.join(out, "modnet.npz"), width=WIDTH)
    tparse = ParsingRunner(os.path.join(out, "bisenet.npz"), width=WIDTH, device="cpu")
    tmatte = MattingRunner(os.path.join(out, "modnet.npz"), width=WIDTH, device="cpu")
    t_ev = torch.from_numpy(ev)
    jcls, tcls = np.asarray(jparse.parse(ev)), tparse.parse(t_ev).numpy()
    assert (jcls == tcls).mean() >= 0.995
    np.testing.assert_allclose(tmatte.matte(t_ev).numpy(), np.asarray(jmatte.matte(ev)),
                               rtol=0, atol=1e-4)
    agree = jcls == tcls
    jh, th = np.asarray(jparse.hair_mask(ev)), tparse.hair_mask(t_ev).numpy()
    assert np.abs(jh.astype(int) - th.astype(int))[agree].max(initial=0) <= 1


def test_the_cli_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """The tool's flags and defaults, --device cuda in place of --cpu; asked
    for the card without one, the CLI raises before it draws a frame."""
    args = vars(cli.parse_args([]))
    assert args == dict(steps=4000, batch=4, width=1.0, n_train=640, n_eval=48, lr=1e-3,
                        out="trained/hair_parser", modnet_steps=3000, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(seg_frames, "render_frames", lambda *a: pytest.fail("drew frames"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
