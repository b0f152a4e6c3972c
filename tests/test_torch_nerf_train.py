"""The port's NeRF training (monohair_tpu_torch/nerf/train.py) against the JAX
package's on the CPU: the optimiser against optax over five steps; a step's
loss and gradients with the sparsity (Fourier) and TV (dense grid) terms
against jax.value_and_grad of the JAX loop's loss; four whole train_nerf
steps from the same initial weights on the jax.random draws of the JAX loop;
load_nerf_dataset; a small overfit whose loss falls; the occupancy path; the
TPU-only config keys, accepted and without effect; and ngp.render_video,
which now writes <root>/ngp_video.mp4 through the port's mp4v encoder."""

import os

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monohair_tpu.nerf import ngp as jngp
from monohair_tpu.nerf import train as jtrain
from monohair_tpu_torch.nerf import ngp, train
from monohair_tpu_torch.nerf.convert import field_state_from_flax
from tests.test_torch_nerf_fields import FIELDS, flax_variables, port_field

torch.set_num_threads(1)

BG = [0.92, 0.92, 0.92]


def test_optimiser_matches_optax_over_five_steps(rng):
    shapes = [(7, 5), (5,), (3, 2, 9)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # step 2's gradients have a global norm above 10: clipped
    grads = [[rng.normal(scale=30.0 if k == 2 else 0.3, size=s).astype(np.float32)
              for s in shapes] for k in range(5)]
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adam(optax.exponential_decay(1e-2, 3, 0.1)))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = train.OptaxAdam(tp, 1e-2, 3)
    for k in range(5):
        updates, state = tx.update([jnp.asarray(g) for g in grads[k]], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g) for g in grads[k]])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert opt.count == 5
    assert opt.learning_rate(0) == pytest.approx(1e-2, rel=1e-7)
    assert opt.learning_rate(3) == pytest.approx(1e-3, rel=1e-6)


def tiny_dataset(rng, F=3, H=12, W=16):
    from tests.test_torch_nerf_render import orbit_c2w
    images = rng.integers(0, 256, (F, H, W, 3)).astype(np.float32) / 255.0
    c2w = np.stack([orbit_c2w(0.7 * k, radius=2.2) for k in range(F)]).astype(np.float32)
    return train.NerfDataset(images, c2w, fx=14.0, fy=13.0, cx=W / 2, cy=H / 2)


def jax_loss(jfield, variables, o, d, target, sub, S, tv_weight, bg):
    """The JAX loop's loss_fn (monohair_tpu/nerf/train.py), uniform path."""
    rgb = jngp.render_rays(jfield, variables, o, d, S, sub, background=bg)[0]
    loss = jnp.mean(optax.huber_loss(rgb, target, delta=0.1))
    if tv_weight > 0.0 and hasattr(jfield, "tv"):
        loss = loss + tv_weight * jfield.apply(variables, method=jfield.tv)
    sw = float(getattr(jfield, "sparsity_weight", 0.0))
    if sw > 0.0:
        pts01 = jax.random.uniform(jax.random.fold_in(sub, 17), (4096, 3))
        sigma = jfield.apply(variables, pts01, method=jfield.density)[0]
        loss = loss + sw * jnp.mean(1.0 - jnp.exp(-0.05 * sigma))
    return loss


@pytest.mark.parametrize("key,tv_weight", [("fourier_small", 0.0), ("dense_small", 1e-2)])
def test_step_loss_and_gradients_match_jax(key, tv_weight, rng):
    kind, make_jax, _ = FIELDS[key]
    jfield = make_jax()
    variables = flax_variables(jfield, seed=1)
    field = port_field(key, variables)
    ds = tiny_dataset(rng)
    B, S = 96, 24
    F, H, W = ds.images.shape[:3]
    frames = rng.integers(0, F, B)
    pixels = rng.integers(0, H * W, B)
    imgs_u8 = torch.as_tensor(np.rint(ds.images.reshape(F, H * W, 3) * 255).astype(np.uint8))
    o, d, target = train.ray_batch(imgs_u8, torch.from_numpy(ds.c2w), torch.from_numpy(frames),
                                   torch.from_numpy(pixels), W, ds.fx, ds.fy, ds.cx, ds.cy)
    sub = jax.random.PRNGKey(4)
    draws = train.StepDraws(
        torch.from_numpy(frames), torch.from_numpy(pixels),
        torch.tensor(np.asarray(jax.random.uniform(sub, (B, S)))),
        torch.tensor(np.asarray(jax.random.uniform(jax.random.fold_in(sub, 17),
                                                       (4096, 3)))))
    bg = jnp.asarray(BG, jnp.float32)
    jl, jg = jax.value_and_grad(jax_loss, argnums=1)(
        jfield, jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(o.numpy()),
        jnp.asarray(d.numpy()), jnp.asarray(target.numpy()), sub, S, tv_weight, bg)
    loss = train.nerf_loss(field, o, d, target, draws, S, ngp.as_background(BG, "cpu"),
                           tv_weight)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    params = dict(field.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = field_state_from_flax(kind, jax.tree_util.tree_map(np.asarray, jg))
    for name, w in want.items():
        scale = float(np.abs(w.numpy()).max())
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def jax_loop_draws(seed, steps, F, HW, B, S, sparse):
    """The draws of monohair_tpu.nerf.train.train_nerf's first block of
    `steps` steps (uniform path, scan_block >= steps)."""
    rng = jax.random.PRNGKey(seed)
    rng, r_blk, _ = jax.random.split(rng, 3)
    k_f, k_p, k_r = jax.random.split(r_blk, 3)
    fi = np.asarray(jax.random.randint(k_f, (steps, B), 0, F))
    pi = np.asarray(jax.random.randint(k_p, (steps, B), 0, HW))
    out = []
    for s, sub in enumerate(jax.random.split(k_r, steps)):
        out.append(train.StepDraws(
            torch.from_numpy(fi[s].astype(np.int64)), torch.from_numpy(pi[s].astype(np.int64)),
            torch.tensor(np.asarray(jax.random.uniform(sub, (B, S)))),
            torch.tensor(np.asarray(jax.random.uniform(jax.random.fold_in(sub, 17),
                                                           (4096, 3)))) if sparse else None))
    return out


@pytest.mark.parametrize("key,tv_weight", [("fourier_small", 0.0), ("dense_small", 1e-3)])
def test_train_nerf_steps_match_jax(key, tv_weight, rng):
    """Four steps from flax's PRNGKey(0) initialisation on the JAX loop's
    draws: the last loss within rtol 1e-4, and the parameters' change within
    0.1 lr on >= 98% of each parameter's elements. Adam normalises each
    element, so one whose gradient is rounding noise (a sum that cancels)
    moves by about +-lr in either package: those may disagree."""
    kind, make_jax, _ = FIELDS[key]
    jfield = make_jax()
    ds = tiny_dataset(rng)
    B, S, steps = 64, 16, 4
    lr = 1e-3 if kind == "fourier" else 1e-2
    _, jvars, jlosses, _ = jtrain.train_nerf(
        ds, steps=steps, rays_per_batch=B, lr=lr, seed=0, log_every=1, field=jfield,
        use_occupancy=False, num_samples=S, scan_block=4, tv_weight=tv_weight,
        background=BG)
    init = jax.tree_util.tree_map(np.asarray, jfield.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3))))
    field = port_field(key, init)
    before = {k: v.clone() for k, v in field.state_dict().items()}
    draws = jax_loop_draws(0, steps, len(ds.images), ds.images.shape[1] * ds.images.shape[2],
                           B, S, hasattr(field, "sparsity_weight"))
    _, losses, grid = train.train_nerf(ds, field, steps=steps, rays_per_batch=B, lr=lr,
                                       log_every=1, use_occupancy=False, num_samples=S,
                                       tv_weight=tv_weight, background=BG, draws=draws)
    assert grid is None and len(losses) == steps
    np.testing.assert_allclose(losses[-1], jlosses[-1], rtol=1e-4)
    want = field_state_from_flax(kind, jax.tree_util.tree_map(np.asarray, jvars))
    for name, w in want.items():
        moved = (w - before[name]).numpy()
        got = (field.state_dict()[name] - before[name]).numpy()
        assert np.abs(moved).max() > 0.5 * lr, name
        assert np.mean(np.abs(got - moved) > 0.1 * lr) <= 0.02, name


def test_load_nerf_dataset_matches_jax(tmp_path):
    from monohair_tpu_torch.synthetic import write_capture_case
    write_capture_case(str(tmp_path), "cap", num_frames=4, H=24, W=32)
    colmap = tmp_path / "cap" / "colmap"
    args = (str(colmap / "transforms.json"), str(colmap / "images"))
    got, want = train.load_nerf_dataset(*args), jtrain.load_nerf_dataset(*args)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.c2w, want.c2w)
    assert (got.fx, got.fy, got.cx, got.cy) == (want.fx, want.fy, want.cx, want.cy)
    assert got.images.shape == (4, 24, 32, 3) and got.images.dtype == np.float32
    two = train.load_nerf_dataset(*args, max_images=2)
    np.testing.assert_array_equal(two.images, jtrain.load_nerf_dataset(*args, max_images=2).images)
    # a JPEG frame reads as cv2 reads it (the port's baseline codec)
    import cv2
    frame = cv2.imread(str(colmap / "images" / "frame_0001.png"))
    os.remove(colmap / "images" / "frame_0001.png")
    cv2.imwrite(str(colmap / "images" / "frame_0001.jpg"), frame)
    got, want = train.load_nerf_dataset(*args), jtrain.load_nerf_dataset(*args)
    np.testing.assert_array_equal(got.images, want.images)
    png = frame[..., ::-1].astype(np.float32) / 255.0    # the frame before its JPEG round trip
    assert not np.array_equal(got.images[1], png) and np.abs(got.images[1] - png).mean() < 0.02


def overfit_dataset():
    from tests.test_ngp_stage import _orbit_pose, _render_view, HH
    import math
    f_pix = (HH / 2) / math.tan(math.radians(40.0) / 2)
    poses = [_orbit_pose(2 * math.pi * j / 6) for j in range(6)]
    images = np.stack([_render_view(p, f_pix) for p in poses]).astype(np.float32)
    return train.NerfDataset(images, np.stack(poses).astype(np.float32), f_pix, f_pix,
                             HH / 2, HH / 2)


def test_small_overfit_loss_falls():
    ds = overfit_dataset()
    g = torch.Generator().manual_seed(0)
    from monohair_tpu_torch.nerf.fourier import FourierField
    field = FourierField(num_features=32, hidden=32, depth=3, geo_feat=7, generator=g)
    _, losses, _ = train.train_nerf(ds, field, steps=300, rays_per_batch=128, lr=1e-3,
                                    log_every=50, use_occupancy=False, num_samples=32,
                                    background=BG)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses


def test_occupancy_path_trains_and_updates_its_grid():
    """The occupancy path: uniform warm-up, then steps through the grid,
    updated every other step from the drawn jitter."""
    ds = overfit_dataset()
    field = FIELDS["fourier_small"][2]()
    _, losses, grid = train.train_nerf(ds, field, steps=4, rays_per_batch=32, log_every=1,
                                       num_samples=8, use_occupancy=True, occ_warmup=1,
                                       occ_resolution=8, occ_update_every=2, num_fine=8)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert grid.shape == (8, 8, 8) and float(grid.min()) > 0


def test_tpu_only_knobs_are_accepted_without_effect(tmp_path):
    """ngp.scan_block, ngp.sync_every and ngp.use_remat may stay in a config:
    train_ngp gives the same field with them as without."""
    from monohair_tpu_torch.nerf import pipeline
    from monohair_tpu_torch.synthetic import write_capture_case
    cfg = write_capture_case(str(tmp_path), "cap", num_frames=2, H=12, W=16)["config"]
    cfg.data["root"] = str(tmp_path / "cap")
    cfg.ngp.update(train_steps=3, rays_per_batch=16)

    def run(knobs):
        cfg.ngp.update(knobs)
        field, losses, _ = pipeline.train_ngp(cfg, device="cpu")
        return losses, [p.detach() for p in field.parameters()]

    plain = run({})
    knobs = run(dict(scan_block=4, sync_every=4, use_remat=True))
    assert plain[0] == knobs[0]
    assert all(torch.equal(a, b) for a, b in zip(plain[1], knobs[1]))


def test_render_video_raises_a_named_error_before_training(tmp_path, monkeypatch):
    """ngp.render_video used to raise (the port had no video encoder); the
    stage now writes the fly-through <root>/ngp_video.mp4 after the fixed
    views, at the size and frame count asked for, and reports its seconds."""
    import functools

    import cv2

    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.io.video import video_info
    from monohair_tpu_torch.nerf import pipeline
    from tests.test_ngp_stage import _build_case
    from tests.test_torch_ngp_stage import small_make_field, stage_config
    root = str(tmp_path / "case")
    cfg = stage_config(root, _build_case(root))
    cfg["ngp"].update(train_steps=3, mesh_resolution=12, render_video=True)
    monkeypatch.setattr(pipeline, "make_field", small_make_field(pipeline.make_field))
    monkeypatch.setattr(pipeline, "render_camera_path_video", functools.partial(
        pipeline.render_camera_path_video, H=24, W=32, frames_per_seg=4))
    seconds = pipeline.run_ngp_stage(Config(cfg), device="cpu")
    assert "video" in seconds
    path = str(tmp_path / "case" / "ngp_video.mp4")
    assert video_info(path) == (4, 24.0, 32, 24)   # base_cam.json: 2 poses, 1 segment
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 4 and cap.get(cv2.CAP_PROP_FPS) == 24.0
