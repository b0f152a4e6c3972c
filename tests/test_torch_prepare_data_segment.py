"""The port's hair segmentation (segment/*) against the JAX package's, on the CPU.

- MODNet and BiSeNet load the goldens' torch state dicts as they are and give
  the goldens' outputs (MODNet within 1e-4: its instance norm takes the
  variance as flax does, E[x^2] - E[x]^2; BiSeNet within 1e-5); a flax tree
  made from the same state dict by the JAX package's converter loads into them
  through segment/convert.py with the same outputs.
- The shipped trained/hair_parser weights through the port's and the JAX
  runners on one capture frame: class maps equal on >= 99.5% of pixels, the
  matte within 1e-4, hair masks within 1 LSB where the classes agree.
- calculate_masks, the neural path with tiny random checkpoints and the
  classical fallback: the same files (masks within 1 LSB on < 0.5% of pixels:
  the matte and hair mask are truncated to uint8, so a float difference at a
  boundary moves them by one)."""

import math
import os
import shutil

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import cv2
import numpy as np
import pytest
import torch

from monohair_tpu.config import Config as JaxConfig
from monohair_tpu_torch.config import Config
from monohair_tpu_torch.io.image_io import read_png, write_png
from monohair_tpu_torch.segment.bisenet import BiSeNet
from monohair_tpu_torch.segment.convert import load_flax_npz
from monohair_tpu_torch.segment.modnet import MODNet
from monohair_tpu_torch.synthetic import (CAPTURE_FOV_Y, capture_orbit_pose,
                                          capture_render_view)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SHIPPED = {k: os.path.join(REPO, "trained/hair_parser", k + ".npz") for k in ("modnet", "bisenet")}
NETS = {"modnet": (lambda: MODNet(width=0.25), ("semantic", "detail", "matte"), 1e-4),
        "bisenet": (lambda: BiSeNet(19, width=0.125), ("out", "out16", "out32"), 1e-5)}


def golden(name):
    d = np.load(os.path.join(HERE, "golden", name + ".npz"))
    sd = {k[3:]: d[k] for k in d.files if k.startswith("sd.")}
    return sd, d


@pytest.mark.parametrize("name", ["modnet", "bisenet"])
def test_nets_load_the_goldens_state_dicts(name):
    make, outs, atol = NETS[name]
    sd, d = golden(name)
    net = make()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(d["in.img"]))
    for k, v in zip(outs, got):
        np.testing.assert_allclose(v.numpy(), d["out." + k], rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["modnet", "bisenet"])
def test_flax_trees_load_through_convert(name, tmp_path):
    from monohair_tpu.segment.convert import convert_state_dict
    from monohair_tpu.segment.runners import save_flax_tree
    make, outs, atol = NETS[name]
    sd, d = golden(name)
    params, stats = convert_state_dict(sd)
    path = str(tmp_path / "tree.npz")
    save_flax_tree(path, {"params": params, "batch_stats": stats})
    net = load_flax_npz(make(), path)
    with torch.no_grad():
        got = net(torch.from_numpy(d["in.img"]))
    for k, v in zip(outs, got):
        np.testing.assert_allclose(v.numpy(), d["out." + k], rtol=0, atol=atol)


def capture_frame(H=96, W=128, j=5):
    f_pix = (H / 2) / math.tan(math.radians(CAPTURE_FOV_Y) / 2)
    c2w = capture_orbit_pose(2 * math.pi * j / 32, elev=0.6)
    img, hair, hit = capture_render_view(c2w, f_pix, H, W)
    return (img * 255).astype(np.uint8), hair


def test_shipped_weights_through_both_runners():
    from monohair_tpu.segment import runners as jax_runners
    from monohair_tpu_torch.segment import runners
    img, _ = capture_frame()
    x = img[None]
    jm = jax_runners.MattingRunner(SHIPPED["modnet"]).matte(x)
    jp = jax_runners.ParsingRunner(SHIPPED["bisenet"])
    jcls = jp.parse(x)
    jhair = jp.hair_mask(x, jm)
    tm = runners.MattingRunner(SHIPPED["modnet"], device="cpu").matte(torch.from_numpy(x))
    tp = runners.ParsingRunner(SHIPPED["bisenet"], device="cpu")
    tcls = tp.parse(torch.from_numpy(x)).numpy()
    thair = tp.hair_mask(torch.from_numpy(x), tm).numpy()
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0, atol=1e-4)
    same = tcls == jcls
    assert same.mean() >= 0.995, same.mean()
    assert (jcls == 17).mean() > 0.05                       # the frame shows hair
    assert np.abs(thair.astype(int) - jhair)[same].max() <= 1


def synthetic_frames(img_dir, n=2, size=64):
    """Frames of tests/test_segment_pipeline.py: a dark textured cap over a
    face ellipse on a light background."""
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = np.full((size, size, 3), 230, np.uint8)
        cv2.ellipse(img, (size // 2, size // 2 + 6), (14, 18), 0, 0, 360, (180, 150, 140), -1)
        hair = (rng.random((size, size)) * 60).astype(np.uint8)
        mask = np.zeros((size, size), np.uint8)
        cv2.ellipse(mask, (size // 2, size // 2 - 6), (18, 16), 0, 180, 360, 255, -1)
        cv2.ellipse(mask, (size // 2, size // 2 - 10), (18, 10), 0, 0, 360, 255, -1)
        for c in range(3):
            img[..., c] = np.where(mask > 0, hair, img[..., c])
        write_png(os.path.join(img_dir, f"{i:04d}.png"), img[..., ::-1].copy())


@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory):
    """Random-init flax checkpoints of MODNet (width 0.25) and BiSeNet (0.125)."""
    from monohair_tpu.segment.bisenet import BiSeNet as JaxBiSeNet
    from monohair_tpu.segment.modnet import MODNet as JaxMODNet
    from monohair_tpu.segment.runners import save_flax_tree
    d = tmp_path_factory.mktemp("ckpts")
    x = np.zeros((1, 64, 64, 3), np.float32)
    paths = {}
    for name, net in (("modnet", JaxMODNet(width=0.25)), ("bisenet", JaxBiSeNet(19, width=0.125))):
        variables = net.init(jax.random.PRNGKey(0), x)
        paths[name] = str(d / f"{name}.npz")
        save_flax_tree(paths[name], {"params": variables["params"],
                                     "batch_stats": variables.get("batch_stats", {})})
    return paths


def run_both(tmp_path, segment):
    """calculate_masks of both packages on copies of the same frames; returns
    the two case roots."""
    from monohair_tpu.segment.pipeline import calculate_masks as jax_masks
    from monohair_tpu_torch.segment.pipeline import calculate_masks
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    synthetic_frames(os.path.join(port, "capture_images"))
    img, _ = capture_frame(64, 64)
    write_png(os.path.join(port, "capture_images", "0002.png"), img)
    shutil.copytree(port, ref)
    calculate_masks(Config({"data": {"root": port}, "segment": segment}), device="cpu")
    jax_masks(JaxConfig({"data": {"root": ref}, "segment": segment}))
    return port, ref


def assert_same_files(port, ref, lsb_share=0.005):
    for sub in ("hair_mask", "mask", "mask_hair"):
        files = sorted(os.listdir(os.path.join(ref, sub)))
        assert files == sorted(os.listdir(os.path.join(port, sub))) and len(files) == 3
        for f in files:
            a = read_png(os.path.join(port, sub, f)).astype(int)
            b = cv2.imread(os.path.join(ref, sub, f), cv2.IMREAD_UNCHANGED).astype(int)
            b = b[..., ::-1] if b.ndim == 3 else b
            d = np.abs(a - b)
            assert d.max() <= 1 and (d > 0).mean() <= lsb_share, (sub, f, d.max(), (d > 0).mean())


def test_calculate_masks_neural_matches_jax(tmp_path, tiny_ckpts, monkeypatch):
    from monohair_tpu_torch.segment import pipeline
    monkeypatch.setattr(pipeline, "CHUNK", 2)          # 3 frames: two chunks
    segment = {"modnet_flax": tiny_ckpts["modnet"], "modnet_width": 0.25,
               "parser_flax": tiny_ckpts["bisenet"], "parser_width": 0.125,
               "matte_size": 64, "parse_size": 64}
    port, ref = run_both(tmp_path, segment)
    assert_same_files(port, ref)
    # idempotent: a complete hair_mask/ is left as it is
    os.remove(os.path.join(port, "mask", "0000.png"))
    from monohair_tpu_torch.segment.pipeline import calculate_masks
    calculate_masks(Config({"data": {"root": port}, "segment": segment}), device="cpu")
    assert not os.path.exists(os.path.join(port, "mask", "0000.png"))


def test_calculate_masks_fallback_matches_jax(tmp_path):
    port, ref = run_both(tmp_path, {})
    assert_same_files(port, ref, lsb_share=0.0)
    hair = read_png(os.path.join(port, "hair_mask", "0000.png"))
    assert (hair > 0).mean() > 0.05
