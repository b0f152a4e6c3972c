"""The port's FAN, landmark runner and annotation step
(monohair_tpu_torch/segment/{fan,runners,annotations,convert}.py) and its
RGBA / gray+alpha PNGs, against the JAX package and OpenCV, on the CPU.

Tolerances and why:
- FAN on tests/golden/fan.npz (torch's own outputs) and against the JAX FAN
  at num_modules=2, depth=2, width=0.125: 1e-4 absolute (f32 convolutions
  in other orders through two stacked hourglasses).
- decode_heatmaps, face_box_from_mask, refine_pupil, the polygon fill inside
  the canvas and the PNG pixels: bitwise (integer and numpy arithmetic).
- LandmarkRunner: the same crops bitwise (fixed-point linear resize), the
  landmarks equal where the two packages' heatmaps have the same argmax and
  within one heatmap pixel (4 frame pixels at these crops) everywhere.
- the four annotation backends on tiny random checkpoints: mattes within 1
  LSB, class maps equal on >= 99% of pixels, landmarks as above, iris within
  1e-4 pixel.
"""

import os

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import cv2
import numpy as np
import pytest
import torch

from monohair_tpu.segment import fan as jfan
from monohair_tpu_torch.io.image_io import read_png, write_png
from monohair_tpu_torch.segment import annotations, convert, fan, runners

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))


def golden_fan():
    d = np.load(os.path.join(HERE, "golden", "fan.npz"))
    return {k[3:]: d[k] for k in d.files if k.startswith("sd.")}, d


def small_fan():
    return fan.FAN(num_modules=2, depth=2, width=0.125)


def test_fan_loads_the_goldens_state_dict():
    sd, d = golden_fan()
    net = small_fan()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        heats = net.eval()(torch.from_numpy(d["in.img"]))
    for k, h in enumerate(heats):
        np.testing.assert_allclose(h.numpy(), d[f"out.heat{k}"], rtol=0, atol=1e-4)


def public_names(sd):
    """The golden state dict in face_alignment's naming (the ConvBlock's
    shortcut as a downsample Sequential)."""
    return {"module." + k.replace("down_bn.", "downsample.0.").replace("down_conv.",
                                                                        "downsample.2."): v
            for k, v in sd.items()}


def test_public_face_alignment_names_load_through_the_rename():
    sd, d = golden_fan()
    pub = public_names(sd)
    assert any("downsample.2." in k for k in pub)
    net = convert.load_renamed_state_dict(small_fan(), pub, convert.rename_public_fan)
    with torch.no_grad():
        heats = net(torch.from_numpy(d["in.img"]))
    np.testing.assert_allclose(heats[-1].numpy(), d["out.heat1"], rtol=0, atol=1e-4)
    from monohair_tpu.segment.convert import rename_public_fan as jax_rename
    for k in pub:
        assert convert.rename_public_fan(k) == jax_rename(k)


@pytest.fixture(scope="module")
def fan_tree(tmp_path_factory):
    """The golden FAN as a flax tree, written by the JAX package's converter."""
    from monohair_tpu.segment.convert import convert_state_dict
    from monohair_tpu.segment.runners import save_flax_tree
    sd, _ = golden_fan()
    params, stats = convert_state_dict(sd)
    path = str(tmp_path_factory.mktemp("fan") / "fan.npz")
    save_flax_tree(path, {"params": params, "batch_stats": stats})
    return path


def test_fan_matches_the_jax_fan(fan_tree, rng):
    from monohair_tpu.segment.runners import load_flax_tree
    tree = load_flax_tree(fan_tree)
    jnet = jfan.FAN(num_modules=2, depth=2, width=0.125)
    x = rng.random((2, 96, 96, 3)).astype(np.float32)
    jheats = jnet.apply({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                        jnp.asarray(x))
    net = convert.load_flax_npz(small_fan(), fan_tree)
    with torch.no_grad():
        heats = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for h, jh in zip(heats, jheats):
        np.testing.assert_allclose(h.permute(0, 2, 3, 1).numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-4)


def test_save_flax_npz_is_the_inverse_of_the_loader(tmp_path):
    torch.manual_seed(0)
    net = small_fan()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "fan.npz")
    convert.save_flax_npz(net, path)
    back = convert.load_flax_npz(small_fan(), path)
    for (k, a), (_, b) in zip(net.state_dict().items(), back.state_dict().items()):
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    # and the JAX package reads it as its own tree
    from monohair_tpu.segment.runners import load_flax_tree
    tree = load_flax_tree(path)
    jnet = jfan.FAN(num_modules=2, depth=2, width=0.125)
    x = np.random.default_rng(1).random((1, 64, 64, 3)).astype(np.float32)
    jh = jnet.apply({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                    jnp.asarray(x))[-1]
    with torch.no_grad():
        h = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))[-1]
    np.testing.assert_allclose(h.permute(0, 2, 3, 1).numpy(), np.asarray(jh), rtol=0, atol=1e-4)


def test_decode_heatmaps_is_bitwise(rng):
    heat = rng.normal(size=(3, 16, 20, 68)).astype(np.float32)
    heat[0, 0, 5, 0] = 50.0          # a maximum on the border (no shift along y)
    heat[1, 7, 0, 1] = 50.0          # on the left border (no shift along x)
    heat[2, 4, 4, 2] = 50.0          # a tie between its x neighbours (no x shift)
    heat[2, 4, 3, 2] = heat[2, 4, 5, 2] = 1.0
    heat[2, 9, 9, 3] = heat[2, 2, 2, 3] = 60.0   # two maxima: the first wins
    got = fan.decode_heatmaps(heat)
    want = jfan.decode_heatmaps(heat)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_face_box_from_mask_matches_jax(rng):
    from monohair_tpu.segment.runners import face_box_from_mask as jax_box
    for _ in range(5):
        m = np.zeros((40, 60), np.float32)
        y0, x0 = rng.integers(0, 30), rng.integers(0, 50)
        m[y0:y0 + rng.integers(1, 10), x0:x0 + rng.integers(1, 10)] = rng.random()
        np.testing.assert_array_equal(runners.face_box_from_mask(m), jax_box(m))
    np.testing.assert_array_equal(runners.face_box_from_mask(np.zeros((7, 9))),
                                  jax_box(np.zeros((7, 9))))


def test_landmark_runner_matches_jax(fan_tree, rng):
    from monohair_tpu.segment.runners import LandmarkRunner as JaxRunner
    imgs = rng.integers(0, 256, (3, 72, 90, 3)).astype(np.uint8)
    boxes = np.array([[10, 5, 60, 55], [-8, 20, 40, 68], [50, -5, 100, 45]], np.float32)
    port = runners.LandmarkRunner(fan_tree, width=0.125, num_modules=2, depth=2, crop_size=128,
                                  device="cpu")
    ref = JaxRunner(fan_tree, width=0.125, num_modules=2, depth=2, crop_size=128)
    got = port.landmarks(torch.from_numpy(imgs), boxes)
    want = ref.landmarks(imgs, boxes)
    heat = port.heatmaps(torch.from_numpy(imgs), boxes).permute(0, 2, 3, 1).numpy()
    same = (np.argmax(heat.reshape(3, -1, 68), 1)
            == np.argmax(np.asarray(ref._fwd(ref.variables, jnp.asarray(np.stack([
                cv2.resize(pad_crop(im, b), (128, 128), interpolation=cv2.INTER_LINEAR)
                for im, b in zip(imgs, boxes.astype(int))]).astype(np.float32) / 255.0)))
                .reshape(3, -1, 68), 1))
    assert same.mean() > 0.95
    np.testing.assert_array_equal(got[same], want[same])
    side = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    assert (np.abs(got - want) <= (side / 32 + 1e-3)[:, None, None]).all()


def pad_crop(im, box):
    """The JAX runner's zero-padded square crop, for the heatmap check."""
    x0, y0, x1, y1 = box
    side = max(x1 - x0, y1 - y0, 1)
    pad = np.zeros((side, side, 3), im.dtype)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x0 + side, im.shape[1]), min(y0 + side, im.shape[0])
    pad[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = im[sy0:sy1, sx0:sx1]
    return pad


def random_ring(rng, kind, H, W):
    K = int(rng.integers(3, 9))
    c = rng.uniform([0, 0], [W - 1, H - 1])
    ang = np.sort(rng.uniform(0, 2 * np.pi, K))
    if kind == "convex":
        r = rng.uniform(2, 15, 2)
        ring = c + np.stack([np.cos(ang) * r[0], np.sin(ang) * r[1]], -1)
    elif kind == "concave":
        rad = rng.uniform(1, 15, K)
        ring = c + np.stack([np.cos(ang) * rad, np.sin(ang) * rad], -1)
    else:
        ring = rng.uniform([0, 0], [W - 1, H - 1], (K, 2))
    return np.clip(ring, 0, [W - 1, H - 1])


@pytest.mark.parametrize("kind", ["convex", "concave", "crossing"])
def test_fill_poly_gives_opencvs_pixels(kind):
    rng = np.random.default_rng(["convex", "concave", "crossing"].index(kind))
    for _ in range(400):
        H, W = (int(v) for v in rng.integers(5, 40, 2))
        poly = np.round(random_ring(rng, kind, H, W)).astype(np.int32)
        want = cv2.fillPoly(np.zeros((H, W), np.uint8), [poly], 1)
        got = annotations.fill_poly(np.zeros((H, W), np.uint8), poly, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{poly.tolist()} {H}x{W}")


def test_refine_pupil_matches_jax(rng):
    from monohair_tpu.segment.annotations import refine_pupil as jax_pupil
    for k in range(40):
        gray = rng.random((50, 70)).astype(np.float32)
        if k % 2:
            gray = (gray * 255).astype(np.uint8)
        c = rng.uniform([12, 12], [58, 38])
        ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
        ring = c + np.stack([np.cos(ang) * rng.uniform(3, 9), np.sin(ang) * rng.uniform(2, 6)], -1)
        if k == 3:
            ring = np.tile(ring[:1], (6, 1))          # degenerate: the centroid
        np.testing.assert_array_equal(annotations.refine_pupil(gray, ring),
                                      jax_pupil(gray, ring))
    bright = np.ones((30, 30), np.float32)
    ring = np.array([[10, 10], [20, 10], [20, 20], [10, 20]], np.float64)
    np.testing.assert_array_equal(annotations.refine_pupil(bright, ring),
                                  jax_pupil(bright, ring))


def test_annotation_processor_runs_missing_steps_only(tmp_path):
    root = tmp_path / "case"
    (root / "capture_images").mkdir(parents=True)
    for name in ("001.png", "000.png"):
        write_png(str(root / "capture_images" / name), np.zeros((4, 4, 3), np.uint8))
    calls = []

    def backend(paths, out_dir):
        calls.append((list(paths), out_dir))
        with open(os.path.join(out_dir, "x.txt"), "w") as f:
            f.write("1")

    (root / "optimize" / "iris").mkdir(parents=True)     # exists but empty: not cached
    proc = annotations.AnnotationProcessor(str(root), backends={"matting": backend,
                                                                "iris": backend})
    status = proc.run()
    assert status == {"matting": "computed", "landmark2d": "skipped (no backend configured)",
                      "iris": "computed", "face_parsing": "skipped (no backend configured)"}
    assert [os.path.basename(p) for p in calls[0][0]] == ["000.png", "001.png"]
    assert proc.run() == {"matting": "cached", "landmark2d": "skipped (no backend configured)",
                          "iris": "cached", "face_parsing": "skipped (no backend configured)"}
    assert len(calls) == 2
    from monohair_tpu.segment.annotations import AnnotationProcessor as JaxProcessor
    assert JaxProcessor(str(root), backends={"matting": backend}).run() == proc.run()


@pytest.mark.parametrize("channels", [2, 4])
def test_alpha_pngs_round_trip_through_opencv(tmp_path, rng, channels):
    """write_png's gray+alpha and RGBA files read back by cv2 (BGRA; a gray+
    alpha file comes back as four channels), and cv2's RGBA files read back
    by read_png in file (RGBA) order."""
    img = rng.integers(0, 256, (13, 17, channels)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels == 4:
        np.testing.assert_array_equal(back, img[..., [2, 1, 0, 3]])
        cv2.imwrite(str(tmp_path / "b.png"), img[..., [2, 1, 0, 3]])
        np.testing.assert_array_equal(read_png(str(tmp_path / "b.png")), img)
    else:
        np.testing.assert_array_equal(back[..., :3], np.repeat(img[..., :1], 3, -1))
        np.testing.assert_array_equal(back[..., 3], img[..., 1])
    np.testing.assert_array_equal(read_png(path), img)
    from monohair_tpu_torch.io.image_io import imread_gray, imread_rgb
    np.testing.assert_array_equal(imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(imread_rgb(path),
                                  cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))


@pytest.fixture(scope="module")
def tiny_backends(tmp_path_factory, fan_tree):
    """Random-init MODNet (0.25) and BiSeNet (0.125) flax checkpoints and the
    golden FAN, as the segment config of both packages' default_backends."""
    from monohair_tpu.segment.bisenet import BiSeNet as JaxBiSeNet
    from monohair_tpu.segment.modnet import MODNet as JaxMODNet
    from monohair_tpu.segment.runners import save_flax_tree
    d = tmp_path_factory.mktemp("ckpts")
    x = np.zeros((1, 64, 64, 3), np.float32)
    seg = {"fan_flax": fan_tree, "fan_width": 0.125, "fan_modules": 2, "fan_depth": 2,
           "modnet_width": 0.25, "parser_width": 0.125, "parse_size": 64}
    for name, net, key in (("modnet", JaxMODNet(width=0.25), "modnet_flax"),
                           ("bisenet", JaxBiSeNet(19, width=0.125), "parser_flax")):
        variables = net.init(jax.random.PRNGKey(0), x)
        seg[key] = str(d / f"{name}.npz")
        save_flax_tree(seg[key], {"params": variables["params"],
                                  "batch_stats": variables.get("batch_stats", {})})
    return seg


def test_default_backends_write_the_jax_packages_files(tmp_path, tiny_backends):
    from monohair_tpu.config import Config as JaxConfig
    from monohair_tpu.segment.annotations import AnnotationProcessor as JaxProcessor
    from monohair_tpu.segment.annotations import default_backends as jax_backends
    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.synthetic import (CAPTURE_FOV_Y, capture_orbit_pose,
                                              capture_render_view)
    import math
    port, ref = tmp_path / "port", tmp_path / "ref"
    H, W = 48, 64
    f_pix = (H / 2) / math.tan(math.radians(CAPTURE_FOV_Y) / 2)
    for d in (port, ref):
        (d / "capture_images").mkdir(parents=True)
        for j in (0, 3):
            img, _, _ = capture_render_view(capture_orbit_pose(0.4 * j, 0.3), f_pix, H, W)
            write_png(str(d / "capture_images" / f"{j:03d}.png"), (img * 255).astype(np.uint8))
    status = annotations.AnnotationProcessor(str(port), backends=annotations.default_backends(
        Config({"segment": tiny_backends}), "cpu")).run()
    assert set(status.values()) == {"computed"}
    JaxProcessor(str(ref), backends=jax_backends(JaxConfig({"segment": tiny_backends}))).run()
    for name in ("000", "003"):
        a = read_png(str(port / "optimize" / "matting" / f"{name}.png")).astype(int)
        b = cv2.imread(str(ref / "optimize" / "matting" / f"{name}.png"),
                       cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]].astype(int)
        assert a.shape == (H, W, 4) and np.abs(a - b).max() <= 1
        a = np.loadtxt(str(port / "optimize" / "landmark2d" / f"{name}.txt"))
        b = np.loadtxt(str(ref / "optimize" / "landmark2d" / f"{name}.txt"))
        assert a.shape == b.shape == (68, 2)
        same = (a == b).all(1)
        assert same.mean() > 0.9
        ia = np.loadtxt(str(port / "optimize" / "iris" / f"{name}.txt"))
        ib = np.loadtxt(str(ref / "optimize" / "iris" / f"{name}.txt"))
        assert ia.shape == (2, 3) and (ia[:, 2] == 1).all()
        if same[36:48].all():
            np.testing.assert_allclose(ia, ib, rtol=0, atol=1e-4)
        a = read_png(str(port / "optimize" / "face_parsing" / f"{name}.png"))
        b = cv2.imread(str(ref / "optimize" / "face_parsing" / f"{name}.png"),
                       cv2.IMREAD_UNCHANGED)
        assert a.dtype == np.uint8 and a.shape == (H, W) and (a == b).mean() >= 0.99
