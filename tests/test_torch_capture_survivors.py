"""The capture case at 1280x720 through PMVO's surface filters, the port against
the JAX package on the same files, and the capture scene's cameras against its
frames, on the CPU.

A 5-frame orbit at 1280x720 (frame_interval 1, so 5 views: the confidence
filter counts more than 4) goes through the port's prepare_data image half
(the classical masks: the case names no nets). On its files, the candidates
the two packages load are equal, and so is every filter of
pmvo/solver.py::filter_masks (seen, not low-confidence, on the hair mask, and
their loose forms) against the JAX package's observe_points under the lines
of its filter_points, whose two results it also gives. The true hair cap
lands on the hair label under PMVO's pixel lookup in every view, at 96x128
and at 1280x720 (synthetic.capture_hair_cap_shares); under the renderer's GL
flip it does not, which pins the 180-degree roll both packages share
between ops/rasterize.py::_pixel_from_ndc and camera.ndc_to_pixel.
"""

import json
import os

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.config import Config as JaxConfig
from monohair_tpu_torch import prepare_data
from monohair_tpu_torch.io.yaml_io import dump_yaml
from monohair_tpu_torch.synthetic import capture_hair_cap_shares, write_capture_case

torch.set_num_threads(1)
FRAMES = 5
SIZE = (720, 1280)
CHUNK = 8192


def stage_one(root: str, frames: int, H: int, W: int, steps=()) -> str:
    """Write a capture case under `root` and run the port's prepare_data on it
    (run_ngp and fit_bust off, and the steps named off); returns its case.yaml
    path without the suffix."""
    cfg = write_capture_case(root, "cap", num_frames=frames, H=H, W=W,
                             frame_interval=1)["config"]
    yaml = os.path.join(root, "case")
    with open(yaml + ".yaml", "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    prepare_data.main(["--yaml=" + yaml, "--device=cpu", "--prepare_data.run_ngp=",
                       "--prepare_data.fit_bust="] + [f"--prepare_data.{s}=" for s in steps])
    return yaml


@pytest.fixture(scope="module")
def case_1280(tmp_path_factory):
    return stage_one(str(tmp_path_factory.mktemp("capture_1280")), FRAMES, *SIZE)


def jax_filter_masks(maps, points, patch, conf_thresholds, visible_threshold):
    """The masks monohair_tpu/pmvo/solver.py::filter_points combines, from its
    observe_points, in its own lines: one dict for each confidence threshold."""
    from monohair_tpu.pmvo.solver import observe_points
    obs = observe_points(maps, points, patch)
    z255 = -obs["z"] / 2.0 * 255.0
    d, invalid = obs["depth"], obs["invalid"]
    cmax = jnp.where(invalid, 0.0, jnp.max(obs["conf_patch"], -1))
    unvis = jnp.where(invalid, 1.0, jnp.where(z255 - d > 0.1, 1.0, 0.0))
    unvis1 = jnp.where(invalid, 1.0, jnp.where(z255 - d > visible_threshold, 1.0, 0.0))
    m = jnp.where(obs["mask"] > 0.2, 1.0, obs["mask"])
    vis, vis1 = 1.0 - unvis, 1.0 - unvis1
    out = []
    for conf_threshold in conf_thresholds:
        low_c = (cmax < conf_threshold).astype(z255.dtype)
        masks = dict(
            seen=jnp.sum(vis, 0) > 1, seen_loose=jnp.sum(vis1, 0) > 1,
            low_conf=jnp.sum((1.0 - unvis) * low_c, 0) > 4,
            hair=(jnp.sum(vis, 0) - jnp.sum(vis * m, 0)) < jnp.sum(vis, 0) * 0.5,
            hair_loose=(jnp.sum(vis1, 0) - jnp.sum(vis1 * m, 0)) < jnp.sum(vis1, 0) * 0.5)
        out.append({k: np.asarray(v) for k, v in masks.items()})
    return out


def test_survivors_of_each_filter_match_jax(case_1280):
    """The candidates, then each filter's survivors, equal in both packages on
    the 1280x720 files, at the case's confidence threshold and at one above
    every confidence (then a point seen in all 5 views is low-confidence in
    more than 4: no point of the case is at its own threshold); the JAX
    package's filter_points gives the same two results as the masks it
    combines."""
    from monohair_tpu.pipeline.common import load_pmvo_maps as jax_load_maps
    from monohair_tpu.pmvo.points import load_colmap_points as jax_load_points
    from monohair_tpu.pmvo.solver import filter_points as jax_filter_points
    from monohair_tpu_torch.pipeline.common import load_pmvo_maps, resolve_config
    from monohair_tpu_torch.pmvo.points import load_colmap_points
    from monohair_tpu_torch.pmvo.solver import filter_masks
    args = resolve_config(["--yaml=" + case_1280])
    jargs = JaxConfig(json.loads(json.dumps(args.to_dict())))
    mesh = os.path.join(args.data.root, args.data.raw_points_path)
    points = load_colmap_points(mesh, num_per_grid=args.PMVO.num_sample_per_grid)
    np.testing.assert_array_equal(
        points, jax_load_points(mesh, num_per_grid=args.PMVO.num_sample_per_grid))
    maps, names = load_pmvo_maps(args, "cpu")
    jmaps, jnames = jax_load_maps(jargs)
    assert names == jnames and len(names) == FRAMES and maps.image_size == SIZE
    patch, visible = args.PMVO.patch_size, args.PMVO.visible_threshold
    thresholds = (args.PMVO.conf_threshold, 2.0)
    port, ref = [{} for _ in thresholds], [{} for _ in thresholds]
    surface, filt = [], []
    for beg in range(0, len(points), CHUNK):
        chunk = points[beg:beg + CHUNK]
        jmasks = jax_filter_masks(jmaps, jnp.asarray(chunk), patch, thresholds, visible)
        for t, conf in enumerate(thresholds):
            for out, masks in ((port[t], filter_masks(maps, torch.from_numpy(chunk), patch,
                                                      conf, visible)),
                               (ref[t], jmasks[t])):
                for k, v in masks.items():
                    out.setdefault(k, []).append(np.asarray(v))
        s, f = jax_filter_points(jmaps, jnp.asarray(chunk), patch, thresholds[0], visible)
        surface.append(np.asarray(s))
        filt.append(np.asarray(f))
    survivors = []
    for t, conf in enumerate(thresholds):
        a = {k: np.concatenate(v) for k, v in port[t].items()}
        b = {k: np.concatenate(v) for k, v in ref[t].items()}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} at {conf}")
        seen, confident, hair = a["seen"], ~a["low_conf"], a["hair"]
        survivors.append([len(points), int(seen.sum()), int((seen & confident).sum()),
                          int((seen & confident & hair).sum())])
        if t == 0:
            np.testing.assert_array_equal(np.concatenate(surface), seen & confident & hair)
            np.testing.assert_array_equal(np.concatenate(filt),
                                          a["seen_loose"] & ~seen & confident & a["hair_loose"])
    # every filter takes points and leaves some (the confidence filter at 2.0)
    case, above = survivors
    assert case[0] > case[1] >= case[2] > case[3] > 0, survivors
    assert above[0] > above[1] > above[2] >= above[3] > 0, survivors


@pytest.mark.parametrize("size", ["96x128", "1280x720"])
def test_true_hair_cap_lands_on_the_hair_label_in_every_view(size, case_1280, tmp_path):
    """The scene's cameras agree with its frames: >= 0.9 of the true hair cap
    on the hair label under PMVO's lookup in every view. The renderer's GL
    flip (ops/rasterize.py::_pixel_from_ndc) puts it at most 0.35 there: it
    is PMVO's turned 180 degrees about the view axis, in both packages
    (test_renderers_pixels_are_pmvos_turned_180_degrees)."""
    if size == "96x128":
        H, W = 96, 128
        yaml = stage_one(str(tmp_path), 16, H, W, steps=("process_bust", "render_depth",
                                                          "process_imgs"))
    else:
        (H, W), yaml = SIZE, case_1280
    shares = capture_hair_cap_shares(os.path.join(os.path.dirname(yaml), "cap"), (H, W))
    assert len(shares) == (16 if size == "96x128" else FRAMES)
    for name, pmvo, gl in shares:
        assert pmvo >= 0.9, (name, pmvo)
        assert gl <= 0.35, (name, gl)


def test_renderers_pixels_are_pmvos_turned_180_degrees(rng):
    """GL's pipeline through camera.projection_matrix (clip w = -z, NDC =
    clip / w, rows flipped on readback) puts a point where PMVO's
    camera.ndc_to_pixel does; ops/rasterize.py::_pixel_from_ndc, which takes
    camera.project's (u, v) for GL's NDC, puts it at (H - row, W - col). The
    same in both packages: the depth maps render_depth writes and PMVO reads,
    the bust fit's silhouettes and the MVS renders are turned so."""
    from monohair_tpu import camera as jax_camera
    from monohair_tpu.ops import rasterize as jax_rasterize
    from monohair_tpu_torch.camera import (Cameras, ndc_to_pixel, project,
                                           projection_matrix, world_to_cam)
    from monohair_tpu_torch.ops.rasterize import _pixel_from_ndc
    H, W = 72, 128
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.2, 1.5]
    cams = Cameras.from_numpy([[2.1, 3.7, 0.05, -0.02]], np.linalg.inv(c2w)[None], "cpu")
    pts = torch.from_numpy(rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32))
    cam = world_to_cam(cams.w2c, pts)[0]
    clip = torch.cat([cam, torch.ones_like(cam[:, :1])], 1) @ projection_matrix(cams.ndc)[0].T
    ndc = clip[:, :2] / clip[:, 3:]
    gl = torch.stack([(1.0 - ndc[:, 1]) * 0.5 * H, (ndc[:, 0] + 1.0) * 0.5 * W], -1)
    uv, _ = project(cams, pts)
    pmvo, rendered = ndc_to_pixel(uv[0], (H, W)), _pixel_from_ndc(uv[0], (H, W))
    torch.testing.assert_close(pmvo, gl, rtol=0, atol=1e-4)
    torch.testing.assert_close(rendered, torch.tensor([H, W]) - gl, rtol=0, atol=1e-4)
    juv = jnp.asarray(uv[0].numpy())
    np.testing.assert_allclose(np.asarray(jax_camera.ndc_to_pixel(juv, (H, W))), pmvo.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jax_rasterize._pixel_from_ndc(juv, (H, W))),
                               rendered.numpy(), rtol=0, atol=1e-5)
