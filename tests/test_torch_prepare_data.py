"""The port's stage 1 image half (python -m monohair_tpu_torch.prepare_data)
against the JAX package's stage, on the CPU.

Pieces: the NeRF <-> NGP conversions, the pose chain and cam_params.json (equal
to 1e-12, and to the capture writer's analytic MVS ring to 1e-6), the rig
calibration helpers, process_bust_meshes (same OBJ text), render_bust_hair_depth
(depth within 1e-4 of the 0..255 scale on >= 99% of pixels, the same coverage
on >= 99.5%). The whole stage on a 4-frame capture case at 96x128 with the
shipped hair-parser weights, file by file: the same frames, cameras, meshes,
depth maps; hair_mask/ and mask/ within 1 LSB (uint8 truncation of floats);
Gabor bins equal on >= 99% of the pixels with nonzero written confidence and
within one bin there (2 once encoded), conf within 1 LSB. The CLI with fit_bust on
against the JAX stage on a small case with the synthetic SMPL-X. Also the stage's
own rule: a JPEG frame of a kind the baseline codec does not take (progressive)
raises the codec's named error (tests/test_torch_jpeg.py runs a baseline JPEG
capture through the stage)."""

import json
import math
import os
import shutil

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import cv2
import numpy as np
import pytest
import torch

from monohair_tpu.config import Config as JaxConfig
from monohair_tpu_torch import calib, coords
from monohair_tpu_torch.io.image_io import read_png
from monohair_tpu_torch.io.yaml_io import dump_yaml
from monohair_tpu_torch.nerf import poses
from monohair_tpu_torch.synthetic import write_capture_case

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {k: os.path.join(REPO, "trained/hair_parser", k + ".npz") for k in ("modnet", "bisenet")}


def test_nerf_ngp_conversions_match_jax(rng):
    from monohair_tpu import coords as jax_coords
    from scipy.spatial.transform import Rotation
    for _ in range(4):
        xf = np.eye(4)
        xf[:3, :3] = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        xf[:3, 3] = rng.normal(size=3)
        np.testing.assert_array_equal(coords.nerf_to_ngp(xf), jax_coords.nerf_to_ngp(xf))
        m = coords.nerf_to_ngp(xf)
        np.testing.assert_array_equal(coords.ngp_to_nerf(m[:, :3], m[:, 3]),
                                      jax_coords.ngp_to_nerf(m[:, :3], m[:, 3]))
        np.testing.assert_allclose(coords.ngp_to_nerf(m[:, :3], m[:, 3]), xf, atol=1e-12)


def test_rig_calibration_matches_jax(rng):
    from monohair_tpu import calib as jax_calib
    K = np.tile(np.array([[1500.0, 0, 960], [0, 1500.0, 540], [0, 0, 1]]), (5, 1, 1))
    K[:, 0, 2] += rng.normal(size=5)
    for a, b in zip(calib.norm_cam_intrin(K, (1080, 1920)),
                    jax_calib.norm_cam_intrin(K, (1080, 1920))):
        np.testing.assert_array_equal(a, b)
    from monohair_tpu_torch.synthetic import capture_orbit_pose
    c2w = np.stack([capture_orbit_pose(a, elev=0.1 * k) for k, a in
                    enumerate(rng.uniform(0, 2 * math.pi, 6))])
    for a, b in zip(calib.spherify_cam_poses(c2w, 0), jax_calib.spherify_cam_poses(c2w, 0)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    """A 4-frame capture case at 96x128 with the shipped hair-parser weights."""
    tmp = tmp_path_factory.mktemp("capture")
    out = write_capture_case(str(tmp), "cap", num_frames=4, H=96, W=128,
                             modnet=SHIPPED["modnet"], parser=SHIPPED["bisenet"])
    return str(tmp / "cap"), out


def test_pose_chain_matches_jax_and_the_analytic_ring(small_case, tmp_path):
    from monohair_tpu.nerf import poses as jax_poses
    root, out = small_case
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    for d in (port, ref):
        shutil.copytree(os.path.join(root, "colmap"), d, ignore=shutil.ignore_patterns("images"))
    calib_path = os.path.join(root, "calib_cam_params.json")
    select = [f"frame_{j:04d}" for j in (1, 3)]
    for mod, d in ((poses, port), (jax_poses, ref)):
        mod.generate_base_cam_from_key_frame(d, calib_path, os.path.join(d, "base_cam.json"))
        mod.generate_mvs_pose_from_base_cam(d, select, calib_path, image_size=(96, 128))
    for name in ("base_cam.json", "cam_params.json", "video/001.json"):
        a = json.load(open(os.path.join(port, name)))
        b = json.load(open(os.path.join(ref, name)))
        assert a == b, name
    cams = json.load(open(os.path.join(port, "cam_params.json")))["cam_list"]
    assert [c["file"] for c in cams] == select
    for c in cams:
        np.testing.assert_allclose(c["pose"], out["mvs_poses"][c["file"]], rtol=0, atol=1e-6)
    hv = np.random.default_rng(0).normal(size=(50, 3))
    np.testing.assert_array_equal(poses.convert_mesh_nerf_to_mvs(hv, port, calib_path),
                                  jax_poses.convert_mesh_nerf_to_mvs(hv, ref, calib_path))


def test_process_bust_meshes_matches_jax(small_case, tmp_path):
    from monohair_tpu.bustfit import transforms as jax_transforms
    from monohair_tpu_torch.bustfit import transforms
    from monohair_tpu_torch.config import Config
    root, _ = small_case
    tsfm = np.eye(4)
    tsfm[:3, :3] *= 1.05
    tsfm[:3, 3] = [0.01, -0.02, 0.005]
    for wig in (True, False):
        port, ref = str(tmp_path / f"port{wig}"), str(tmp_path / f"ref{wig}")
        for d in (port, ref):
            shutil.copytree(os.path.join(root, "Bust"), os.path.join(d, "Bust"))
            os.makedirs(os.path.join(d, "ours"))
            if not wig:
                transforms.save_model_tsfm(os.path.join(d, "model_tsfm.dat"), tsfm)
                np.array([0.01, -0.02, 0.005, 10, 20, 30, 1.05], np.float32).tofile(
                    os.path.join(d, "model_tsfm_semantic.dat"))
        transforms.process_bust_meshes(Config({"data": {"root": port}}))
        jax_transforms.process_bust_meshes(JaxConfig({"data": {"root": ref}}))
        names = ["ours/bust_long_tsfm.obj", "ours/scalp_tsfm.obj",
                 "ours/Voxel_hair/model_tsfm.dat", "model_tsfm.dat"]
        for name in names + ([] if wig else ["ours/Voxel_hair/head.trans"]):
            with open(os.path.join(port, name), "rb") as a:
                with open(os.path.join(ref, name), "rb") as b:
                    assert a.read() == b.read(), name


def test_render_bust_hair_depth_matches_jax(small_case):
    from monohair_tpu.camera import Cameras as JaxCameras
    from monohair_tpu.render import render_bust_hair_depth as jax_depth
    from monohair_tpu_torch.camera import Cameras
    from monohair_tpu_torch.constants import BUST_TO_ORIGIN
    from monohair_tpu_torch.io.mesh_io import load_obj
    from monohair_tpu_torch.render import render_bust_hair_depth
    root, _ = small_case
    cam_list = json.load(open(os.path.join(root, "calib_cam_params.json")))["cam_list"][:2]
    names = [c["file"] for c in cam_list]
    hv, hf = load_obj(os.path.join(root, "ours/colmap_points.obj"))
    bv, bf = load_obj(os.path.join(root, "Bust/bust_long.obj"))
    hv, bv = hv + BUST_TO_ORIGIN, bv + BUST_TO_ORIGIN
    got = render_bust_hair_depth(Cameras.from_json_list(cam_list, "cpu"), names, hv, hf,
                                 image_size=(120, 72), bust_vertices=bv, bust_faces=bf)
    ref = jax_depth(JaxCameras.from_json_list(cam_list), names, hv, hf,
                    image_size=(120, 72), bust_vertices=bv, bust_faces=bf)
    for v in names:
        a, b = got[v] * 255, ref[v] * 255
        assert ((a < 255) == (b < 255)).mean() >= 0.995
        assert (np.abs(a - b) <= 1e-4).mean() >= 0.99 and (a < 255).mean() > 0.05


def stage_config(small_case):
    """A deep copy of the case's config."""
    from monohair_tpu_torch.config import Config
    return Config(json.loads(json.dumps(small_case[1]["config"].to_dict())))


def run_port_and_jax(small_case, tmp_path):
    from monohair_tpu.pipeline.prepare_data_stage import run_prepare_data as jax_stage
    from monohair_tpu_torch.pipeline.common import case_paths
    from monohair_tpu_torch.pipeline.prepare_data_stage import run_prepare_data
    root, out = small_case
    port, ref = tmp_path / "port", tmp_path / "ref"
    for d in (port, ref):
        shutil.copytree(root, d / "cap")
    cfg = stage_config(small_case)
    cfg.data["root"] = str(port)
    cfg["camera_path"] = str(port / "cap" / "calib_cam_params.json")
    jcfg = JaxConfig(json.loads(json.dumps(cfg.to_dict())))
    jcfg.data["root"] = str(ref / "cap")
    jcfg["camera_path"] = str(ref / "cap" / "calib_cam_params.json")
    run_prepare_data(case_paths(cfg), device="cpu")
    jax_stage(jcfg)
    return str(port / "cap"), str(ref / "cap")


def read_any(path):
    if path.endswith(".npy"):
        return np.load(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


def test_whole_stage_matches_jax(small_case, tmp_path):
    port, ref = run_port_and_jax(small_case, tmp_path)
    frames = sorted(os.listdir(os.path.join(ref, "capture_images")))
    assert frames == sorted(os.listdir(os.path.join(port, "capture_images"))) and len(frames) == 2
    for name in ("colmap/base_cam.json", "colmap/cam_params.json", "ours/cam_params.json"):
        assert json.load(open(os.path.join(port, name))) == json.load(open(os.path.join(ref, name)))
    for name in ("ours/bust_long_tsfm.obj", "ours/scalp_tsfm.obj"):
        assert open(os.path.join(port, name)).read() == open(os.path.join(ref, name)).read()
    for view in sorted(os.listdir(os.path.join(ref, "imgs"))):
        a = read_png(os.path.join(port, "imgs", view, "bust_hair_depth.png")).astype(int)
        b = read_any(os.path.join(ref, "imgs", view, "bust_hair_depth.png")).astype(int)
        assert (np.abs(a - b) <= 1).mean() >= 0.995, view
    for f in frames:
        stem = f[:-4]
        np.testing.assert_array_equal(read_png(os.path.join(port, "capture_images", f)),
                                      read_any(os.path.join(ref, "capture_images", f)))
        a, b = (np.load(os.path.join(d, "render_depth", stem + ".npy")) for d in (port, ref))
        assert a.shape == b.shape == (96, 128, 3) and a.dtype == b.dtype == np.float32
        assert ((a < 255) == (b < 255)).mean() >= 0.995
        assert (np.abs(a - b) <= 1e-4).mean() >= 0.99
        for sub in ("hair_mask", "mask", "mask_hair"):
            a = read_png(os.path.join(port, sub, f)).astype(int)
            b = read_any(os.path.join(ref, sub, f)).astype(int)
            d = np.abs(a - b)
            assert d.max() <= 1 and (d > 0).mean() <= 0.005, (sub, f)
        conf_ref = read_any(os.path.join(ref, "conf", f)).astype(int)
        assert np.abs(read_png(os.path.join(port, "conf", f)).astype(int) - conf_ref).max() <= 1
        d = np.abs(read_png(os.path.join(port, "best_ori", f)).astype(int)
                   - read_any(os.path.join(ref, "best_ori", f)).astype(int))
        d = np.minimum(d, 180 - d)
        seen = conf_ref > 0
        assert seen.mean() > 0.3
        # one bin apart is at most 2 apart once encoded: the f32 angle of bin k
        # truncates to k or k - 1
        assert (d[seen] == 0).mean() >= 0.99 and d[seen].max() <= 2, f
        assert read_png(os.path.join(port, "Ori", f)).shape == (96, 128, 3)
    hair = read_png(os.path.join(port, "hair_mask", frames[0])) > 127
    label = read_png(os.path.join(port, "labels/hair", frames[0])) > 127
    assert (hair & label).sum() / (hair | label).sum() > 0.5


def write_yaml(cfg, path):
    with open(path + ".yaml", "w") as f:
        f.write(dump_yaml(cfg.to_dict()))


def bust_fit_case(tmp_path, iters=30):
    """A 4-frame capture case at 48x64 with the bust fit's synthetic assets at
    the small SMPL-X sizes, in two copies (port, ref) whose configs name their
    own assets."""
    from monohair_tpu_torch.synthetic import SMPLX_SMALL, write_bust_fit_assets
    port, ref = tmp_path / "port", tmp_path / "ref"
    out = write_capture_case(str(port), "cap", num_frames=4, H=48, W=64)
    cfg = out["config"]
    truth = write_bust_fit_assets(str(port / "cap"), cfg, out["mvs_poses"], 48, 64,
                                  sizes=SMPLX_SMALL, iters=iters)
    cfg.prepare_data.update(fit_bust=True, run_ngp=None, process_imgs=False)
    shutil.copytree(port, ref)
    write_yaml(cfg, str(port / "case"))
    jcfg = JaxConfig(json.loads(json.dumps(cfg.to_dict()).replace(str(port), str(ref))))
    return str(port), str(ref), jcfg, truth


def test_cli_with_fit_bust_matches_jax(tmp_path):
    """The prepare_data CLI with fit_bust on (30 steps), beside select_images,
    process_camera, process_bust and render_depth, on the CPU, against the JAX
    stage on a copy: optimize/ and the root copies within the tolerances of
    tests/test_torch_bustfit_stage.py, Bust/ and ours/*_tsfm.obj with the same
    faces and vertices within 1e-4 (cut from final_template.obj), the depth
    maps as test_whole_stage_matches_jax holds them."""
    from monohair_tpu.pipeline.prepare_data_stage import run_prepare_data as jax_stage
    from monohair_tpu_torch import prepare_data
    from monohair_tpu_torch.bustfit.transforms import load_model_tsfm
    from monohair_tpu_torch.io.mesh_io import load_obj
    port, ref, jcfg, truth = bust_fit_case(tmp_path)
    steps = prepare_data.main(["--yaml=" + os.path.join(port, "case"), "--device=cpu"])
    assert list(steps) == ["select_images", "process_camera", "fit_bust", "process_bust",
                           "render_depth"]
    jcfg.data["root"] = os.path.join(jcfg.data.root, jcfg.data.case)
    jax_stage(jcfg)
    port, ref = os.path.join(port, "cap"), os.path.join(ref, "cap")
    a = load_model_tsfm(os.path.join(port, "optimize", "model_tsfm.dat"))
    b = load_model_tsfm(os.path.join(ref, "optimize", "model_tsfm.dat"))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    for name in ("model_tsfm.dat", "model_tsfm_semantic.dat"):
        with open(os.path.join(port, name), "rb") as f, \
                open(os.path.join(port, "optimize", name), "rb") as g:
            assert f.read() == g.read(), name
    sa, sb = (np.fromfile(os.path.join(d, "model_tsfm_semantic.dat"), np.float32)
              for d in (port, ref))
    np.testing.assert_allclose(sa[[0, 1, 2, 6]], sb[[0, 1, 2, 6]], rtol=0, atol=1e-3)
    np.testing.assert_allclose(sa[3:6], sb[3:6], rtol=0, atol=0.05)
    la, lb = (np.loadtxt(os.path.join(d, "optimize", "fit_losses.txt")) for d in (port, ref))
    np.testing.assert_allclose(la, lb, rtol=1e-3)
    # the loss falls at every logged step (most of it is the silhouette and
    # scale terms, which 30 steps at 48x64 hardly move; the scene's poses
    # agree with its frames, so the landmark term starts low)
    assert np.all(np.diff(la) < 0)
    for name in ("optimize/final_template.obj", "Bust/bust_long.obj", "Bust/flame_bust.obj",
                 "Bust/scalp.obj", "ours/bust_long_tsfm.obj", "ours/scalp_tsfm.obj",
                 "ours/flame_bust_tsfm.obj"):
        va, fa = load_obj(os.path.join(port, name))
        vb, fb = load_obj(os.path.join(ref, name))
        assert len(fa) > 0, name
        np.testing.assert_array_equal(fa, fb, err_msg=name)
        np.testing.assert_allclose(va, vb, rtol=0, atol=1e-4, err_msg=name)
    # the fit moved the landmark vertices toward the true head
    v, _ = load_obj(os.path.join(port, "optimize", "final_template.obj"))
    from monohair_tpu_torch.constants import BUST_TO_ORIGIN
    err = np.linalg.norm(v[truth["lmk_ids"]] + BUST_TO_ORIGIN - truth["landmark_truth"], axis=1)
    err0 = np.linalg.norm(truth["template"][truth["lmk_ids"]] - truth["landmark_truth"], axis=1)
    assert err.mean() < 0.2 * err0.mean()
    for f in sorted(os.listdir(os.path.join(port, "render_depth"))):
        if f.endswith(".npy"):
            x, y = (np.load(os.path.join(d, "render_depth", f)) for d in (port, ref))
            assert ((x < 255) == (y < 255)).mean() >= 0.995
            assert (np.abs(x - y) <= 1e-4).mean() >= 0.99


def test_jpeg_capture_raises_a_named_codec_error(small_case, tmp_path):
    from monohair_tpu_torch import prepare_data
    from monohair_tpu_torch.io.jpeg import UnsupportedJPEGError
    shutil.copytree(small_case[0], tmp_path / "cap")
    images = tmp_path / "cap" / "colmap" / "images"
    frame = cv2.imread(str(images / "frame_0002.png"))
    os.remove(images / "frame_0002.png")
    cv2.imwrite(str(images / "frame_0002.jpg"), frame, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cfg = stage_config(small_case)
    cfg.data["root"] = str(tmp_path)
    cfg.prepare_data["process_imgs"] = None
    write_yaml(cfg, str(tmp_path / "case"))
    with pytest.raises(UnsupportedJPEGError, match="progressive"):
        prepare_data.main(["--yaml=" + str(tmp_path / "case"), "--device=cpu"])
