"""The port's fit_bust step (monohair_tpu_torch/bustfit/{pipeline,scalp}.py,
pipeline/prepare_data_stage.py::promote_fit_artifacts) against the JAX
package's, on the CPU.

- run_bust_fit from annotation files and an SMPL-X npz in the official key
  layout (tests/test_bustfit.py::test_run_bust_fit_from_annotations in both
  packages): model_tsfm.dat within 1e-3, the semantic within 1e-3 (degrees
  within 0.05), final_template.obj within 1e-4 and the logged losses within
  1e-3 relative after 30 Adam steps (an element whose gradient is rounding
  noise takes Adam's +-lr step in either package).
- gather_targets: landmarks and iris bitwise, masks and images within 1e-6
  (INTER_AREA on floats).
- the identity fallbacks (no asset; no landmark files): the same bytes.
- promote_fit_artifacts and the scalp/FLAME/bust_long cuts: the same OBJ text.
"""

import json
import os
import shutil

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import numpy as np
import pytest
import torch

from monohair_tpu.config import Config as JaxConfig
from monohair_tpu_torch.config import Config
from monohair_tpu_torch.io.image_io import write_png
from tests.test_torch_bustfit_model import camera_pair

torch.set_num_threads(1)
H = W = 64


def write_case(tmp_path, rng, landmarks=True):
    """tests/test_bustfit.py's annotated two-view case, written by the port."""
    from monohair_tpu.bustfit.optimize import project_to_pixels
    from monohair_tpu.bustfit.smplx import sphere_head_model
    from monohair_tpu.bustfit.soft_raster import soft_silhouette_mesh
    root = tmp_path / "case"
    for sub in ("capture_images", "optimize/landmark2d", "optimize/iris", "optimize/matting",
                "optimize/face_parsing"):
        (root / sub).mkdir(parents=True)
    jc, _ = camera_pair(rng, 2)
    model = sphere_head_model(subdiv=6)
    V = model.v_template.shape[0]
    smplx_path = tmp_path / "SMPLX_TEST.npz"
    np.savez(smplx_path, v_template=np.asarray(model.v_template),
             shapedirs=(rng.normal(size=(V, 3, 400)) * 0.001).astype(np.float32),
             posedirs=np.zeros((V, 3, 0), np.float32), J_regressor=np.asarray(model.J_regressor),
             kintree_table=np.array([[-1], [0]]), weights=np.asarray(model.lbs_weights),
             f=model.faces)
    lmk_ids = np.linspace(0, V - 1, 68).astype(np.int64)
    np.save(tmp_path / "lmk_ids.npy", lmk_ids)
    shifted = np.asarray(model.v_template) * 1.04 + np.array([0.01, -0.005, 0.0], np.float32)
    gt = np.asarray(project_to_pixels(jc, (H, W), shifted[lmk_ids]))
    sil = np.asarray(soft_silhouette_mesh(jc, shifted, model.faces, (H, W), scale=1, window=24))
    cam_list = []
    for v in range(2):
        name = f"{v:03d}"
        img = (rng.random((H, W, 3)) * 80 + 40).astype(np.uint8)
        write_png(str(root / "capture_images" / f"{name}.png"), img)
        if landmarks:
            np.savetxt(str(root / "optimize" / "landmark2d" / f"{name}.txt"), gt[v][:, [1, 0]])
        np.savetxt(str(root / "optimize" / "iris" / f"{name}.txt"),
                   np.concatenate([gt[v][:2][:, [1, 0]], np.ones((2, 1))], -1))
        matte = (sil[v] > 0.5).astype(np.uint8) * 255
        write_png(str(root / "optimize" / "matting" / f"{name}.png"), np.dstack([img, matte]))
        cls = np.where(matte > 0, 1, 0).astype(np.uint8)
        top = int(np.nonzero(matte.any(1))[0][0])                  # hair on the crown
        cls[top:top + 6] = np.where(matte[top:top + 6] > 0, 17, 0)
        write_png(str(root / "optimize" / "face_parsing" / f"{name}.png"), cls)
        cam_list.append({"file": name, "ndc_prj": np.asarray(jc.ndc[v]).tolist(),
                         "pose": np.linalg.inv(np.asarray(jc.w2c[v], np.float64)).tolist()})
    with open(root / "cam_params.json", "w") as f:
        json.dump({"cam_list": cam_list}, f)
    return {"data": {"root": str(root), "image_size": [H, W]},
            "image_camera_path": "cam_params.json",
            "bustfit": {"smplx_model": str(smplx_path),
                        "landmark_vertex_ids": str(tmp_path / "lmk_ids.npy"),
                        "n_shape": 2, "n_exp": 2, "sil_scale": 4},
            "optimize": {"iter": 30}}


def two_copies(tmp_path, rng, **kw):
    cfg = write_case(tmp_path, rng, **kw)
    ref = tmp_path / "ref"
    shutil.copytree(cfg["data"]["root"], ref)
    jcfg = json.loads(json.dumps(cfg))
    jcfg["data"]["root"] = str(ref)
    return Config(cfg), JaxConfig(jcfg), cfg["data"]["root"], str(ref)


def test_run_bust_fit_from_annotations_matches_jax(tmp_path, rng):
    from monohair_tpu.bustfit.pipeline import run_bust_fit as jax_fit
    from monohair_tpu_torch.bustfit.pipeline import run_bust_fit
    from monohair_tpu_torch.bustfit.transforms import load_model_tsfm
    from monohair_tpu_torch.io.mesh_io import load_obj
    cfg, jcfg, port, ref = two_copies(tmp_path, rng)
    out = run_bust_fit(cfg, device="cpu")
    jax_fit(jcfg)
    assert out["frames"] == 2 and out["iters"] == 30
    assert out["annotations"] == {k: "cached" for k in ("matting", "landmark2d", "iris",
                                                        "face_parsing")}
    a = load_model_tsfm(os.path.join(port, "optimize", "model_tsfm.dat"))
    b = load_model_tsfm(os.path.join(ref, "optimize", "model_tsfm.dat"))
    assert np.isfinite(a).all() and np.abs(a - np.eye(4)).max() > 1e-3
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    sa, sb = (np.fromfile(os.path.join(d, "optimize", "model_tsfm_semantic.dat"), np.float32)
              for d in (port, ref))
    np.testing.assert_allclose(sa[[0, 1, 2, 6]], sb[[0, 1, 2, 6]], rtol=0, atol=1e-3)
    np.testing.assert_allclose(sa[3:6], sb[3:6], rtol=0, atol=0.05)
    va, fa = load_obj(os.path.join(port, "optimize", "final_template.obj"))
    vb, fb = load_obj(os.path.join(ref, "optimize", "final_template.obj"))
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_allclose(va, vb, rtol=0, atol=1e-4)
    la, lb = (np.loadtxt(os.path.join(d, "optimize", "fit_losses.txt")) for d in (port, ref))
    np.testing.assert_allclose(la, lb, rtol=1e-3)
    assert la[-1] < la[0]


def test_gather_targets_matches_jax(tmp_path, rng):
    from monohair_tpu.bustfit.pipeline import gather_targets as jax_gather
    from monohair_tpu_torch.bustfit.pipeline import gather_targets
    cfg, _, port, _ = two_copies(tmp_path, rng)
    os.remove(os.path.join(port, "optimize", "iris", "001.txt"))     # one view without iris
    for sil_scale in (4, 3):
        a, ka = gather_targets(port, ["000", "001", "002"], (H, W), sil_scale)
        b, kb = jax_gather(port, ["000", "001", "002"], (H, W), sil_scale)
        assert ka == kb == [0, 1] and a.iris_px is None and b.iris_px is None
        np.testing.assert_array_equal(a.lmk_px, b.lmk_px)
        for name in ("mask", "hair_mask", "face_mask", "image"):
            x, y = getattr(a, name), np.asarray(getattr(b, name))
            assert x.shape == y.shape and x.dtype == np.float32
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=name)
        assert a.hair_mask.max() > 0 and a.face_mask.max() > 0


@pytest.mark.parametrize("missing", ["asset", "landmarks"])
def test_identity_fallbacks_match_jax(tmp_path, rng, missing):
    from monohair_tpu.bustfit.pipeline import run_bust_fit as jax_fit
    from monohair_tpu_torch.bustfit.pipeline import run_bust_fit
    cfg, jcfg, port, ref = two_copies(tmp_path, rng, landmarks=(missing != "landmarks"))
    if missing == "asset":
        cfg.bustfit["smplx_model"] = jcfg.bustfit["smplx_model"] = str(tmp_path / "none.npz")
    run_bust_fit(cfg, device="cpu")
    jax_fit(jcfg)
    for name in ("model_tsfm.dat", "model_tsfm_semantic.dat"):
        with open(os.path.join(port, "optimize", name), "rb") as a:
            with open(os.path.join(ref, "optimize", name), "rb") as b:
                assert a.read() == b.read(), name
    assert not os.path.exists(os.path.join(port, "optimize", "final_template.obj"))
    np.testing.assert_array_equal(np.fromfile(os.path.join(port, "optimize", "model_tsfm.dat"),
                                              np.float32).reshape(4, 4), np.eye(4))


def test_export_writes_identity_for_a_non_finite_fit(tmp_path):
    from monohair_tpu_torch.bustfit import optimize, pipeline, smplx
    model = smplx.sphere_head_model(subdiv=4, device="cpu")
    params = optimize.init_params(model)._replace(global_rot=torch.tensor([np.nan, 0.0, 0.0]))
    pipeline.export_fit(str(tmp_path), model, params, [1.0])
    np.testing.assert_array_equal(
        np.fromfile(str(tmp_path / "model_tsfm.dat"), np.float32).reshape(4, 4), np.eye(4))
    assert not (tmp_path / "final_template.obj").exists()


def test_promote_fit_artifacts_matches_jax(tmp_path):
    """The same optimize/ files and assets through both packages'
    promote_fit_artifacts: the same root copies and Bust/ meshes."""
    from monohair_tpu.pipeline.prepare_data_stage import promote_fit_artifacts as jax_promote
    from monohair_tpu_torch.pipeline.prepare_data_stage import promote_fit_artifacts
    from monohair_tpu_torch.synthetic import SMPLX_SMALL, synthetic_smplx, uv_sphere_uvs
    from monohair_tpu_torch.io.mesh_io import save_obj
    rng = np.random.default_rng(0)
    model = synthetic_smplx(rng, SMPLX_SMALL)
    port, ref = tmp_path / "port", tmp_path / "ref"
    assets = tmp_path / "assets"
    assets.mkdir()
    Vh = model["head_count"]
    uv = uv_sphere_uvs(SMPLX_SMALL["head_rings"], SMPLX_SMALL["head_sectors"])
    with open(assets / "head.obj", "w") as f:
        f.write("".join(f"v {p[0]} {p[1]} {p[2]}\n" for p in model["true_verts"][:Vh]))
        f.write("".join(f"vt {t[0]} {t[1]}\n" for t in uv))
        f.write("".join("f {0}/{0} {1}/{1} {2}/{2}\n".format(*(k + 1))
                        for k in model["head_faces"]))
    np.save(assets / "ids.npy", np.arange(Vh))
    mask = np.zeros((256, 256, 3), np.uint8)
    mask[:100, :, 0] = 255
    write_png(str(assets / "scalp.png"), mask)
    fitted = model["true_verts"] + rng.normal(size=model["true_verts"].shape) * 1e-3
    for d in (port, ref):
        (d / "optimize").mkdir(parents=True)
        save_obj(str(d / "optimize" / "final_template.obj"), fitted, model["npz"]["f"])
        np.eye(4, dtype=np.float32).tofile(str(d / "optimize" / "model_tsfm.dat"))
        np.arange(7, dtype=np.float32).tofile(str(d / "optimize" / "model_tsfm_semantic.dat"))
    bf = {"flame_template": str(assets / "head.obj"), "flame_vertex_ids": str(assets / "ids.npy"),
          "scalp_mask": str(assets / "scalp.png"), "bust_cut_y": -0.05}
    promote_fit_artifacts(Config({"data": {"root": str(port)}, "bustfit": bf}))
    jax_promote(JaxConfig({"data": {"root": str(ref)}, "bustfit": bf}))
    names = ["model_tsfm.dat", "model_tsfm_semantic.dat", "Bust/bust_long.obj",
             "Bust/flame_bust.obj", "Bust/scalp.obj"]
    for name in names:
        with open(port / name, "rb") as a:
            with open(ref / name, "rb") as b:
                assert a.read() == b.read(), name
    scalp = open(port / "Bust" / "scalp.obj").read()
    assert 0 < scalp.count("\nf ") < open(port / "Bust" / "flame_bust.obj").read().count("\nf ")
    # wig mode: no fitted template, only the root copies
    os.remove(port / "optimize" / "final_template.obj")
    shutil.rmtree(port / "Bust")
    promote_fit_artifacts(Config({"data": {"root": str(port)}, "bustfit": bf}))
    assert not (port / "Bust").exists() and (port / "model_tsfm.dat").exists()
