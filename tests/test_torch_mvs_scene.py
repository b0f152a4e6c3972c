"""The port's copy of the MVS nets' training scene (synthetic.mvs_train_*)
against the tools that made the training data and tuned the occ margin
(tools/make_mvs_cases.py, the JAX package's voxelizer, closing and occupancy
sampler), and the shipped nets on such a scene at the shipped margin, on the
CPU."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monohair_tpu.coords import voxel_to_world as j_voxel_to_world
from monohair_tpu.mvs.sampling import sample_occ_training_points
from monohair_tpu.ops.pool3d import close_volume
from monohair_tpu.ops.voxelize import voxelize_directions
from monohair_tpu_torch import synthetic as syn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "trained", "mvs")


def _make_mvs_cases():
    spec = importlib.util.spec_from_file_location(
        "make_mvs_cases", os.path.join(REPO, "tools", "make_mvs_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scene_is_the_training_generators():
    tool = _make_mvs_cases()
    ours = syn.mvs_train_wig(np.random.default_rng(1000))
    ref = tool.make_varied_wig(np.random.default_rng(1000))
    assert len(ours) == len(ref) == 2000
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(syn.mvs_train_head_mesh(), tool.head_mesh()):
        np.testing.assert_array_equal(a, b)
    _, cams = tool.ring_cameras(16, 2.6, 2.6)
    assert json.dumps(syn.mvs_train_camera_list(16)) == json.dumps(cams)


def test_labels_and_queries_are_the_training_ones():
    strands = syn.mvs_train_wig(np.random.default_rng(3), num_strands=300)
    pts = np.concatenate([s[:-1] for s in strands])
    tang = np.concatenate([s[1:] - s[:-1] for s in strands])
    occ, _ = voxelize_directions(jnp.asarray(pts), jnp.asarray(tang))
    ref = np.asarray(jnp.maximum(close_volume(occ, kernel=5), occ))
    ours = syn.mvs_train_occupancy(strands)
    np.testing.assert_array_equal(ours, ref)
    assert 0 < (ref > 0).sum() < ref.size
    q, labels = syn.mvs_train_queries(ours, np.random.default_rng(0))
    ref_v, ref_labels = sample_occ_training_points(ref, seed=0)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(q, np.asarray(j_voxel_to_world(jnp.asarray(ref_v))),
                               rtol=0, atol=1e-6)


def test_shipped_nets_find_the_hair_of_their_training_scene(tmp_path):
    """At the shipped margin the shipped nets split a training-family scene's
    queries into a real mix, as the margin's tuning measured (held-out
    precision 0.87, recall 0.895; trained/mvs/stats_occ.txt)."""
    from monohair_tpu_torch.camera import Cameras
    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.io.cameras_io import save_cam_params
    from monohair_tpu_torch.mvs.eval import deep_mvs_eval, load_mvs_inputs
    from monohair_tpu_torch.pipeline.infer_inner_stage import load_net, occ_margin
    from monohair_tpu_torch.render import render_data

    rng = np.random.default_rng(0)
    strands = syn.mvs_train_wig(rng)
    cam_list = syn.mvs_train_camera_list(16)
    ndc, w2c = syn.cameras_numpy(cam_list)
    names = [c["file"] for c in cam_list]
    save_cam_params(str(tmp_path / "cam_params.json"), names, ndc, np.linalg.inv(w2c))
    render_data(Cameras.from_json_list(cam_list, "cpu"), names, strands,
                *syn.mvs_train_head_mesh(), syn.MVS_TRAIN_RENDER_SIZE, str(tmp_path / "imgs"))
    q, labels = syn.mvs_train_queries(syn.mvs_train_occupancy(strands), rng)
    pick = rng.permutation(len(q))[:2048]
    cfg = Config({"mvs": {f"{k}_model_path": os.path.join(TRAINED, k + ".npz")
                          for k in ("occ", "ori")}})
    inputs, _ = load_mvs_inputs(str(tmp_path), str(tmp_path / "cam_params.json"), device="cpu")
    _, orients, occ = deep_mvs_eval(inputs, load_net(cfg, "occ", 16, "cpu"),
                                    load_net(cfg, "ori", 16, "cpu"), query_points=q[pick],
                                    batch=2048, occ_margin=occ_margin(cfg))
    pred, truth = occ > 0.5, labels[pick] > 0
    tp = float((pred & truth).sum())
    precision, recall = tp / pred.sum(), tp / truth.sum()
    assert 0.05 < pred.mean() < 0.95
    assert min(precision, recall) >= 0.6 and 2 * precision * recall / (precision + recall) >= 0.7
    assert np.isfinite(orients).all()
