"""The port's interior inference (monohair_tpu_torch.mvs.eval) and its files
against the JAX package's on the CPU: query sets, deep_mvs_eval's artefacts
(voxels.dat, raw.npy, Voxel_hair/*.mat), the input maps' loading, and the
voxel writers."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monohair_tpu.io import voxels_io as jvox
from monohair_tpu.io.mat_io import load_occ_mat, load_ori_mat
from monohair_tpu.io.mat_io import save_ori_mat_from_points as j_save_ori
from monohair_tpu.models.pifu import OccAttn as JOcc, OriAttn as JOri
from monohair_tpu.mvs import eval as jeval
from monohair_tpu_torch.io import voxels_io as tvox
from monohair_tpu_torch.io.mat_io import save_ori_mat_from_points
from monohair_tpu_torch.models.convert import load_weights, state_dict_from_flax
from monohair_tpu_torch.models.pifu import OccAttn, OriAttn
from monohair_tpu_torch.mvs import eval as teval

torch.set_num_threads(1)

TINY = dict(vit_depth=1, vit_dim=16, vit_heads=2)


def test_query_sets_match_jax(tmp_path):
    np.testing.assert_array_equal(
        teval.sample_grid_corners(0.1, (-0.2, -0.2, -0.1), (0.2, 0.2, 0.1)),
        jeval.sample_grid_corners(0.1, (-0.2, -0.2, -0.1), (0.2, 0.2, 0.1)))
    from monohair_tpu_torch.synthetic import write_synthwig_case
    write_synthwig_case(str(tmp_path), num_views=2)
    mesh = str(tmp_path / "synthwig" / "ours" / "colmap_points.obj")
    ours = teval.colmap_guided_queries(mesh, vsize=0.02)
    np.testing.assert_array_equal(ours, jeval.colmap_guided_queries(mesh, vsize=0.02))
    assert len(ours) > 100


def tiny_nets(rng, V=2, H=16, W=16):
    """Tiny flax nets with random weights, the same nets in the port, and
    MVSInputs for both (identity cameras looking down -z)."""
    imgs = rng.normal(size=(V, H, W, 4)).astype(np.float32)
    w2c = np.stack([np.eye(4)] * V).astype(np.float32)
    ndc = np.tile([1.0, 1.0, 0.0, 0.0], (V, 1)).astype(np.float32)
    tsfm = np.eye(4, dtype=np.float32)
    tsfm[:3, 3] = [0.01, -0.02, 0.03]
    j_in = jeval.MVSInputs(jnp.asarray(imgs), jnp.ones((V, H, W, 1)), jnp.asarray(w2c),
                           jnp.asarray(ndc), tsfm)
    t_in = teval.MVSInputs(torch.from_numpy(imgs), torch.ones((V, H, W, 1)),
                           torch.from_numpy(w2c), torch.from_numpy(ndc), tsfm)
    dummy = (j_in.imgs, jnp.zeros((4, 3)), jnp.zeros((V, 4, 3)), jnp.zeros((V, 4, 2)))
    nets = []
    for seed, jcls, tcls, prefix in ((0, JOcc, OccAttn, "occ_vit"), (1, JOri, OriAttn, "vit")):
        jm = jcls(num_views=V, **TINY)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), *dummy)
        sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables["params"]),
                                  jax.tree_util.tree_map(np.asarray, variables["batch_stats"]),
                                  prefix)
        nets.append((jm, variables, load_weights(tcls(num_views=V, **TINY), sd).eval()))
    return j_in, t_in, nets


def test_deep_mvs_eval_artefacts_match_jax(tmp_path, rng):
    """voxels.dat (header, count, data), raw.npy and Voxel_hair/{Occ3D,Ori3D}.mat
    of the same queries and weights; the occupancy margin sits at the median
    logit difference so that both decisions occur. The port's last batch is
    not padded."""
    j_in, t_in, ((jo, jov, to), (jr, jrv, tr)) = tiny_nets(rng)
    queries = ((rng.random((70, 3)) - 0.5) * 0.2).astype(np.float32)
    queries[:, 2] -= 1.0                       # in front of the identity cameras
    coord, cam = jeval.mvs_projection(j_in.w2c, j_in.ndc, jnp.asarray(queries))
    logits = np.asarray(jax.jit(jo.apply)(jov, j_in.imgs, jnp.asarray(queries), cam, coord))
    margin = float(np.median(logits[:, 1] - logits[:, 0]))
    kw = dict(query_points=queries, batch=32, vsize=0.1,
              bbox_min=np.array([-0.32, -0.32, -1.24], np.float32),
              bbox_max=np.array([0.32, 0.32, -0.76], np.float32), occ_margin=margin)
    jp, jori, jocc = jeval.deep_mvs_eval(j_in, jo, jov, jr, jrv,
                                         save_folder=str(tmp_path / "j"), **kw)
    tp, tori, tocc = teval.deep_mvs_eval(t_in, to, tr, save_folder=str(tmp_path / "t"), **kw)
    np.testing.assert_array_equal(tp, jp)
    assert (tocc == jocc).mean() >= 0.999 and 0 < jocc.mean() < 1
    np.testing.assert_allclose(tori, jori, rtol=1e-4, atol=1e-5)

    raw_t = np.fromfile(tmp_path / "t" / "voxels.dat", np.float32)
    raw_j = np.fromfile(tmp_path / "j" / "voxels.dat", np.float32)
    np.testing.assert_array_equal(raw_t[:7], raw_j[:7])
    assert int(raw_t[7]) == int(tocc.sum()) and len(raw_t) == 8 + int(raw_t[7]) * 6
    pts_t, ori_t, res, bmin, vs = tvox.load_voxels_dat(str(tmp_path / "t" / "voxels.dat"))
    np.testing.assert_allclose(res, [6.4, 6.4, 4.8], rtol=1e-5)
    np.testing.assert_allclose(pts_t + [0.01, -0.02, 0.03], queries[tocc], atol=1e-6)
    data_t = np.load(tmp_path / "t" / "raw.npy")
    data_j = np.load(tmp_path / "j" / "raw.npy")
    assert data_t.shape == data_j.shape == (70, 7)
    np.testing.assert_array_equal(data_t[:, :3], data_j[:, :3])
    np.testing.assert_array_equal(data_t[:, 6], data_j[:, 6])
    np.testing.assert_allclose(data_t[:, 3:6], data_j[:, 3:6], rtol=1e-4, atol=1e-5)
    for name, load in (("Occ3D.mat", load_occ_mat), ("Ori3D.mat", load_ori_mat)):
        np.testing.assert_allclose(load(str(tmp_path / "t" / "Voxel_hair" / name)),
                                   load(str(tmp_path / "j" / "Voxel_hair" / name)),
                                   rtol=1e-4, atol=1e-5)


def test_voxel_writers_match_jax(tmp_path, rng):
    """save_ori_mat_from_points with points that share voxels (the last one
    wins, in numpy's order) and voxels.dat both ways."""
    pts = ((rng.random((400, 3)) - 0.5) * 0.3).astype(np.float32)
    pts[200:] = pts[:200] + 1e-4              # duplicates of the first half
    oris = rng.normal(size=(400, 3)).astype(np.float32)
    tsfm = np.eye(4, dtype=np.float32)
    tsfm[:3, 3] = [0.0, 0.05, -0.02]
    args = (np.array([-0.32, -0.32, -0.24], np.float32), 0.0025, np.array([256, 256, 192]))
    save_ori_mat_from_points(pts, oris, *args, str(tmp_path / "t"), tsfm)
    j_save_ori(pts, oris, *args, str(tmp_path / "j"), tsfm)
    for name, load in (("Occ3D.mat", load_occ_mat), ("Ori3D.mat", load_ori_mat)):
        np.testing.assert_array_equal(load(str(tmp_path / "t" / name)),
                                      load(str(tmp_path / "j" / name)))
    grid = np.array([6.4, 6.4, 4.8], np.float32)
    tvox.save_voxels_dat(str(tmp_path / "a.dat"), pts, oris, grid, args[0], 0.1)
    jvox.save_voxels_dat(str(tmp_path / "b.dat"), pts, oris, grid, args[0], 0.1)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    for a, b in zip(tvox.load_voxels_dat(str(tmp_path / "b.dat")),
                    jvox.load_voxels_dat(str(tmp_path / "a.dat"))):
        np.testing.assert_array_equal(a, b)


def test_load_mvs_inputs_matches_jax(tmp_path, rng):
    """The four maps of rendered views, read back with the port's PNG reader
    (cv2's BGR->RGB order), in sorted directory order, with the cameras in
    file order and model_tsfm.dat transposed."""
    from monohair_tpu_torch.camera import Cameras
    from monohair_tpu_torch.io.cameras_io import save_cam_params
    from monohair_tpu_torch.render import render_data
    from monohair_tpu_torch.synthetic import cameras_numpy, ring_camera_list
    cl = ring_camera_list(3)
    ndc, w2c = cameras_numpy(cl)
    names = ["b", "a", "c"]
    save_cam_params(str(tmp_path / "cams.json"), names, ndc, np.linalg.inv(w2c))
    strands = list((rng.normal(size=(60, 6, 3)) * 0.05).astype(np.float32))
    bust = np.array([[-0.3, -0.3, -0.2], [0.3, -0.3, -0.2], [0.0, 0.3, -0.2]], np.float32)
    render_data(Cameras.from_json_list(cl, "cpu"), names, strands, bust, np.array([[0, 1, 2]]),
                (40, 32), str(tmp_path / "imgs"))
    np.arange(16, dtype=np.float32).tofile(tmp_path / "model_tsfm.dat")
    t_in, t_views = teval.load_mvs_inputs(str(tmp_path), str(tmp_path / "cams.json"),
                                          device="cpu")
    j_in, j_views = jeval.load_mvs_inputs(str(tmp_path), str(tmp_path / "cams.json"))
    assert t_views == j_views == ["a", "b", "c"]
    np.testing.assert_array_equal(t_in.imgs.numpy(), np.asarray(j_in.imgs))
    np.testing.assert_array_equal(t_in.masks.numpy(), np.asarray(j_in.masks))
    np.testing.assert_array_equal(t_in.w2c.numpy(), np.asarray(j_in.w2c))
    np.testing.assert_array_equal(t_in.ndc.numpy(), np.asarray(j_in.ndc))
    np.testing.assert_array_equal(t_in.model_tsfm, j_in.model_tsfm)
    assert t_in.masks.numpy().any() and os.path.exists(tmp_path / "imgs" / "a" / "mask.png")
