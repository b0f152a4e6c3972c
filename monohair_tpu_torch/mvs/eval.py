"""Dense occupancy/orientation field inference (port of monohair_tpu/mvs/eval.py;
reference deep_mvs_eval, submodules/DeepMVSHair/mvs_eval.py:13-254).

Each net's feature pyramid is computed once; query points then stream through
both heads in batches of `batch`, on the device of the inputs, or, given a mesh
(a tuple of devices, parallel/sharding.py), on its devices in turn (batch k on
device k mod len(mesh)) against nets and features replicated once. A batch is
not cut across devices, as the JAX package cuts it: its shape sets the nets'
matrix products' shapes, and with them the kernels' summation order (cut in
three on the CPU, the orientations moved by up to 5.5e-7 relative), so whole
batches keep the unsharded results bit for bit. Results stay on the devices
until the last batch, then come to the host once.

Input channel stack per view (BaseDataset.py:293-374 real mode +
mvs_eval.py:103-107): [cos2t, sin2t (undirectional map * 2 - 1),
hair_depth * 2, bust_depth * 2]; NHWC.
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import VOXEL_MAX, VOXEL_MIN, VSIZE_COARSE
from ..io.cameras_io import load_cam_params
from ..io.image_io import imread_bgr, imread_gray
from ..io.mat_io import save_ori_mat_from_points
from ..io.voxels_io import save_voxels_dat
from ..models.pifu import OccAttn, OriAttn, mvs_projection, occ_decision
from ..parallel.sharding import Mesh, concat_shards, replicate


class MVSInputs(NamedTuple):
    imgs: torch.Tensor       # (V, H, W, 4)
    masks: torch.Tensor      # (V, H, W, 1)
    w2c: torch.Tensor        # (V, 4, 4)
    ndc: torch.Tensor        # (V, 4)
    model_tsfm: np.ndarray   # (4, 4)


def sample_grid_corners(vsize: float, bbox_min, bbox_max) -> np.ndarray:
    """Dense corner grid over the bbox (EvalDataset.py:20): points at every
    voxel corner of resolution vsize."""
    axes = [np.arange(bbox_min[d], bbox_max[d] + vsize / 2, vsize) for d in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(np.float32)


def colmap_guided_queries(colmap_mesh_path: str, vsize: float = VSIZE_COARSE,
                          seed: int = 0) -> np.ndarray:
    """Colmap-guided fine query set (EvalDataset.py:39-52): one jittered sample
    per vsize/8 voxel around the coarse mesh ([1024,1024,768] binning grid),
    plus a vsize/4 corner grid restricted to the mesh's bbox."""
    from ..pmvo.points import load_colmap_points
    pts = load_colmap_points(colmap_mesh_path, vsize=vsize / 8,
                             grid_resolution=(1024, 1024, 768), num_per_grid=1,
                             seed=seed)
    fine_grid = sample_grid_corners(vsize / 4, pts.min(0), pts.max(0))
    return np.concatenate([fine_grid, pts], 0).astype(np.float32)


@torch.no_grad()
def eval_points(occ_model: OccAttn, ori_model: OriAttn, occ_feats, ori_feats,
                w2c: torch.Tensor, ndc: torch.Tensor, pts: torch.Tensor,
                occ_margin: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch: project, sample features, run both heads.

    `occ_margin` is the decision threshold on the logit difference (0.0 =
    argmax); tools/tune_occ_threshold.py stores the tuned one beside the
    checkpoint (occ_margin.json). Returns (occ_positive (N,) bool, ori (N, 3)
    unit)."""
    coord, cam = mvs_projection(w2c, ndc, pts)
    logits = occ_model.forward_with_feat(occ_feats, pts, cam, coord)
    ori = ori_model.forward_with_feat(ori_feats, pts, cam, coord)
    return occ_decision(logits, occ_margin), ori


@torch.no_grad()
def deep_mvs_eval(inputs: MVSInputs, occ_model: OccAttn, ori_model: OriAttn,
                  save_folder: Optional[str] = None,
                  query_points: Optional[np.ndarray] = None,
                  batch: int = 8192, vsize: float = VSIZE_COARSE,
                  bbox_min=VOXEL_MIN, bbox_max=VOXEL_MAX, occ_margin: float = 0.0,
                  mesh: Optional[Mesh] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stream the query points through both nets; write voxels.dat,
    Voxel_hair/{Occ3D,Ori3D}.mat and raw.npy like the reference
    (mvs_eval.py:198-251). Returns (query points, unit orients, occ) arrays.
    With `mesh`, the batches are dealt to its devices in turn."""
    if query_points is None:
        query_points = sample_grid_corners(vsize / 2, bbox_min, bbox_max)
    n = query_points.shape[0]
    dev = inputs.imgs.device
    occ_feats = occ_model.get_feat(inputs.imgs)
    ori_feats = ori_model.get_feat(inputs.imgs)
    replicas = replicate((occ_model, ori_model, occ_feats, ori_feats, inputs.w2c,
                          inputs.ndc), mesh)

    devices = mesh or (dev,)
    outs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    n_batches = (n + batch - 1) // batch
    t_loop = time.monotonic()
    for k, beg in enumerate(range(0, n, batch)):
        i = k % len(devices)
        pts = torch.as_tensor(query_points[beg:beg + batch], device=devices[i])
        outs.append(eval_points(*replicas[i], pts, occ_margin))
        if k % 64 == 0:
            print(f"[mvs_eval] batch {k + 1}/{n_batches} "
                  f"({time.monotonic() - t_loop:.0f}s)", flush=True)
    occ, orients = (t.numpy() for t in concat_shards(outs))
    orients /= np.maximum(np.linalg.norm(orients, axis=-1, keepdims=True), 1e-12)

    if save_folder:
        save_mvs_outputs(save_folder, inputs.model_tsfm, query_points, orients, occ,
                         vsize, bbox_min, bbox_max)
    return query_points, orients, occ


def save_mvs_outputs(save_folder: str, model_tsfm: np.ndarray, query_points: np.ndarray,
                     orients: np.ndarray, occ: np.ndarray, vsize: float,
                     bbox_min, bbox_max) -> None:
    """voxels.dat, Voxel_hair/{Occ3D,Ori3D}.mat and raw.npy of one evaluation
    (mvs_eval.py:198-251)."""
    os.makedirs(save_folder, exist_ok=True)
    tsfm_inv = np.linalg.inv(model_tsfm)
    pos_pts = query_points[occ]
    save_points = (tsfm_inv[:3, :3] @ pos_pts.T + tsfm_inv[:3, 3:4]).T
    save_oris = (tsfm_inv[:3, :3] @ orients[occ].T).T
    save_oris /= np.maximum(np.linalg.norm(save_oris, axis=-1, keepdims=True), 1e-12)

    grid_resolution = np.array([(bbox_max[0] - bbox_min[0]) / vsize,
                                (bbox_max[1] - bbox_min[1]) / vsize,
                                (bbox_max[2] - bbox_min[2]) / vsize], np.float32)
    save_voxels_dat(os.path.join(save_folder, "voxels.dat"), save_points, save_oris,
                    grid_resolution, bbox_min, vsize)
    save_ori_mat_from_points(save_points, save_oris.copy(),
                             np.asarray(bbox_min, np.float32), vsize / 2,
                             grid_resolution * 2, os.path.join(save_folder, "Voxel_hair"),
                             model_tsfm)
    raw = np.concatenate([query_points, orients, occ[:, None].astype(np.float32)], 1)
    np.save(os.path.join(save_folder, "raw.npy"), raw)


def load_mvs_inputs(case_dir: str, calib_path: str, views_subdir: str = "imgs",
                    device="cuda") -> Tuple[MVSInputs, list]:
    """Read the per-view render maps + cameras + model_tsfm for one case
    (BaseDataset.read_real_data, BaseDataset.py:293-374). Images are taken in
    sorted directory order, cameras in file order, as the reference does."""
    _, cams = load_cam_params(calib_path, device)
    img_dir = os.path.join(case_dir, views_subdir)
    views = sorted(os.listdir(img_dir))
    imgs, masks = [], []
    for view in views:
        vd = os.path.join(img_dir, view)
        und = imread_bgr(os.path.join(vd, "undirectional_map.png"))[..., ::-1] / 255.0
        orient = und[..., :2] * 2.0 - 1.0
        hair_d = imread_gray(os.path.join(vd, "hair_depth.png"))[..., None] / 255.0 * 2.0
        bust_d = imread_gray(os.path.join(vd, "bust_depth.png"))[..., None] / 255.0 * 2.0
        m = imread_gray(os.path.join(vd, "mask.png"))[..., None] / 255.0
        masks.append((m >= 0.5).astype(np.float32))
        imgs.append(np.concatenate([orient, hair_d, bust_d], -1).astype(np.float32))
    tsfm_path = os.path.join(case_dir, "model_tsfm.dat")
    if os.path.exists(tsfm_path):
        tsfm = np.fromfile(tsfm_path, dtype=np.float32).reshape(4, 4).T
    else:
        # wig captures skip bust fitting (prepare_data.py:127-128); identity
        tsfm = np.eye(4, dtype=np.float32)
    return MVSInputs(torch.as_tensor(np.stack(imgs), device=device),
                     torch.as_tensor(np.stack(masks), device=device),
                     cams.w2c, cams.ndc, tsfm), views
