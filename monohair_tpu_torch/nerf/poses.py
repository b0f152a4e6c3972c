"""Pose plumbing between the MVS calibration rig, the NGP camera-path frame,
and NeRF transforms.json (port of monohair_tpu/nerf/poses.py, numpy float64).

Equivalent of Utils/ingp_utils.py: the fixed 16-view rig poses are re-anchored
on a single "key frame" (the NGP pose of the front view), capture-image MVS
poses derive from their NeRF transforms through the same anchor, and the coarse
mesh converts NeRF -> MVS.

All relations are plain rigid compositions. With A_i = rig view i's c2w in the
scaled rig frame (rotation through `mvs_to_ngp`, translation (T+1)*2), K = the
key-frame c2w, and B_j = capture j's NGP c2w from transforms.json:

    base_cam view i  :  c2w = K @ inv(A_0) @ A_i          (ingp_utils.py:247-302)
    capture j in rig :  c2w = A_0 @ inv(K) @ B_j          (ingp_utils.py:305-362)
    mesh NeRF -> MVS :  p_mvs = unscale(A_0 @ inv(K) @ ngp(p)) (ingp_utils.py:399-447)
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as R

from ..constants import BUST_TO_ORIGIN
from ..coords import nerf_to_ngp, ngp_to_nerf


def ngp_pose_to_nerf_c2w(quat: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """NGP camera-path entry (quaternion + T) -> NeRF-convention 4x4 c2w."""
    return ngp_to_nerf(R.from_quat(np.asarray(quat)).as_matrix(), np.asarray(trans))


def mvs_to_ngp_rot(rot: np.ndarray) -> np.ndarray:
    """Negate the y/z camera axes (ingp_utils.py:239-244)."""
    out = np.array(rot, dtype=np.float64)
    out[:, 1] *= -1
    out[:, 2] *= -1
    return out


def _rig_pose(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Rig c2w in the scaled rig-ngp frame: R' = mvs_to_ngp(R), T' = (T+1)*2."""
    m = np.eye(4)
    m[:3, :3] = mvs_to_ngp_rot(rot)
    m[:3, 3] = (np.asarray(trans, np.float64) + 1.0) * 2.0
    return m


def _se3(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = trans
    return m


def load_calib_rig(camera_path: str):
    """Rig c2w poses + per-view fov (degrees) from the calibration JSON
    (ingp_utils.load_cam_params :76-98; fov from intrin_op with the 2/3 scale)."""
    with open(camera_path) as f:
        data = json.load(f)
    poses, fovs_y = [], []
    w, h = 1080, 1920
    scale = 2.0 / 3.0
    for item in data["cam_list"]:
        pose = np.array(item["pose"], np.float64)
        poses.append(pose)
        fy = item["intrin_op"][1]
        fovs_y.append(math.degrees(math.atan(h / (fy / scale * 2)) * 2))
    return poses, fovs_y


def load_base_cam(path: str) -> Tuple[List[np.ndarray], List[np.ndarray], List[float]]:
    """NGP camera-path JSON: list of (R quaternion, T, fov) (ingp_utils.py:126-142)."""
    with open(path) as f:
        data = json.load(f)
    quats = [np.asarray(p["R"], np.float64) for p in data["path"]]
    trans = [np.asarray(p["T"], np.float64) for p in data["path"]]
    fovs = [p["fov"] for p in data["path"]]
    return quats, trans, fovs


def save_base_cam(path: str, c2w_list: List[np.ndarray], fovs: List[float]) -> None:
    out = {"path": [], "time": 0.0}
    for m, fov in zip(c2w_list, fovs):
        q = R.from_matrix(m[:3, :3]).as_quat()
        out["path"].append({"R": list(map(float, q)), "T": list(map(float, m[:3, 3])),
                            "aperture_size": 0.0, "fov": float(fov), "glow_mode": 0,
                            "glow_y_cutoff": 0.0, "scale": 0, "slice": 0.0})
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def generate_base_cam_from_key_frame(data_folder: str, camera_path: str,
                                     save_path: str) -> None:
    """16 fixed NGP render poses anchored on key_frame.json
    (generate_ngp_posefrom_cam_params, ingp_utils.py:247-302)."""
    poses, fovs = load_calib_rig(camera_path)
    A = [_rig_pose(p[:3, :3], p[:3, 3]) for p in poses]
    q, t, _ = load_base_cam(os.path.join(data_folder, "key_frame.json"))
    K = _se3(R.from_quat(q[0]).as_matrix(), t[0])
    anchor = K @ np.linalg.inv(A[0])
    out = [anchor @ Ai for Ai in A]
    save_base_cam(save_path, out, fovs)
    video_dir = os.path.join(data_folder, "video")
    os.makedirs(video_dir, exist_ok=True)
    for i, m in enumerate(out):
        save_base_cam(os.path.join(video_dir, "%03d.json" % i), [m], [fovs[i]])


def load_transforms_json(path: str, return_intrinsics: bool = False):
    """NeRF transforms.json -> ({file: 4x4 c2w}, fov_y degrees)
    (ingp_utils.load_transofrm_json :57-71). With return_intrinsics, also
    returns the raw intrinsics dict (fl_x/fl_y/cx/cy when colmap2nerf wrote
    them; else None entries) so callers need not assume fx == fy."""
    with open(path) as f:
        data = json.load(f)
    fov = math.degrees(data["camera_angle_y"])
    xforms = {}
    for fr in data["frames"]:
        name = os.path.basename(fr["file_path"])
        name = name[:-4] if name.lower().endswith((".png", ".jpg")) else name
        xforms[name] = np.array(fr["transform_matrix"], np.float64)
    out = dict(sorted(xforms.items()))
    if return_intrinsics:
        intr = {k: data.get(k) for k in ("fl_x", "fl_y", "cx", "cy", "w", "h")}
        return out, fov, intr
    return out, fov


def generate_mvs_pose_from_base_cam(data_folder: str, select_files: List[str],
                                    camera_path: str, image_size) -> str:
    """Per-capture-image MVS camera JSON (generate_mvs_pose_from_base_cam,
    ingp_utils.py:305-362): cam_params.json with NDC intrinsics from the NeRF
    fov and c2w poses mapped back to the MVS frame."""
    h, w = image_size
    xforms, fov = load_transforms_json(os.path.join(data_folder, "transforms.json"))
    poses, _ = load_calib_rig(camera_path)
    A0 = _rig_pose(poses[0][:3, :3], poses[0][:3, 3])
    qk, tk, _ = load_base_cam(os.path.join(data_folder, "base_cam.json"))
    base = _se3(R.from_quat(qk[0]).as_matrix(), tk[0])
    anchor = A0 @ np.linalg.inv(base)

    intrin = h / 2.0 / math.tan(math.radians(fov) / 2.0)
    cam_list = []
    for name, xf in xforms.items():
        if name not in select_files:
            continue
        rot3, t3 = nerf_to_ngp(xf)[:, :3], nerf_to_ngp(xf)[:, 3]
        B = _se3(rot3, t3)
        c2w = anchor @ B
        c2w[:3, 3] = c2w[:3, 3] / 2.0 - 1.0
        c2w[:3, 1:3] *= -1  # rig-ngp rotation back to MVS
        cam_list.append({
            "file": name, "intrin": [0.0] * 4,
            "intrin_op": [intrin, intrin, 0.0, 0.0], "dist": [0.0] * 5,
            "pose": c2w.tolist(),
            "ndc_prj": [intrin * 2 / w, intrin * 2 / h, 0.0, 0.0]})
    save_path = os.path.join(data_folder, "cam_params.json")
    with open(save_path, "w") as f:
        json.dump({"cam_list": cam_list}, f, indent=4)
    return save_path


def convert_mesh_nerf_to_mvs(vertices_nerf: np.ndarray, data_folder: str,
                             camera_path: str) -> np.ndarray:
    """Coarse-mesh vertices NeRF -> MVS bust-origin frame
    (convert_mesh_to_mvs, ingp_utils.py:399-447)."""
    poses, _ = load_calib_rig(camera_path)
    A0 = _rig_pose(poses[0][:3, :3], poses[0][:3, 3])
    q, t, _ = load_base_cam(os.path.join(data_folder, "key_frame.json"))
    K = _se3(R.from_quat(q[0]).as_matrix(), t[0])
    anchor = A0 @ np.linalg.inv(K)

    v = vertices_nerf * 0.33 + 0.5
    v = (anchor[:3, :3] @ v.T + anchor[:3, 3:4]).T
    v = v / 2.0 - 1.0
    return v - BUST_TO_ORIGIN


def auto_key_frame(data_folder: str, camera_path: str,
                   front_image: Optional[str] = None) -> str:
    """Automate the reference's interactive key-frame pick (readme TODO).

    Choose the capture pose closest to the rig's front view direction (or the
    named image) and write key_frame.json with its NGP pose.
    """
    xforms, fov = load_transforms_json(os.path.join(data_folder, "transforms.json"))
    names = list(xforms)
    if front_image is not None and front_image in xforms:
        pick = front_image
    else:
        # front = camera whose viewing direction best matches the average
        # look-at of all captures toward the scene center
        centers = np.stack([xforms[n][:3, 3] for n in names])
        center = centers.mean(0)
        dirs = np.stack([-xforms[n][:3, 2] for n in names])  # NeRF forward = -z
        to_center = center - centers
        to_center /= np.maximum(np.linalg.norm(to_center, axis=-1, keepdims=True), 1e-9)
        pick = names[int(np.argmax(np.sum(dirs * to_center, -1)))]
    m = nerf_to_ngp(xforms[pick])
    path = os.path.join(data_folder, "key_frame.json")
    save_base_cam(path, [_se3(m[:, :3], m[:, 3])], [fov])
    return path
