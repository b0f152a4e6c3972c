"""Camera-rig calibration preparation: intrinsics normalization and pose
spherification (port of monohair_tpu/calib.py; Utils/Utils.py:447-583
equivalents), numpy only.

Converts raw multi-camera calibrations into the canonical MVS rig used by
every stage: intrinsics rescaled to a target resolution and expressed as NDC,
camera-to-world poses recentered on the rays' closest point, oriented by the
front view, and scaled to a normalized radius.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def norm_cam_intrin(intrin_mat: np.ndarray, src_res, tgt_res=(1200, 800),
                    scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(V, 3, 3) pixel intrinsics at src_res -> (pixel intrinsics at tgt_res,
    NDC intrinsics (fx, fy, cx, cy)) (Utils.py:447-462)."""
    fx = intrin_mat[:, 0, 0] * scale
    fy = intrin_mat[:, 1, 1] * scale
    h, w = src_res
    th, tw = tgt_res
    cx = (intrin_mat[:, 0, 2] - w / 2) * scale + tw / 2
    cy = (intrin_mat[:, 1, 2] - h / 2) * scale + th / 2
    ndc = np.stack([2.0 * fx / tw, 2.0 * fy / th,
                    1 - 2.0 * cx / tw, 1 - 2.0 * (th - cy) / th], 1)
    return np.stack([fx, fy, cx, cy], 1), ndc


def min_line_dist_point(rays_o: np.ndarray, rays_d: np.ndarray) -> np.ndarray:
    """Closest point to a bundle of rays (least squares, Utils.py:464-468)."""
    A = np.eye(3, dtype=np.float64) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b = np.transpose(A, (0, 2, 1)) @ A @ rays_o
    return np.squeeze(np.linalg.inv((np.transpose(A, (0, 2, 1)) @ A).mean(0))
                      @ b.mean(0))


def spherify_cam_poses(poses: np.ndarray, front_vid: int, norm_rad: float = 0.8
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Recenter/orient/scale (V, 4, 4) c2w poses (Utils.py:473-507): world
    origin at the rays' closest point, +y from the front view's down axis,
    front view along +z, mean camera radius = norm_rad. Returns
    (poses_recenter with y/z columns flipped to the MVS convention,
    recover_tsfm mapping back to the original frame)."""
    def unit(x):
        return x / np.linalg.norm(x)

    front = poses[front_vid]
    ray_d = poses[:, :3, 2:3]
    ray_o = poses[:, :3, 3:4]
    center = min_line_dist_point(ray_o, ray_d)
    up = unit(-front[:3, 1])
    fwd = unit(front[:3, 3] - center)
    left = unit(np.cross(up, fwd))
    world = np.concatenate([np.stack([left, up, fwd, center], 1),
                            np.array([[0, 0, 0, 1.0]])], 0)
    recentered = np.linalg.inv(world) @ poses
    radius = np.mean(np.linalg.norm(recentered[:, :3, 3], axis=-1))
    rad_scale = norm_rad / radius
    recentered[:, :3, 3] *= rad_scale
    recover = world.copy()
    recover[:3, :3] /= rad_scale
    recentered[:, :3, 1:3] *= -1
    return recentered, recover


def build_rig_json(names, recentered_poses: np.ndarray, pix_intrin: np.ndarray,
                   ndc_intrin: np.ndarray, save_path: Optional[str] = None) -> dict:
    """Assemble the cam_params.json rig from spherified poses (the artifact at
    camera/calib_data/<case>/cam_params.json)."""
    import json
    cam_list = []
    for name, pose, pi, nd in zip(names, recentered_poses, pix_intrin, ndc_intrin):
        cam_list.append({"file": str(name), "intrin": [0.0] * 4,
                         "intrin_op": [float(x) for x in pi],
                         "dist": [0.0] * 5,
                         "pose": pose.tolist(),
                         "ndc_prj": [float(x) for x in nd]})
    data = {"cam_list": cam_list}
    if save_path:
        with open(save_path, "w") as f:
            json.dump(data, f, indent=4)
    return data
