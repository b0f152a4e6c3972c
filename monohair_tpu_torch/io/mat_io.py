"""Occ3D.mat / Ori3D.mat volume I/O, byte-compatible with the reference
(port of monohair_tpu/io/mat_io.py; numpy arrays in and out).

In-memory convention:
    occ : (X, Y, Z) float32, 1 = occupied
    ori : (X, Y, Z, 3) float32 — **world-frame** unit directions (the reference
          stores world directions in the .mat and flips y/z into voxel-frame only
          inside HairGrowing, HairGrow.py:55-56)

Disk layout (reference: PMVO.py:753-764 writes, PMVO_utils.py:86-113 reads):
    'Occ' : (Y, X, Z)
    'Ori' : (Y, X, 3*Z) where the last axis is channel-major: index = c*Z + z
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.io


def load_occ_mat(path: str) -> np.ndarray:
    """Read Occ3D.mat -> (X, Y, Z) float32."""
    occ = scipy.io.loadmat(path, verify_compressed_data_integrity=False)["Occ"]
    return np.ascontiguousarray(occ.transpose(1, 0, 2)).astype(np.float32)


def load_ori_mat(path: str) -> np.ndarray:
    """Read Ori3D.mat -> (X, Y, Z, 3) float32 world-frame directions."""
    ori = scipy.io.loadmat(path, verify_compressed_data_integrity=False)["Ori"]
    Y, X, CZ = ori.shape
    Z = CZ // 3
    ori = ori.reshape(Y, X, 3, Z).transpose(1, 0, 3, 2)  # -> (X, Y, Z, 3)
    return np.ascontiguousarray(ori).astype(np.float32)


def save_occ_ori_mat(save_dir: str, occ: np.ndarray, ori: Optional[np.ndarray] = None,
                     suffix: str = "") -> Tuple[str, Optional[str]]:
    """Write (X,Y,Z) occ and (X,Y,Z,3) ori in the reference's layout
    (PMVO.py:753-764 / Utils.py:868-874)."""
    os.makedirs(save_dir, exist_ok=True)
    X, Y, Z = occ.shape
    occ_path = os.path.join(save_dir, f"Occ3D{suffix}.mat")
    scipy.io.savemat(occ_path, {"Occ": occ.transpose(1, 0, 2)})
    ori_path = None
    if ori is not None:
        ori_disk = ori.transpose(0, 1, 3, 2).reshape(X, Y, 3 * Z).transpose(1, 0, 2)
        ori_path = os.path.join(save_dir, f"Ori3D{suffix}.mat")
        scipy.io.savemat(ori_path, {"Ori": ori_disk})
    return occ_path, ori_path



def save_ori_mat_from_points(positive_points: np.ndarray, orientation: np.ndarray,
                             voxel_min: np.ndarray, voxel_size: float,
                             grid_resolution: np.ndarray, save_dir: str,
                             model_tsfm: np.ndarray) -> None:
    """Voxelize (N,3) world points + directions and save Occ/Ori mats.

    Mirror of `save_ori_mat` (Utils/Utils.py:836-874): directions are flipped to
    point "down" (y<=0), points are moved by model_tsfm then y/z-negated into the
    voxel frame, nearest-voxel assignment. Where several points share a voxel
    the last one wins, in numpy's fancy-index assignment order.
    """
    grid_resolution = np.asarray(grid_resolution).astype(np.int32)
    occ = np.zeros(tuple(grid_resolution), dtype=np.float32)
    ori = np.zeros((*grid_resolution, 3), dtype=np.float32)

    orientation = orientation.copy()
    orientation[orientation[:, 1] > 0] *= -1

    pts = (model_tsfm[:3, :3] @ positive_points.T + model_tsfm[:3, 3:4]).T
    pts[:, 1:] *= -1
    idx = np.round((pts - voxel_min) / voxel_size).astype(np.int32)
    idx = np.clip(idx, 0, grid_resolution - 1)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = 1
    ori[idx[:, 0], idx[:, 1], idx[:, 2]] = orientation
    save_occ_ori_mat(save_dir, occ, ori)
