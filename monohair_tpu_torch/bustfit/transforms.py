"""Fitted-transform application and export (port of
monohair_tpu/bustfit/transforms.py, numpy).

Mirrors transform_bust (Utils/Utils.py:1091-1108), generate_headtrans_from_tsfm
(Utils.py:926-945) and the euler convention eularToMatrix_np (Utils.py:895-924):
model_tsfm.dat is a column-major 4x4 (OpenGL layout, transposed on read);
model_tsfm_semantic.dat is [tx, ty, tz, rx, ry, rz (degrees), scale].
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.spatial.transform import Rotation as R

from ..config import Config
from ..constants import BUST_TO_ORIGIN
from ..io.mesh_io import load_obj, save_obj


def load_model_tsfm(path: str) -> np.ndarray:
    """Read the column-major 4x4 (BaseDataset.readMatrixFromFile semantics)."""
    return np.fromfile(path, dtype=np.float32).reshape(4, 4).T


def save_model_tsfm(path: str, tsfm: np.ndarray) -> None:
    np.asarray(tsfm, np.float32).T.reshape(-1).tofile(path)


def transform_bust(mesh_path: str, tsfm_path: str, save_path: str) -> None:
    """Apply the fitted transform around the bust-origin shift
    (Utils.py:1091-1108)."""
    v, f = load_obj(mesh_path)
    if len(v) == 0:
        print(f"[process_bust] {mesh_path} is empty; skipping transform")
        save_obj(save_path, v.reshape(0, 3), f.reshape(0, 3))
        return
    tsfm = load_model_tsfm(tsfm_path)
    v = v + BUST_TO_ORIGIN
    v = (tsfm[:3, :3] @ v.T + tsfm[:3, 3:4]).T
    v = v - BUST_TO_ORIGIN
    save_obj(save_path, v, f)


def euler_yzx_style_matrix(theta_over_pi: np.ndarray, order: str = "xzy") -> np.ndarray:
    """The reference's eularToMatrix_np (Utils.py:895-924): angles given as
    theta/pi, composed in its custom 'xzy' layout. Reproduced via scipy with
    the matching intrinsic convention, golden-tested against the formula."""
    t = np.asarray(theta_over_pi, np.float64) * math.pi
    c1, c2, c3 = np.cos(t)
    s1, s2, s3 = np.sin(t)
    if order == "xzy":
        return np.array([
            [c2 * c3, -s2, c2 * s3],
            [s1 * s3 + c1 * c3 * s2, c1 * c2, c1 * s2 * s3 - c3 * s1],
            [c3 * s1 * s2 - c1 * s3, c2 * s1, c1 * c3 + s1 * s2 * s3]])
    raise ValueError(order)


def generate_headtrans_from_tsfm(tsfm_semantic_path: str, save_path: str) -> None:
    """model_tsfm_semantic.dat -> head.trans (quaternion row + [t, scale] row),
    the file DeepMVSHair's consumers read (Utils.py:926-945)."""
    sem = np.fromfile(tsfm_semantic_path, dtype=np.float32)
    matrix = euler_yzx_style_matrix(np.array([sem[3], -sem[5], -sem[4]]) / 180.0)
    quat = R.from_matrix(matrix).as_quat()
    trans_scale = np.array([sem[0], -sem[1], -sem[2], sem[6]])
    np.savetxt(save_path, np.stack([quat, trans_scale]))


def semantic_to_matrix(sem: np.ndarray) -> np.ndarray:
    """[t(3), euler deg(3), scale] -> 4x4 model transform (the inverse packing
    of SMPLX_optimizer's export, multiview_optimization.py:780-790)."""
    m = np.eye(4)
    rot = euler_yzx_style_matrix(np.array([sem[3], sem[4], sem[5]]) / 180.0)
    m[:3, :3] = rot * sem[6]
    m[:3, 3] = sem[:3]
    return m


def matrix_to_semantic(tsfm: np.ndarray) -> np.ndarray:
    """4x4 similarity -> [t(3), euler deg(3), scale]: the inverse of
    semantic_to_matrix, so the exported model_tsfm_semantic.dat round-trips.
    Euler extraction follows the reference 'xzy' layout (R[0,1] = -sin t2)."""
    M = np.asarray(tsfm, np.float64)
    scale = float(np.cbrt(np.linalg.det(M[:3, :3])))
    R3 = M[:3, :3] / scale
    t2 = math.asin(np.clip(-R3[0, 1], -1.0, 1.0))
    t1 = math.atan2(R3[2, 1], R3[1, 1])
    t3 = math.atan2(R3[0, 2], R3[0, 0])
    sem = np.zeros(7, np.float32)
    sem[:3] = M[:3, 3]
    sem[3:6] = np.degrees([t1, t2, t3])
    sem[6] = scale
    return sem


def process_bust_meshes(args: Config) -> None:
    """Stage-1 process_bust step (prepare_data.py:142-159): copy fitted meshes
    into ours/Voxel_hair, apply model_tsfm to bust/scalp/flame, export head.trans."""
    import shutil
    root = args.data.root
    vh = os.path.join(root, "ours/Voxel_hair")
    os.makedirs(vh, exist_ok=True)
    for name in ("bust_long.obj", "scalp.obj", "flame_bust.obj"):
        src = os.path.join(root, "Bust", name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(vh, name))
    tsfm = os.path.join(root, "model_tsfm.dat")
    if not os.path.exists(tsfm):
        # wig mode: no bust fit ran — identity transform (run_bust_fit's
        # _write_identity contract, mirrored here for robustness)
        print("[process_bust] model_tsfm.dat missing; using identity")
        save_model_tsfm(tsfm, np.eye(4))
    shutil.copyfile(tsfm, os.path.join(vh, "model_tsfm.dat"))
    for name, out in (("bust_long.obj", "bust_long_tsfm.obj"),
                      ("scalp.obj", "scalp_tsfm.obj"),
                      ("flame_bust.obj", "flame_bust_tsfm.obj")):
        src = os.path.join(vh, name)
        if os.path.exists(src):
            transform_bust(src, tsfm, os.path.join(root, "ours", out))
    sem = os.path.join(root, "model_tsfm_semantic.dat")
    if os.path.exists(sem):
        generate_headtrans_from_tsfm(sem, os.path.join(vh, "head.trans"))
