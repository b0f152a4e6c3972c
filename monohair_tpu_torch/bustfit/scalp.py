"""Scalp / FLAME / bust meshes from the fitted head (port of
monohair_tpu/bustfit/scalp.py, numpy).

The scalp is the set of head-template faces whose UV footprint lands on the
red region of the scalp mask (the reference's generate_scalp_from_head); the
FLAME bust is the SMPL-X vertex subset given by the SMPL-X__FLAME_vertex_ids
asset; bust_long keeps everything above a cut plane.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..io.image_io import imread_bgr
from ..io.mesh_io import load_obj_with_uv, save_obj


def extract_scalp(head_obj_path: str, scalp_mask_path: str, save_path: str,
                  red_threshold: float = 0.3, verts_override: np.ndarray = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the head-template faces whose three corners' red sum exceeds
    255 * red_threshold in the scalp mask, and save the submesh.
    `verts_override` takes the fitted vertex positions in place of the
    template's (topology and UVs from the template)."""
    verts, faces, uvs, face_uvs = load_obj_with_uv(head_obj_path)
    if verts_override is not None:
        if len(verts_override) != len(verts):
            raise ValueError(f"verts_override has {len(verts_override)} verts, "
                             f"template has {len(verts)}")
        verts = np.asarray(verts_override)
    if face_uvs is None:
        raise ValueError(f"{head_obj_path} has no per-face UVs")
    tex = imread_bgr(scalp_mask_path)
    th, tw = tex.shape[:2]
    fuv = uvs[face_uvs]                               # (F, 3, 2) in [0, 1]
    px = np.clip(np.around(fuv[..., 0] * tw).astype(np.int64), 0, tw - 1)
    py = np.clip(np.around(fuv[..., 1] * th).astype(np.int64), 1, th)
    # the OBJ's v axis runs bottom-up, the image's rows top-down
    colors = tex[th - py, px, 2]                      # red channel (BGR)
    keep = colors.sum(1) > 255 * red_threshold
    sub_faces = faces[keep]
    used = np.unique(sub_faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    out_faces = remap[sub_faces]
    out_verts = verts[used]
    save_obj(save_path, out_verts, out_faces)
    return out_verts, out_faces


def extract_flame_bust(smplx_verts: np.ndarray, flame_vertex_ids_path: str,
                       flame_template_path: str, save_path: str) -> None:
    """FLAME-subset mesh from fitted SMPL-X vertices: positions from the fit,
    topology from the FLAME head template."""
    ids = np.load(flame_vertex_ids_path)
    _, faces, _, _ = load_obj_with_uv(flame_template_path)
    save_obj(save_path, smplx_verts[ids], faces)


def cut_bust_long(verts: np.ndarray, faces: np.ndarray, save_path: str,
                  y_cut: float = -0.6) -> None:
    """Keep the mesh above a horizontal cut (the 'long bust' of the depth
    renders)."""
    keep_v = verts[:, 1] > y_cut
    keep_f = keep_v[faces].all(1)
    used = np.unique(faces[keep_f])
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    save_obj(save_path, verts[used], remap[faces[keep_f]])
