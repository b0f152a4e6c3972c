"""The four per-view render passes feeding DeepMVSHair and the colmap+bust
depth maps PMVO reads (port of monohair_tpu/render.py; reference
Utils/Render_utils.py:269-347): bust_depth, undirectional_map (double-angle
strand color over black bust), mask (white strands over black bust),
hair_depth (strand depth over white bust), and render_depth/<view>.npy.
Strands and mesh compose by z-buffer minimum, as the GL depth test does.
Rendering runs on the cameras' device; the PNGs and the render_depth/<view>.JPG
preview beside each .npy go through the port's own writers.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .camera import Cameras
from .constants import DEPTH_RANGE
from .io.hair_io import strand_directions
from .io.image_io import imwrite, write_png
from .ops.rasterize import (compose_depth_to_image, rasterize_mesh_depth,
                            rasterize_strands, tangent_colors, tangent_step_points)

MAP_NAMES = ("bust_depth", "undirectional_map", "mask", "hair_depth")


def strands_to_segments(strands: Sequence[np.ndarray]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split strands into segments with per-segment tangents (the reference
    builds GL LINES with per-vertex forward-difference tangents,
    Render_utils.py:14-27)."""
    starts, ends, tans = [], [], []
    for s in strands:
        if s.shape[0] < 2:
            continue
        starts.append(s[:-1])
        ends.append(s[1:])
        tans.append(strand_directions(s)[:-1])
    if not starts:
        z = np.zeros((0, 3), np.float32)
        return z, z.copy(), z.copy()
    return (np.concatenate(starts).astype(np.float32),
            np.concatenate(ends).astype(np.float32),
            np.concatenate(tans).astype(np.float32))


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8 by truncation, as the reference writes it."""
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def upload_segments(seg: Tuple[np.ndarray, np.ndarray, np.ndarray], device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """strands_to_segments' (starts, ends, tangents) as the tensors every view
    renders from: (starts, ends, tangent_step_points) on `device`, copied once."""
    seg_s, seg_e, seg_t = seg
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (seg_s, seg_e, tangent_step_points(seg_s, seg_t)))


def render_view(cam: Cameras, seg: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                bust_vertices: np.ndarray, bust_faces: np.ndarray,
                image_size: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """The four maps of one view (a one-camera `cam`) as tensors on its
    device, from upload_segments' tensors on that device."""
    seg_s, seg_e, seg_step = seg
    bust_z = rasterize_mesh_depth(cam, bust_vertices, bust_faces, image_size)
    colors = tangent_colors(cam, seg_s, seg_step, mode=2)
    hair_z, hair_col = rasterize_strands(cam, seg_s, seg_e, colors, image_size)
    hair_wins = hair_z < bust_z
    return {
        "bust_depth": compose_depth_to_image(bust_z, background=1.0, depth_range=DEPTH_RANGE),
        "undirectional_map": torch.where(hair_wins[..., None], hair_col, 0.0),  # bust+bg black
        "mask": hair_wins.float(),
        "hair_depth": torch.where(hair_wins, hair_z / DEPTH_RANGE, 1.0),       # bust+bg white
    }


def render_data(cameras: Cameras, names: List[str], strands: Sequence[np.ndarray],
                bust_vertices: np.ndarray, bust_faces: np.ndarray,
                image_size: Tuple[int, int] = (1280, 720),
                save_root: Optional[str] = None) -> Dict[str, Dict[str, np.ndarray]]:
    """Render the 4 MVS input maps per view (Render_utils.py:269-307).

    image_size = (H, W). Returns {view: {bust_depth, undirectional_map, mask,
    hair_depth}} images in [0, 1]; also writes <save_root>/<view>/<name>.png.
    """
    seg = upload_segments(strands_to_segments(strands), cameras.device)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for v, view in enumerate(names):
        imgs = {k: x.cpu().numpy() for k, x in
                render_view(cameras[v], seg, bust_vertices, bust_faces, image_size).items()}
        out[view] = imgs
        if save_root:
            d = os.path.join(save_root, view)
            os.makedirs(d, exist_ok=True)
            for k, img in imgs.items():
                write_png(os.path.join(d, k + ".png"), to_uint8(img))
    return out


def render_bust_hair_depth(cameras: Cameras, names: List[str],
                           colmap_vertices: np.ndarray, colmap_faces: np.ndarray,
                           save_root: Optional[str] = None,
                           image_size: Tuple[int, int] = (1280, 720),
                           capture_imgs: bool = False,
                           bust_vertices: Optional[np.ndarray] = None,
                           bust_faces: Optional[np.ndarray] = None
                           ) -> Dict[str, np.ndarray]:
    """Per-view depth of the coarse colmap mesh (+ optional bust), the
    `render_depth/<view>.npy` maps PMVO consumes (Render_utils.py:310-347).

    Returns {view: (H, W) image in [0,1]}; with capture_imgs writes
    <save_root>/<view>.npy scaled by 255 as (H, W, 3) and its JPEG preview
    <save_root>/<view>.JPG, else
    <save_root>/<view>/bust_hair_depth.png.
    """
    H, W = image_size
    out = {}
    for v, view in enumerate(names):
        cam = cameras[v]
        z = rasterize_mesh_depth(cam, colmap_vertices, colmap_faces, (H, W))
        if bust_vertices is not None:
            z = torch.minimum(z, rasterize_mesh_depth(cam, bust_vertices, bust_faces, (H, W)))
        img = compose_depth_to_image(z, background=1.0, depth_range=DEPTH_RANGE).cpu().numpy()
        out[view] = img
        if save_root:
            os.makedirs(save_root, exist_ok=True)
            if capture_imgs:
                depth_save = np.repeat(img[..., None] * 255.0, 3, -1).astype(np.float32)
                np.save(os.path.join(save_root, view + ".npy"), depth_save)
                imwrite(os.path.join(save_root, view + ".JPG"),
                        np.clip(depth_save, 0, 255).astype(np.uint8))
            else:
                d = os.path.join(save_root, view)
                os.makedirs(d, exist_ok=True)
                write_png(os.path.join(d, "bust_hair_depth.png"), to_uint8(img))
    return out
