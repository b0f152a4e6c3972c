"""COLMAP text model -> NeRF transforms.json converter (port of
monohair_tpu/nerf/colmap.py, numpy float64).

The reference relies on instant-ngp's colmap2nerf.py run by the user
(video_preprocess/readme.md:8-10, SURVEY.md §2.5 N2). This is the native
equivalent: parse cameras.txt / images.txt, recenter/rescale the scene, write
transforms.json in the NeRF convention our hash-grid trainer consumes.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def read_cameras_txt(path: str) -> Dict[int, dict]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cam_id, model = int(el[0]), el[1]
            w, h = int(el[2]), int(el[3])
            params = list(map(float, el[4:]))
            if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
                fx = fy = params[0]
                cx, cy = params[1], params[2]
            elif model in ("PINHOLE", "OPENCV"):
                fx, fy, cx, cy = params[:4]
            else:
                raise ValueError(f"unsupported COLMAP camera model {model}")
            cams[cam_id] = dict(w=w, h=h, fx=fx, fy=fy, cx=cx, cy=cy)
    return cams


def read_images_txt(path: str) -> Dict[str, Tuple[np.ndarray, int]]:
    """{image name: (4x4 world-to-camera, camera id)}."""
    out = {}
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#") and ln.strip()]
    # pose lines have exactly 10 fields ending in the image name; the alternate
    # 2D-point lines have 3N numeric fields (possibly empty and stripped)
    pose_lines = [ln for ln in lines
                  if len(ln.split()) == 10 and "." in ln.split()[9]]
    for ln in pose_lines:
        el = ln.split()
        q = np.array(list(map(float, el[1:5])))
        t = np.array(list(map(float, el[5:8])))
        cam_id = int(el[8])
        name = el[9]
        w2c = np.eye(4)
        w2c[:3, :3] = _qvec2rotmat(q)
        w2c[:3, 3] = t
        out[name] = (w2c, cam_id)
    return out


def colmap_to_transforms(colmap_dir: str, out_path: Optional[str] = None,
                         aabb_scale: int = 16) -> dict:
    """Convert a COLMAP text model directory (cameras.txt + images.txt) to a
    NeRF transforms.json: c2w poses in the NeRF axis convention (flip y/z of
    the camera axes), scene recentered on the mean camera focus and rescaled so
    the average camera distance is ~4 (the instant-ngp normalization)."""
    cams = read_cameras_txt(os.path.join(colmap_dir, "cameras.txt"))
    imgs = read_images_txt(os.path.join(colmap_dir, "images.txt"))
    first_cam = cams[next(iter(cams))]
    fov_y = 2 * math.atan(first_cam["h"] / (2 * first_cam["fy"]))

    frames = []
    centers = []
    for name, (w2c, cam_id) in sorted(imgs.items()):
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1] *= -1  # COLMAP camera: +y down, +z forward -> NeRF: +y up, -z fwd
        c2w[:3, 2] *= -1
        centers.append(c2w[:3, 3].copy())
        frames.append((name, c2w))

    centers = np.stack(centers)
    center = centers.mean(0)
    scale = 4.0 / max(np.linalg.norm(centers - center, axis=-1).mean(), 1e-9)
    out_frames = []
    for name, c2w in frames:
        c2w[:3, 3] = (c2w[:3, 3] - center) * scale
        out_frames.append({"file_path": os.path.splitext(name)[0],
                           "transform_matrix": c2w.tolist()})
    data = {"camera_angle_y": fov_y,
            "camera_angle_x": 2 * math.atan(first_cam["w"] / (2 * first_cam["fx"])),
            "fl_x": first_cam["fx"], "fl_y": first_cam["fy"],
            "cx": first_cam["cx"], "cy": first_cam["cy"],
            "w": first_cam["w"], "h": first_cam["h"],
            "aabb_scale": aabb_scale, "frames": out_frames}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(data, f, indent=2)
    return data
