"""run_ngp stage: train the coarse NeRF, render the 16 fixed views, export and
convert the coarse mesh (port of monohair_tpu/nerf/pipeline.py; reference
prepare_data.py:90-119, headless: the key frame is picked by
poses.auto_key_frame).

Split in two halves so that the export can run on given weights:
``train_ngp`` (key frame, dataset, field, train_nerf) and ``export_ngp``
(the fixed-view renders, with ngp.render_video the fly-through
<root>/ngp_video.mp4, the density grid, marching tetrahedra, the NeRF -> MVS
conversion). The JAX stage's TPU-only knobs (ngp.scan_block,
ngp.sync_every, ngp.use_remat, and its platform_limits shape asserts) may
stay in a config and have no effect here. The fly-through goes through the
port's mp4v encoder (io/video.py) where the JAX package uses OpenCV's.
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import Config
from ..io.image_io import write_png
from ..io.mesh_io import save_obj
from ..io.video import VideoWriter
from .marching import marching_tetrahedra
from .ngp import density_grid
from .poses import (auto_key_frame, convert_mesh_nerf_to_mvs, load_base_cam,
                    ngp_pose_to_nerf_c2w)
from .train import load_nerf_dataset, render_image, train_nerf

# The shipped budget (the JAX package's single definition, which its bench,
# tools and case configs read): 4000 steps of 4096 rays x 64 uniform
# samples, a 256^3 density export at bound 1.5 meshed at iso 3.0, the
# Fourier field.
DEFAULT_TRAIN_STEPS = 4000
DEFAULT_RAYS_PER_BATCH = 4096
DEFAULT_USE_OCCUPANCY = False
DEFAULT_MC_THRESH = 3.0
DEFAULT_MESH_RES = 256
DEFAULT_MESH_BOUND = 1.5
DEFAULT_FIELD = "fourier"
INIT_SEED = 0        # the JAX stage initialises from PRNGKey(0)


def make_field(kind: str, device="cuda", generator: Optional[torch.Generator] = None
               ) -> Tuple[nn.Module, float, float]:
    """(field, tv_weight, lr) of a field kind, initialised on `device` from
    `generator` (seeded with INIT_SEED on `device` when not given). Grid
    fields train at 1e-2 (instant-ngp's rate); the Fourier MLP at 1e-3, where
    the JAX package measured it converging (it diverges at 1e-2)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(INIT_SEED)
    kw = dict(generator=generator, device=device)
    if kind == "dense":
        from .dense_grid import DenseGridField
        return DenseGridField(**kw), 1e-4, 1e-2
    if kind == "fourier":
        from .fourier import FourierField
        return FourierField(**kw), 0.0, 1e-3
    from .ngp import NGPField
    return NGPField(**kw), 0.0, 1e-2


def camera_path_poses(base_cam_path: str, H: int = 720, frames_per_seg: int = 12
                      ) -> List[Tuple[np.ndarray, float]]:
    """(c2w, focal) of every frame of the fly-through along an NGP camera path:
    slerp between the path's quaternions, lerp of T and fov, `frames_per_seg`
    frames from each pose up to (not including) the next."""
    from scipy.spatial.transform import Rotation, Slerp
    quats, trans, fovs = load_base_cam(base_cam_path)
    poses = []
    for i in range(len(quats) - 1):
        slerp = Slerp([0, 1], Rotation.from_quat([quats[i], quats[i + 1]]))
        for t in np.linspace(0.0, 1.0, frames_per_seg, endpoint=False):
            tr = (1 - t) * np.asarray(trans[i]) + t * np.asarray(trans[i + 1])
            fov = (1 - t) * fovs[i] + t * fovs[i + 1]
            c2w = ngp_pose_to_nerf_c2w(slerp(t).as_quat(), tr)
            poses.append((c2w, H / 2.0 / math.tan(math.radians(fov) / 2.0)))
    return poses


def render_camera_path_video(field: nn.Module, base_cam_path: str, out_path: str,
                             H: int = 720, W: int = 1280, frames_per_seg: int = 12,
                             fps: int = 24, background=None) -> int:
    """Render the fly-through along the camera path on the field's device and
    write it as an mp4v MP4 (instant-ngp's run.py video mode, run.py:307-341;
    the JAX package's render_camera_path_video). Frames are quantised as the
    reference does, by truncation. Returns the number of frames."""
    with VideoWriter(out_path, fps, (W, H)) as writer:
        for c2w, focal in camera_path_poses(base_cam_path, H, frames_per_seg):
            rgb, _ = render_image(field, c2w, H, W, focal, focal, W / 2, H / 2,
                                  background=background)
            writer.write((np.clip(rgb, 0, 1)[..., ::-1] * 255).astype(np.uint8))
        return writer.frames


def ngp_options(args: Config) -> dict:
    return args.get("ngp") or {}


def train_ngp(args: Config, device="cuda"
              ) -> Tuple[nn.Module, List[float], Optional[torch.Tensor]]:
    """Pick the key frame if the case has none, load colmap/images and train
    the configured field: (field, losses at the log points, occupancy grid
    or None)."""
    colmap_dir = os.path.join(args.data.root, "colmap")
    if not os.path.exists(os.path.join(colmap_dir, "key_frame.json")):
        auto_key_frame(colmap_dir, args.camera_path)
    ds = load_nerf_dataset(os.path.join(colmap_dir, "transforms.json"),
                           os.path.join(colmap_dir, "images"))
    ngp = ngp_options(args)
    steps = int(ngp.get("train_steps", DEFAULT_TRAIN_STEPS))
    field, tv_weight, lr = make_field(str(ngp.get("field", DEFAULT_FIELD)), device)
    field, losses, occ_grid = train_nerf(
        ds, field, steps=steps, lr=float(ngp.get("lr", lr)),
        tv_weight=float(ngp.get("tv_weight", tv_weight)),
        use_occupancy=bool(ngp.get("use_occupancy", DEFAULT_USE_OCCUPANCY)),
        occ_resolution=int(ngp.get("occ_resolution", 128)),
        rays_per_batch=int(ngp.get("rays_per_batch", DEFAULT_RAYS_PER_BATCH)),
        verbose=True, background=ngp.get("background"),
        log_every=int(ngp.get("log_every", 100)))
    print(f"[ngp] trained {steps} steps, loss curve: {losses}", flush=True)
    return field, losses, occ_grid


def export_ngp(args: Config, field: nn.Module, occ_grid: Optional[torch.Tensor] = None
               ) -> Dict[str, float]:
    """The 16 fixed-view renders (trainning_images/capture_images/NNN.png and
    imgs/NNN/origin.png at infer_inner.render_size), with ngp.render_video
    the fly-through <root>/ngp_video.mp4 (720x1280, 24 fps), the density
    grid, marching tetrahedra -> colmap/base.obj (NeRF frame) and
    ours/colmap_points.obj (MVS frame). Returns each part's wall seconds."""
    root = args.data.root
    colmap_dir = os.path.join(root, "colmap")
    ngp = ngp_options(args)
    background = ngp.get("background")
    seconds = {}
    t0 = time.perf_counter()
    quats, trans, fovs = load_base_cam(os.path.join(colmap_dir, "base_cam.json"))
    shot_dir = os.path.join(root, "trainning_images/capture_images")
    os.makedirs(shot_dir, exist_ok=True)
    # the MVS render size: DeepMVSHair reads the same imgs/ (portrait 1280x720)
    H, W = args.get("infer_inner", {}).get("render_size", (1280, 720))
    for i, (q, t, fov) in enumerate(zip(quats, trans, fovs)):
        c2w = ngp_pose_to_nerf_c2w(q, t)
        fy = H / 2.0 / math.tan(math.radians(fov) / 2.0)
        rgb, _ = render_image(field, c2w, H, W, fy, fy, W / 2, H / 2, occ_grid=occ_grid,
                              background=background)
        name = "%03d" % i
        write_png(os.path.join(shot_dir, name + ".png"),
                  (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        view_dir = os.path.join(root, "imgs", name)
        os.makedirs(view_dir, exist_ok=True)
        shutil.copyfile(os.path.join(shot_dir, name + ".png"),
                        os.path.join(view_dir, "origin.png"))
    seconds["render"] = time.perf_counter() - t0

    if ngp.get("render_video"):
        t0 = time.perf_counter()
        render_camera_path_video(field, os.path.join(colmap_dir, "base_cam.json"),
                                 os.path.join(root, "ngp_video.mp4"), background=background)
        seconds["video"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = int(ngp.get("mesh_resolution", DEFAULT_MESH_RES))
    bound = DEFAULT_MESH_BOUND
    grid = density_grid(field, res, bound=bound)
    seconds["density"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    thresh = float(ngp.get("marching_cubes_density_thresh", DEFAULT_MC_THRESH))
    verts_g, faces = marching_tetrahedra(grid, thresh)
    seconds["marching"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    verts_nerf = verts_g / (res - 1) * (2 * bound) - bound
    save_obj(os.path.join(colmap_dir, "base.obj"), verts_nerf, faces)
    verts_mvs = convert_mesh_nerf_to_mvs(verts_nerf, colmap_dir, args.camera_path)
    os.makedirs(os.path.join(root, "ours"), exist_ok=True)
    save_obj(os.path.join(root, "ours/colmap_points.obj"), verts_mvs, faces)
    seconds["save_meshes"] = time.perf_counter() - t0
    return seconds


def run_ngp_stage(args: Config, device="cuda") -> Dict[str, float]:
    """Train, then export; prints and returns each part's wall seconds
    (train, render, video with ngp.render_video, density, marching,
    save_meshes)."""
    t0 = time.perf_counter()
    field, _, occ_grid = train_ngp(args, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = {"train": time.perf_counter() - t0}
    seconds.update(export_ngp(args, field, occ_grid))
    print("[ngp] " + ", ".join(f"{k} {v:.3f}s" for k, v in seconds.items()), flush=True)
    return seconds
