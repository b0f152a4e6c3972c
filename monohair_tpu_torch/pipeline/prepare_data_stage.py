"""Stage 1 — data preparation (port of
monohair_tpu/pipeline/prepare_data_stage.py; reference prepare_data.py :36-184).

Sub-steps (each gated by a config flag, idempotent over the case dir):
  select_images  — per-interval sharpest frame by Laplacian variance
  process_camera — 16 fixed NGP views + per-capture-image MVS poses
  run_ngp        — the coarse NeRF: train, 16 fixed-view renders, the mesh
                   colmap/base.obj and ours/colmap_points.obj (nerf/pipeline.py)
  fit_bust       — the SMPL-X bust fit (bustfit/pipeline.py): annotations,
                   optimize/model_tsfm.dat, the root copies and Bust/
  process_bust   — transform bust/scalp meshes by the fitted model_tsfm
  render_depth   — colmap-mesh depth maps for every capture view
  process_imgs   — hair segmentation masks + Gabor orientation/confidence

With fit_bust off, Bust/ and model_tsfm.dat are read from the case
directory; with run_ngp off, so is ours/colmap_points.obj.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import Config
from ..constants import BUST_TO_ORIGIN
from ..io.cameras_io import load_cam_params, subsample_views
from ..io.image_io import (encode_orientation_image, imread_gray, imread_rgb, imwrite,
                           is_jpeg)
from ..io.mesh_io import load_obj
from ..ops import exact_f32
from ..ops.resize import bgr_to_gray, laplacian_variance
from ..render import render_bust_hair_depth

def frame_sharpness(path: str, device="cuda") -> float:
    """cv2.Laplacian(cvtColor(imread(path), BGR2GRAY), CV_64F).var()."""
    rgb = torch.as_tensor(imread_rgb(path), device=device)
    return float(laplacian_variance(bgr_to_gray(rgb.flip(-1))))


def select_sharpest_frames(raw_root: str, out_root: str, interval: int,
                           device="cuda") -> List[str]:
    """Keep the sharpest frame (max Laplacian variance) of every `interval`
    frames (prepare_data.py:56-72)."""
    files = sorted(os.listdir(raw_root),
                   key=lambda x: int(x.split(".")[0].split("_")[-1]))
    os.makedirs(out_root, exist_ok=True)
    kept = []
    best, best_file = 0.0, None
    for i, f in enumerate(files):
        sharp = frame_sharpness(os.path.join(raw_root, f), device)
        if sharp > best:
            best, best_file = sharp, f
        if (i + 1) % interval == 0:
            shutil.copyfile(os.path.join(raw_root, best_file),
                            os.path.join(out_root, best_file))
            kept.append(best_file)
            best, best_file = 0.0, None
    return kept


def process_images(root: str, image_folder: str = "capture_images",
                   device="cuda") -> None:
    """Gabor orientation + confidence for every capture image
    (GaborFilter.batch_generate :231-237): writes best_ori/<img> (degrees),
    conf/<img>, Ori/<img> (color), under the frame's own name: a JPEG frame's
    best_ori/ and Ori/ at quality 100, its conf/ at cv2's default 95."""
    from ..ops.gabor import orientation_maps

    img_dir = os.path.join(root, image_folder)
    for sub in ("best_ori", "conf", "Ori"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for f in sorted(os.listdir(img_dir)):
        gray = torch.as_tensor(imread_gray(os.path.join(img_dir, f)), device=device)
        two, angle, conf = (x.cpu().numpy() for x in orientation_maps(gray.float() / 255.0))
        q = 100 if is_jpeg(f) else None
        imwrite(os.path.join(root, "best_ori", f), encode_orientation_image(angle), q)
        imwrite(os.path.join(root, "conf", f), np.clip(conf * 255, 0, 255).astype(np.uint8))
        ori01 = (two + 1.0) / 2.0
        color = np.concatenate([np.ones_like(ori01[..., :1]), ori01], -1)
        imwrite(os.path.join(root, "Ori", f), (color * 255).astype(np.uint8), q)


def promote_fit_artifacts(args: Config) -> None:
    """Copy the bust fit's outputs up to the case root and build Bust/ from the
    fitted template (prepare_data.py:127-140): model_tsfm[_semantic].dat at
    the root, then bust_long/flame_bust/scalp meshes cut from
    optimize/final_template.obj. Nothing more in wig mode (no fitted
    template): process_bust then falls back to the identity."""
    root = args.data.root
    opt = os.path.join(root, "optimize")
    for f in ("model_tsfm.dat", "model_tsfm_semantic.dat"):
        src = os.path.join(opt, f)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(root, f))
    tmpl = os.path.join(opt, "final_template.obj")
    if not os.path.exists(tmpl):
        return
    bf = args.get("bustfit", {}) or {}
    bust_root = os.path.join(root, "Bust")
    os.makedirs(bust_root, exist_ok=True)
    verts, faces = load_obj(tmpl)
    from ..bustfit.scalp import cut_bust_long, extract_flame_bust, extract_scalp
    cut_bust_long(verts, faces, os.path.join(bust_root, "bust_long.obj"),
                  y_cut=float(bf.get("bust_cut_y", -0.6)))
    flame_tmpl = bf.get("flame_template", "assets/data/head_template.obj")
    flame_ids = bf.get("flame_vertex_ids", "assets/data/SMPL-X__FLAME_vertex_ids.npy")
    scalp_mask = bf.get("scalp_mask", "assets/data/scalp_mask.png")
    if os.path.exists(flame_ids) and os.path.exists(flame_tmpl):
        extract_flame_bust(verts, flame_ids, flame_tmpl,
                           os.path.join(bust_root, "flame_bust.obj"))
        if os.path.exists(scalp_mask):
            ids = np.load(flame_ids)
            extract_scalp(flame_tmpl, scalp_mask, os.path.join(bust_root, "scalp.obj"),
                          verts_override=verts[ids])


def run_prepare_data(args: Config, device="cuda") -> Dict[str, float]:
    """Run the enabled steps on `device`; returns each step's wall seconds.
    On the card, matmuls and convolutions stay in full f32 (the segmentation
    nets' convolutions would take TF32 by cuDNN's default)."""
    if torch.device(device).type == "cuda":
        exact_f32()
    root = args.data.root
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(step: str) -> None:
        nonlocal t0
        if device != "cpu" and torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds[step] = time.perf_counter() - t0
        t0 = time.perf_counter()

    if args.prepare_data.select_images:
        select_sharpest_frames(os.path.join(root, "colmap/images"),
                               os.path.join(root, "capture_images"),
                               args.data.frame_interval, device)
        lap("select_images")

    if args.prepare_data.process_camera:
        from ..nerf.poses import (generate_base_cam_from_key_frame,
                                  generate_mvs_pose_from_base_cam)
        colmap_dir = os.path.join(root, "colmap")
        generate_base_cam_from_key_frame(colmap_dir, args.camera_path,
                                         os.path.join(colmap_dir, "base_cam.json"))
        select_files = [f[:-4] for f in os.listdir(os.path.join(root, "capture_images"))]
        generate_mvs_pose_from_base_cam(colmap_dir, select_files, args.camera_path,
                                        image_size=args.data.image_size)
        os.makedirs(os.path.join(root, "ours"), exist_ok=True)
        shutil.copyfile(os.path.join(colmap_dir, "cam_params.json"),
                        os.path.join(root, "ours", "cam_params.json"))
        lap("process_camera")

    if args.prepare_data.run_ngp:
        from ..nerf import pipeline as ngp_pipeline
        ngp_pipeline.run_ngp_stage(args, device)
        lap("run_ngp")

    if args.prepare_data.get("fit_bust"):
        from ..bustfit.pipeline import run_bust_fit
        run_bust_fit(args, device)
        promote_fit_artifacts(args)
        lap("fit_bust")

    if args.prepare_data.process_bust:
        from ..bustfit.transforms import process_bust_meshes
        process_bust_meshes(args)
        lap("process_bust")

    if args.prepare_data.render_depth:
        # colmap-mesh depth for the 16 fixed views (imgs/) and for every
        # capture view (render_depth/<view>.npy) — prepare_data.py:161-176
        colmap_path = os.path.join(root, "ours/colmap_points.obj")
        cv_verts, cv_faces = load_obj(colmap_path)
        if len(cv_verts) == 0:
            raise RuntimeError(
                f"{colmap_path} is empty — the coarse NeRF produced no "
                "density above ngp.marching_cubes_density_thresh. Train "
                "longer (ngp.train_steps) or lower the threshold.")
        cv_verts = cv_verts + BUST_TO_ORIGIN
        bust_path = os.path.join(root, "ours/bust_long_tsfm.obj")
        bust_v = bust_f = None
        if os.path.exists(bust_path):
            bust_v, bust_f = load_obj(bust_path)
            bust_v = bust_v + BUST_TO_ORIGIN
        names, cams = load_cam_params(args.camera_path, device)
        names, cams = subsample_views(names, cams)
        render_bust_hair_depth(cams, names, cv_verts, cv_faces,
                               save_root=os.path.join(root, "imgs"),
                               image_size=(1280, 720),
                               bust_vertices=bust_v, bust_faces=bust_f)
        names2, cams2 = load_cam_params(os.path.join(root, "ours", "cam_params.json"),
                                        device)
        names2, cams2 = subsample_views(names2, cams2,
                                        os.path.join(root, "capture_images"))
        H, W = args.data.image_size
        render_bust_hair_depth(cams2, names2, cv_verts, cv_faces,
                               save_root=os.path.join(root, "render_depth"),
                               image_size=(H, W), capture_imgs=True)
        lap("render_depth")

    if args.prepare_data.process_imgs:
        from ..segment.pipeline import calculate_masks
        calculate_masks(args, device)
        lap("calculate_masks")
        process_images(root, device=device)
        lap("process_images")
    print(f"[prepare_data] done in {sum(seconds.values()):.1f}s: "
          + ", ".join(f"{k} {v:.2f}s" for k, v in seconds.items()), flush=True)
    return seconds
