"""The fit_bust step of stage 1 (port of monohair_tpu/bustfit/pipeline.py):
the per-frame annotations where they are missing, the fit's targets from
their files, the full SMPL-X objective on the device, and the export of
model_tsfm.dat / model_tsfm_semantic.dat / final_template.obj.

The ladder of fallbacks:
  1. the full objective: landmarks + iris + matting/parsing masks + images
  2. landmarks only: landmark2d files but no masks/parsing
  3. the identity transform: no SMPL-X asset (wig captures), or no frame
     with landmarks
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..constants import BUST_TO_ORIGIN
from ..io.image_io import imread_gray, read_png
from ..ops.resize import resize_area
from .transforms import matrix_to_semantic, save_model_tsfm

# SMPL-X iris vertex ids (right, left)
IRIS_VERTEX_IDS = np.array([9503, 10049], np.int64)
# CelebAMask-HQ face-region labels
FACE_LABELS = (1, 2, 3, 4, 5, 6, 10, 11, 12, 13)
HAIR_LABEL = 17


def _write_identity(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    save_model_tsfm(os.path.join(out_dir, "model_tsfm.dat"), np.eye(4))
    sem = np.zeros(7, np.float32)
    sem[6] = 1.0
    sem.tofile(os.path.join(out_dir, "model_tsfm_semantic.dat"))


def _resize_to(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_AREA) of an (H, W) or
    (H, W, C) float32 image."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    x = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    y = resize_area(x, hw)[0]
    return (y[0] if img.ndim == 2 else y.permute(1, 2, 0)).numpy()


def gather_targets(root: str, names: List[str], image_size, sil_scale: int,
                   image_folder: str = "capture_images"):
    """FitTargets (numpy) from the optimize/ annotation files of the frames in
    `names`, and the indices of the frames kept: only frames with a landmark
    file of at least 68 points take part (a failed detector drops its frame)."""
    from .optimize import FitTargets

    H, W = image_size
    h, w = H // sil_scale, W // sil_scale
    opt = os.path.join(root, "optimize")
    keep, lmks, iris, masks, hairs, faces_m, images = [], [], [], [], [], [], []
    have_masks = True
    for i, name in enumerate(names):
        lp = os.path.join(opt, "landmark2d", name + ".txt")
        if not os.path.exists(lp):
            continue
        k = np.loadtxt(lp, ndmin=2).astype(np.float32)
        if k.shape[0] < 68:
            continue
        keep.append(i)
        lmks.append(k[:68, [1, 0]])            # txt is (x, y) -> (row, col)
        ip = os.path.join(opt, "iris", name + ".txt")
        if os.path.exists(ip):
            ir = np.loadtxt(ip, ndmin=2).astype(np.float32)
            ok = ir.shape == (2, 3) and (ir[:, 2] > 0).all()
            iris.append(ir[:, [1, 0]] if ok else None)
        else:
            iris.append(None)
        mp = os.path.join(opt, "matting", name + ".png")
        pp = os.path.join(opt, "face_parsing", name + ".png")
        if os.path.exists(mp) and os.path.exists(pp):
            rgba = read_png(mp)
            alpha = rgba[..., 3].astype(np.float32) / 255.0
            mask = (alpha > 0.5).astype(np.float32)
            sem = imread_gray(pp)
            skin_cloth = np.ones_like(mask)
            skin_cloth[sem == HAIR_LABEL] = 0.0
            skin_cloth[alpha < 100 / 255.0] = 0.0
            hair = mask * (1.0 - skin_cloth)
            face = np.isin(sem, FACE_LABELS).astype(np.float32)
            masks.append(_resize_to(mask, (h, w)))
            hairs.append(_resize_to(hair, (h, w)))
            faces_m.append(_resize_to(face, (h, w)))
            images.append(_resize_to(rgba[..., :3].astype(np.float32) / 255.0, (h, w)))
        else:
            have_masks = False
    if not keep:
        return None, []
    iris_px = np.stack(iris) if all(x is not None for x in iris) else None
    tgt = FitTargets(
        lmk_px=np.stack(lmks), iris_px=iris_px,
        mask=np.stack(masks) if have_masks and masks else None,
        hair_mask=np.stack(hairs) if have_masks and hairs else None,
        face_mask=np.stack(faces_m) if have_masks and faces_m else None,
        image=np.stack(images) if have_masks and images else None)
    return tgt, keep


def export_fit(out_dir: str, model, params, losses) -> None:
    """model_tsfm.dat, model_tsfm_semantic.dat, final_template.obj (in the
    bust frame) and fit_losses.txt; the identity when the fit is not finite
    (later stages must not inherit NaNs)."""
    from ..io.mesh_io import save_obj
    from .optimize import (default_init_pose, free_joint_mask, model_tsfm_matrix,
                           posed_vertices)

    with torch.no_grad():
        tsfm = model_tsfm_matrix(params).cpu().numpy()
    if not np.isfinite(tsfm).all():
        print("[bust_fit] non-finite fit result; exporting identity "
              "(downstream stages must not inherit NaNs)")
        _write_identity(out_dir)
        return
    save_model_tsfm(os.path.join(out_dir, "model_tsfm.dat"), tsfm)
    matrix_to_semantic(tsfm).tofile(os.path.join(out_dir, "model_tsfm_semantic.dat"))
    if len(model.faces):
        dev = model.device
        init_pose = torch.as_tensor(default_init_pose(model.num_joints), device=dev)
        jm = torch.as_tensor(free_joint_mask(model.num_joints), device=dev)
        with torch.no_grad():
            verts = posed_vertices(model, params, init_pose, jm).cpu().numpy()
        save_obj(os.path.join(out_dir, "final_template.obj"), verts - BUST_TO_ORIGIN,
                 np.asarray(model.faces))
    np.savetxt(os.path.join(out_dir, "fit_losses.txt"), np.asarray(losses))


class FitProblem(NamedTuple):
    """The fit's inputs as run_bust_fit gathers them, on one device."""
    model: object              # SMPLXModel
    cameras: object            # Cameras of the frames kept
    image_size: tuple
    targets: object            # FitTargets on the device
    lmk_ids: np.ndarray
    iris_ids: Optional[np.ndarray]
    tex_model: object          # FlameTex or None
    sil_scale: int
    frames: int


def load_fit_problem(args: Config, device="cuda") -> Optional[FitProblem]:
    """The SMPL-X model, the cameras and targets of the frames with landmark
    files, the landmark/iris ids and the texture model, on `device`; None
    when no frame has landmarks."""
    from ..io.cameras_io import load_cam_params, subsample_views
    from .optimize import FitTargets
    from .smplx import load_smplx_npz
    from .texture import load_flame_tex

    root = args.data.root
    bf = args.get("bustfit", {}) or {}
    model = load_smplx_npz(bf.get("smplx_model", "assets/smplx/SMPLX_NEUTRAL.npz"),
                           num_betas=int(bf.get("n_shape", 10)),
                           num_expr=int(bf.get("n_exp", 10)), device=device)
    names, cams = load_cam_params(os.path.join(root, args.image_camera_path), device)
    names, cams = subsample_views(names, cams, os.path.join(root, "capture_images"))
    image_size = tuple(args.data.image_size)
    sil_scale = int(bf.get("sil_scale", 8))
    targets, keep = gather_targets(root, names, image_size, sil_scale)
    if targets is None:
        return None
    lmk_ids = np.load(bf.get("landmark_vertex_ids", "assets/smplx/landmark_vertex_ids.npy"))
    tex_model = None
    if targets.image is not None:
        tex_path = bf.get("flame_tex")
        tex_model = load_flame_tex(tex_path if tex_path and os.path.exists(tex_path) else None,
                                   model.v_template.shape[0], n_tex=int(bf.get("n_tex", 50)),
                                   device=device)
    # the iris only when the model has the SMPL-X iris vertices
    iris_ids = IRIS_VERTEX_IDS if model.v_template.shape[0] > int(IRIS_VERTEX_IDS.max()) \
        else None
    return FitProblem(model, cams[np.asarray(keep)], image_size,
                      FitTargets(*targets).to(device), lmk_ids,
                      iris_ids if targets.iris_px is not None else None, tex_model,
                      sil_scale, len(keep))


def run_bust_fit(args: Config, device="cuda") -> dict:
    """The step on `device`: returns {"annotations": each step's status,
    "frames", "iters", "losses", "fit_s": the fit's seconds} (less for the
    identity fallbacks)."""
    from ..ops import exact_f32
    from ..segment.annotations import AnnotationProcessor, default_backends
    from .optimize import fit_bust_full

    root = args.data.root
    bf = args.get("bustfit", {}) or {}
    out_dir = os.path.join(root, "optimize")
    os.makedirs(out_dir, exist_ok=True)
    if not os.path.exists(bf.get("smplx_model", "assets/smplx/SMPLX_NEUTRAL.npz")):
        print("[bust_fit] SMPL-X asset not found; writing identity model_tsfm "
              "(wig mode: run the bust fit with the asset for human captures)")
        _write_identity(out_dir)
        return {}
    if torch.device(device).type == "cuda":
        exact_f32()
    status = AnnotationProcessor(root, backends=default_backends(args, device)).run()
    print(f"[bust_fit] annotations: {status}", flush=True)
    problem = load_fit_problem(args, device)
    if problem is None:
        print("[bust_fit] no frames with landmarks; writing identity model_tsfm")
        _write_identity(out_dir)
        return {"annotations": status}
    iters = int(args.get("optimize", {}).get("iter", 2000))
    t = time.perf_counter()
    params, losses = fit_bust_full(
        problem.model, problem.cameras, problem.image_size, problem.targets, problem.lmk_ids,
        iris_vertex_ids=problem.iris_ids, tex_model=problem.tex_model, iters=iters,
        sil_scale=problem.sil_scale, log_every=200)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    print(f"[bust_fit] {iters} iterations over {problem.frames} frames in {fit_s:.2f}s; "
          f"losses: {losses}", flush=True)
    export_fit(out_dir, problem.model, params, losses)
    return {"annotations": status, "frames": problem.frames, "iters": iters,
            "losses": losses, "fit_s": fit_s}
