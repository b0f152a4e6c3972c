"""Synthetic scenes for driving stages 2 to 4 without capture data, in numpy.

- The ``synthwig`` case: 24 ring cameras around 24 vertical strands (a wig of
  direction (0, -1, 0)), its 128x128 observation maps, a coarse tube mesh, a
  scalp cap and a bust plate, written as a case directory with the port's own
  PNG/OBJ/JSON writers. Same geometry as tests/make_synthetic_case.py and
  tests/test_e2e_synthetic.py (ring_cameras, make_wig).
- The full-width head scene of bench.py's stage-2 benchmark: 16 ring cameras at
  1920x1080 looking at a head sphere whose hair follows a swirl field
  (analytic_head_maps), and jittered samples on its shell (shell_points).
- The full-width field of bench.py's stage-4 benchmark: curved swirl strands
  voxelised into the 256x256x192 occ/ori grids (grow_field), with a scalp cap
  inside the hair shell (grow_scalp_cap).
- The capture case of tools/make_capture_case.py: an orbit of frames around an
  analytic head with a striped hair cap, its NeRF transforms, key frame and
  calibration rig, the head sphere standing in for the NeRF's mesh, and each
  frame's hair label and silhouette (write_capture_case), stage 1's inputs.
- The MVS nets' training scene (tools/make_mvs_cases.py): a wig of their
  training family on a 0.095-radius head, 16 ring cameras at NDC focal 2.6
  for 256x256 renders, its closed label grid and the occupancy queries the
  shipped margin was tuned on (mvs_train_*).

Everything is made from a seed; nothing is read from disk.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Tuple

import numpy as np

from .config import Config
from .constants import BUST_TO_ORIGIN, GRID_RESOLUTION, VOXEL_MIN, VOXEL_SIZE

HEAD_RADIUS = 0.09


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def ring_camera_list(num_views: int = 24, radius: float = 1.1, fx: float = 1.7,
                     fy: float = 1.7, height: float = 0.08) -> List[dict]:
    """cam_params.json-style entries of cameras on a ring, looking at the origin."""
    cam_list = []
    for v in range(num_views):
        a = 2 * math.pi * v / num_views
        eye = np.array([math.cos(a), height, math.sin(a)]) * radius
        fwd = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], 1)
        c2w[:3, 3] = eye
        cam_list.append({"file": f"{v:03d}", "ndc_prj": [fx, fy, 0.0, 0.0],
                         "pose": c2w.tolist()})
    return cam_list


def cameras_numpy(cam_list: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """(ndc (V,4), w2c (V,4,4)) float32, as Cameras.from_json_list builds them."""
    ndc = np.array([c["ndc_prj"] for c in cam_list], np.float64)
    c2w = np.array([c["pose"] for c in cam_list], np.float64)
    return ndc.astype(np.float32), np.linalg.inv(c2w).astype(np.float32)


def project_np(ndc: np.ndarray, w2c: np.ndarray, pts: np.ndarray, H: int, W: int
               ) -> np.ndarray:
    """(V, N, 2) continuous (row, col) pixels of (N, 3) world points, float32."""
    cam = np.einsum("vij,nj->vni", w2c[:, :3, :3], pts.astype(np.float32)) \
        + w2c[:, None, :3, 3]
    u = ndc[:, None, 0] * cam[..., 0] / cam[..., 2] + ndc[:, None, 2]
    v = ndc[:, None, 1] * cam[..., 1] / cam[..., 2] + ndc[:, None, 3]
    return np.stack([(v + 1.0) * 0.5 * H, (-u + 1.0) * 0.5 * W], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# synthwig
# ---------------------------------------------------------------------------

def make_wig(num_strands: int = 24, num_pts: int = 64, rng=None) -> List[np.ndarray]:
    """Vertical strands on a small circle, direction (0, -1, 0); consecutive
    points < 1 voxel (2.5 mm) apart so the true occupancy is a connected tube."""
    rng = rng or np.random.default_rng(0)
    strands = []
    for k in range(num_strands):
        a = 2 * math.pi * k / num_strands
        x = 0.05 * math.cos(a) + rng.normal() * 0.003
        z = 0.05 * math.sin(a) + rng.normal() * 0.003
        y = np.linspace(0.07, -0.07, num_pts)
        strands.append(np.stack([np.full(num_pts, x), y, np.full(num_pts, z)],
                                -1).astype(np.float32))
    return strands


def wig_grids(strands: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """(occ (X,Y,Z), world-frame ori (X,Y,Z,3)) float32 grids of world-space
    strands: the voxel of each segment's start (rounded, as voxel_indices)
    holds occupancy 1 and the segment's unit direction."""
    res = tuple(int(r) for r in GRID_RESOLUTION)
    occ = np.zeros(res, np.float32)
    ori = np.zeros(res + (3,), np.float32)
    for s in strands:
        v = np.round(((s[:-1] * np.array([1.0, -1.0, -1.0])) - VOXEL_MIN) / VOXEL_SIZE)
        idx = np.clip(v.astype(np.int64), 0, np.array(res) - 1)
        d = s[1:] - s[:-1]
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        occ[idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
        ori[idx[:, 0], idx[:, 1], idx[:, 2]] = d
    return occ, ori


def synthwig_config(data_root: str, case: str = "synthwig") -> Config:
    """The stage-2, -3 and -4 keys of configs/reconstruct/base.yaml with the
    synthwig overrides of tests/make_synthetic_case.py, built without YAML."""
    root = os.path.join(data_root, case)
    return Config({
        "yaml": None, "seed": 0, "name": "verify",
        "camera_path": f"{root}/ours/cam_params.json",
        "image_camera_path": "ours/cam_params.json",
        "output_root": "output", "save_path": "refine",
        "bbox_min": [-0.32, -0.32, -0.24], "vsize": 0.005,
        "bust_to_origin": [0.006, -1.644, 0.010],
        "data": {
            "root": data_root, "case": case, "image_size": [128, 128],
            "frame_interval": 1, "scalp_path": "ours/scalp_tsfm.obj",
            "bust_path": "ours/bust_long_tsfm.obj", "Ori2D_path": "best_ori",
            "Conf_path": "conf", "Occ3D_path": "ours/Occ3D.mat",
            "Ori3D_path": "ours/Ori3D.mat", "depth_path": "render_depth",
            "mask_path": "hair_mask", "raw_points_path": "ours/colmap_points.obj",
            "strands_path": "ours/world_str_raw.dat",
        },
        "infer_inner": {"render_data": True, "run_mvs": True, "render_size": [1280, 720]},
        "mvs": {
            "occ_model_path": "assets/DeepMVSHair/occ.pth",
            "ori_model_path": "assets/DeepMVSHair/ori.pth", "eval_vsize": 0.005,
            "eval_batch": 32768, "use_colmap_points": True, "occ_logit_margin": None,
        },
        "PMVO": {
            "num_sample_per_grid": 2, "patch_size": 3, "optimize": True,
            "filter_point": True, "visible_threshold": 1, "infer_inner": False,
            "genrate_ori_only": None, "threshold": 0.1, "conf_threshold": 0.4,
            "bf16_maps": False,
        },
        "HairGenerate": {
            "connect_threshold": 0.005, "grow_threshold": 0.7,
            "connect_dot_threshold": 0.7, "dist_to_root": 6, "connect_to_guide": None,
            "generate_segments": True, "connect_segments": True, "connect_scalp": True,
            "out_ratio": 0.3,
        },
        "scalp_diffusion": None, "check_strands": True,
    })


def write_synthwig_case(data_root: str, case: str = "synthwig", H: int = 128,
                        W: int = 128, num_views: int = 24) -> Config:
    """Write the synthwig case directory under data_root/case; returns its
    config (as synthwig_config)."""
    from .io.cameras_io import save_cam_params
    from .io.image_io import write_png
    from .io.mesh_io import save_obj

    root = os.path.join(data_root, case)
    rng = np.random.default_rng(0)
    cam_list = ring_camera_list(num_views)
    ndc, w2c = cameras_numpy(cam_list)
    strands = make_wig(rng=rng)
    names = [c["file"] for c in cam_list]

    os.makedirs(os.path.join(root, "capture_images"), exist_ok=True)
    for sub in ("best_ori", "conf", "hair_mask", "render_depth", "ours"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    save_cam_params(os.path.join(root, "ours/cam_params.json"), names, ndc,
                    np.linalg.inv(w2c))

    # per-view maps in the PMVO conventions
    pts = np.concatenate([s[:-1] for s in strands])
    nxt = np.concatenate([s[1:] for s in strands])
    rc_p = project_np(ndc, w2c, pts, H, W)
    d2 = project_np(ndc, w2c, nxt, H, W) - rc_p
    d2 /= np.maximum(np.linalg.norm(d2, axis=-1, keepdims=True), 1e-9)
    for v, name in enumerate(names):
        ori_img = np.zeros((H, W), np.uint8)
        conf_img = np.zeros((H, W), np.uint8)
        mask_img = np.zeros((H, W), np.uint8)
        rc = np.round(rc_p[v]).astype(int)
        ok = (rc[:, 0] >= 1) & (rc[:, 0] < H - 1) & (rc[:, 1] >= 1) & (rc[:, 1] < W - 1)
        # angle image: decode is theta=(180-g)/180*pi, vec=(sin t, cos t)=(drow, dcol)
        theta = np.arctan2(d2[v][ok, 0], d2[v][ok, 1]) % math.pi
        g = np.clip(180.0 - theta * 180.0 / math.pi, 0, 255).astype(np.uint8)
        r, c = rc[ok, 0], rc[ok, 1]
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                ori_img[r + dr, c + dc] = g
                conf_img[r + dr, c + dc] = 230
                mask_img[r + dr, c + dc] = 255
        write_png(os.path.join(root, "best_ori", name + ".png"), ori_img)
        write_png(os.path.join(root, "conf", name + ".png"), conf_img)
        write_png(os.path.join(root, "hair_mask", name + ".png"), mask_img)
        np.save(os.path.join(root, "render_depth", name + ".npy"),
                np.full((H, W, 3), 230.0, np.float32))
        write_png(os.path.join(root, "capture_images", name + ".png"),
                  np.zeros((H, W, 3), np.uint8))

    # coarse "colmap" mesh: a thin open tube of quads through the strand circle
    ring, rows = 24, 12
    vs, fs = [], []
    for y in np.linspace(0.075, -0.075, rows):
        for k in range(ring):
            a = 2 * math.pi * k / ring
            vs.append([0.05 * math.cos(a), y, 0.05 * math.sin(a)])
    for yi in range(rows - 1):
        for k in range(ring):
            a0 = yi * ring + k
            a1 = yi * ring + (k + 1) % ring
            b0 = (yi + 1) * ring + k
            b1 = (yi + 1) * ring + (k + 1) % ring
            fs.extend([[a0, a1, b0], [a1, b1, b0]])
    tube = np.array(vs) - BUST_TO_ORIGIN  # loader re-adds bust_to_origin
    save_obj(os.path.join(root, "ours/colmap_points.obj"), tube, np.array(fs))

    # scalp: small cap above the wig; bust: plate far below (kd-tree targets)
    cap_vs = [[0.05 * math.cos(2 * math.pi * k / ring), 0.075,
               0.05 * math.sin(2 * math.pi * k / ring)] for k in range(ring)]
    cap_vs.append([0.0, 0.09, 0.0])
    cap_fs = [[k, (k + 1) % ring, ring] for k in range(ring)]
    save_obj(os.path.join(root, "ours/scalp_tsfm.obj"),
             np.array(cap_vs) - BUST_TO_ORIGIN, np.array(cap_fs))
    plate = np.array([[-0.2, -0.25, -0.2], [0.2, -0.25, -0.2],
                      [0.2, -0.25, 0.2], [-0.2, -0.25, 0.2]]) - BUST_TO_ORIGIN
    save_obj(os.path.join(root, "ours/bust_long_tsfm.obj"), plate,
             np.array([[0, 1, 2], [0, 2, 3]]))
    return synthwig_config(data_root, case)


# ---------------------------------------------------------------------------
# the full-width head scene (bench.py stage 2)
# ---------------------------------------------------------------------------

def head_camera_list(num_views: int = 16) -> List[dict]:
    """bench.py's ring: eye height 0.1, radius 1.1, NDC focal (2.06, 1.16)."""
    return ring_camera_list(num_views, radius=1.1, fx=2.06, fy=1.16, height=0.1)


def swirl_direction(p: np.ndarray) -> np.ndarray:
    """Hair-direction field around the head: tangential swirl + downward pull,
    strength varying with height."""
    u = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    sw = np.stack([-u[..., 2], np.zeros_like(u[..., 0]), u[..., 0]], -1)
    sw /= np.maximum(np.linalg.norm(sw, axis=-1, keepdims=True), 1e-9)
    d = sw * (0.4 + 0.6 * u[..., 1:2]) + np.array([0.0, -0.8, 0.0])
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)


def analytic_head_maps(ndc: np.ndarray, w2c: np.ndarray, H: int, W: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per view, ray-trace the head sphere for depth/mask, and set each
    silhouette pixel's 2D orientation to the projected swirl-field direction at
    its surface point. Returns float32 (depth (V,H,W), ori2d (V,H,W,2),
    conf (V,H,W), mask (V,H,W))."""
    V = ndc.shape[0]
    rows, cols = np.meshgrid(np.arange(H, dtype=np.float32) + 0.5,
                             np.arange(W, dtype=np.float32) + 0.5, indexing="ij")
    u = -(cols / W * 2.0 - 1.0)
    v = rows / H * 2.0 - 1.0

    depth = np.full((V, H, W), 220.0, np.float32)
    ori2d = np.zeros((V, H, W, 2), np.float32)
    conf = np.full((V, H, W), 0.03, np.float32)
    mask = np.zeros((V, H, W), np.float32)
    for vi in range(V):
        fx, fy, cx, cy = (float(x) for x in ndc[vi])
        R = w2c[vi, :3, :3].astype(np.float64)            # world->cam rotation
        eye = -R.T @ w2c[vi, :3, 3].astype(np.float64)
        # cam-frame ray through each pixel at z=-1 (project inverse)
        dc = np.stack([-(u - cx) / fx, -(v - cy) / fy, -np.ones_like(u)], -1)
        dw = dc @ R                                        # world rays (R.T @ dc)
        dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
        b = dw @ eye
        disc = b * b - (eye @ eye - HEAD_RADIUS ** 2)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        p = eye[None, None] + dw * t[..., None]            # surface point
        z_cam = (p - eye) @ R[2]                           # camera z (<0)
        depth[vi][hit] = (-z_cam[hit]) / 2.0 * 255.0       # solver z255
        # project p + eps*dir to get the image-space orientation
        p2 = p + 1e-3 * swirl_direction(p)
        cam2 = (p2 - eye) @ R.T
        u2 = fx * cam2[..., 0] / cam2[..., 2] + cx
        v2 = fy * cam2[..., 1] / cam2[..., 2] + cy
        drow = (v2 - v) * 0.5 * H
        dcol = -(u2 - u) * 0.5 * W
        n = np.maximum(np.hypot(drow, dcol), 1e-9)
        sgn = np.where(drow < 0, -1.0, 1.0)                # angle in [0, pi)
        ori2d[vi, ..., 0] = np.where(hit, sgn * drow / n, 0.0)
        ori2d[vi, ..., 1] = np.where(hit, sgn * dcol / n, 0.0)
        conf[vi][hit] = 0.75 + 0.2 * np.cos(40.0 * np.arctan2(p[hit][:, 2], p[hit][:, 0]))
        mask[vi][hit] = 1.0
    return depth, ori2d, conf, mask


def shell_points(rng: np.random.Generator, n: int) -> np.ndarray:
    """Candidate samples on a jittered head-sphere shell: each view sees the
    near hemisphere, the far one is occluded."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = HEAD_RADIUS + rng.normal(size=(n, 1)) * 0.004
    return (d * r).astype(np.float32)


# ---------------------------------------------------------------------------
# the full-width field of stage 4 (bench.py's grow benchmark)
# ---------------------------------------------------------------------------

def curved_strand_batch(rng: np.random.Generator, count: int, length: int,
                        grid_shape=tuple(GRID_RESOLUTION), step: float = 1.1) -> np.ndarray:
    """(count, length, 3) voxel-space polylines integrating the swirl field
    around a head centred in the grid: curved, varied, not axis-aligned
    (bench.py curved_strand_batch)."""
    center = np.array([grid_shape[0] / 2, grid_shape[1] * 0.55, grid_shape[2] / 2])
    scale = grid_shape[0] * 0.28
    d = rng.normal(size=(count, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = center + d * (scale * (1.0 + rng.random((count, 1)) * 0.25))
    out = np.empty((count, length, 3))
    for i in range(length):
        out[:, i] = p
        w = swirl_direction((p - center) / scale)
        w += rng.normal(size=w.shape) * 0.08       # per-step waviness
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        p = p + w * step
    lo = np.array([1.0, 1.0, 1.0])
    hi = np.array(grid_shape, np.float64) - 2.0
    return np.clip(out, lo, hi)


def grow_field(rng: np.random.Generator, num_strands: int = 8000, length: int = 60,
               grid_shape=tuple(GRID_RESOLUTION)) -> Tuple[np.ndarray, np.ndarray]:
    """(occ, voxel-frame ori) float32 grids of `num_strands` curved strands,
    each segment's direction in the voxel of its start (bench.py
    bench_stage4_grow). With default_rng(0) and the defaults: 427,570
    occupied voxels."""
    occ = np.zeros(grid_shape, np.float32)
    ori = np.zeros(tuple(grid_shape) + (3,), np.float32)
    strands = curved_strand_batch(rng, num_strands, length, grid_shape)
    idx = np.round(strands[:, :-1]).astype(np.int64)
    seg_dir = strands[:, 1:] - strands[:, :-1]
    seg_dir /= np.linalg.norm(seg_dir, axis=-1, keepdims=True)
    ix, iy, iz = idx[..., 0].ravel(), idx[..., 1].ravel(), idx[..., 2].ravel()
    occ[ix, iy, iz] = 1.0
    ori[ix, iy, iz] = seg_dir.reshape(-1, 3)
    return occ, ori


def grow_head_world(grid_shape=tuple(GRID_RESOLUTION)) -> Tuple[np.ndarray, float]:
    """(centre, inner radius) of grow_field's hair shell in world coordinates."""
    center = np.array([grid_shape[0] / 2, grid_shape[1] * 0.55, grid_shape[2] / 2])
    world = (center * VOXEL_SIZE + VOXEL_MIN) * np.array([1.0, -1.0, -1.0])
    return world, grid_shape[0] * 0.28 * VOXEL_SIZE


def hair_shell_points(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3) float32 world points spread through grow_field's hair shell
    (0.9 to 1.35 of its inner radius): the MVS queries of that scene."""
    center, r = grow_head_world()
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (center + d * r * rng.uniform(0.9, 1.35, (n, 1))).astype(np.float32)


def grow_bust_mesh(rings: int = 96, sectors: int = 112) -> Tuple[np.ndarray, np.ndarray]:
    """A head ellipsoid inside grow_field's hair shell (world coordinates), as
    a UV mesh of 2 * rings * sectors faces less the poles' (21,280 with the
    defaults; SMPL-X's bust has 20,908). Returns (vertices float32, faces)."""
    center, r = grow_head_world()
    th = np.linspace(0.0, math.pi, rings + 1)[1:-1]
    ph = np.linspace(0.0, 2 * math.pi, sectors, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    verts = center + verts * r * np.array([0.85, 0.95, 0.9])
    last = len(verts) - 1
    faces = []
    for j in range(sectors):
        k = (j + 1) % sectors
        faces.append([0, 1 + k, 1 + j])
        faces.append([last, last - sectors + j, last - sectors + k])
    for i in range(rings - 2):
        a, b = 1 + i * sectors, 1 + (i + 1) * sectors
        for j in range(sectors):
            k = (j + 1) % sectors
            faces.extend([[a + j, a + k, b + j], [a + k, b + k, b + j]])
    return verts.astype(np.float32), np.array(faces, np.int64)


def grow_scalp_cap(grid_shape=tuple(GRID_RESOLUTION), radius: float = 0.92,
                   max_polar_deg: float = 70.0, rings: int = 24, sectors: int = 48
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A spherical cap over the top of grow_field's head (world up, voxel -y),
    inside its hair shell (`radius` of the shell's inner radius), as a scalp
    mesh in obj coordinates (world minus BUST_TO_ORIGIN, as the stage reads
    ours/scalp_tsfm.obj). Faces wind so that their normals point outward.
    Returns (vertices (V, 3) float64, faces (F, 3) int64)."""
    center = np.array([grid_shape[0] / 2, grid_shape[1] * 0.55, grid_shape[2] / 2])
    r = grid_shape[0] * 0.28 * radius
    verts = [center + np.array([0.0, -r, 0.0])]
    for i in range(1, rings + 1):
        th = math.radians(max_polar_deg) * i / rings
        for j in range(sectors):
            ph = 2 * math.pi * j / sectors
            verts.append(center + r * np.array([math.sin(th) * math.cos(ph), -math.cos(th),
                                                math.sin(th) * math.sin(ph)]))
    faces = [[0, 1 + j, 1 + (j + 1) % sectors] for j in range(sectors)]
    for i in range(rings - 1):
        a, b = 1 + i * sectors, 1 + (i + 1) * sectors
        for j in range(sectors):
            k = (j + 1) % sectors
            faces.extend([[a + j, b + j, b + k], [a + j, b + k, a + k]])
    verts, faces = np.array(verts), np.array(faces)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    inward = np.sum(np.cross(e1, e2) * (verts[faces].mean(1) - center), -1) < 0
    faces[inward] = faces[inward][:, [0, 2, 1]]
    # voxel -> world (the y/z flip is a rotation, so the winding stays outward)
    world = (verts * VOXEL_SIZE + VOXEL_MIN) * np.array([1.0, -1.0, -1.0])
    return world - BUST_TO_ORIGIN, faces


# ---------------------------------------------------------------------------
# the MVS nets' training scene (tools/make_mvs_cases.py, tools/tune_occ_threshold.py)
# ---------------------------------------------------------------------------

MVS_TRAIN_HEAD_RADIUS = 0.095
MVS_TRAIN_HEAD_CENTER = np.array([0.0, -0.02, 0.0])
MVS_TRAIN_RENDER_SIZE = (256, 256)


def mvs_train_camera_list(num_views: int = 16) -> List[dict]:
    """The ring the shipped occ/ori nets were trained on: radius 1.1, eye
    height 0.12, NDC focal 2.6, square 256x256 renders."""
    return ring_camera_list(num_views, radius=1.1, fx=2.6, fy=2.6, height=0.12)


def mvs_train_wig(rng: np.random.Generator, num_strands: int = 2000,
                  num_pts: int = 90) -> List[np.ndarray]:
    """One wig of the nets' training family (make_mvs_cases.make_varied_wig,
    unshifted): strands grown from the upper head sphere with a random curl,
    length, comb tilt and wave. World coordinates, float32."""
    head_r, head_c = MVS_TRAIN_HEAD_RADIUS, MVS_TRAIN_HEAD_CENTER
    curl = rng.uniform(0.0, 2.2)
    length = rng.uniform(0.10, 0.22)
    tilt = rng.uniform(-0.35, 0.35)
    wave = rng.uniform(0.0, 0.05)
    step = length / num_pts
    u = rng.normal(size=(num_strands, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    u[:, 1] = np.abs(u[:, 1]) * 1.6 + 0.4
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    p = head_c + u * head_r
    phase = rng.uniform(0, 2 * np.pi, num_strands)
    out = np.empty((num_strands, num_pts, 3), np.float32)
    tl = np.array([math.sin(tilt), 0.0, 0.0])
    for i in range(num_pts):
        out[:, i] = p
        r = p - head_c
        rn = r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-9)
        down = np.array([0.0, -1.0, 0.0]) + tl
        # 'down' in the local tangent plane near the scalp, free fall further out
        t = down - rn * (rn @ down)[..., None] * np.clip(1.5 - i / 30.0, 0, 1)
        swirl = np.stack([-rn[:, 2], np.zeros(num_strands), rn[:, 0]], -1)
        t = t + curl * 0.4 * swirl * np.sin(phase + i * 0.15)[:, None]
        t += wave * np.sin(i * 0.45 + phase)[:, None] * np.stack(
            [np.cos(phase), np.zeros(num_strands), np.sin(phase)], -1)
        t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-9)
        p = p + t * step
    return [out[k] for k in range(num_strands)]


def mvs_train_head_mesh(subdiv: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """The training scenes' head sphere as a UV mesh (make_mvs_cases.head_mesh):
    (vertices float32, faces int64)."""
    verts, faces = uv_sphere(MVS_TRAIN_HEAD_RADIUS, rings=subdiv, sectors=2 * subdiv)
    return (verts + MVS_TRAIN_HEAD_CENTER).astype(np.float32), faces


def mvs_train_occupancy(strands: List[np.ndarray]) -> np.ndarray:
    """The training label grid of a wig: the voxels of its segment starts,
    closed with a 5-voxel kernel (ops.pool3d.close_volume) and joined with the
    raw voxels, as make_mvs_cases.py builds Occ3D.mat. (X, Y, Z) float32 in
    {0, 1}."""
    import torch

    from .coords import voxel_indices
    from .ops.pool3d import close_volume
    idx = voxel_indices(torch.from_numpy(np.concatenate([s[:-1] for s in strands]))).long()
    occ = torch.zeros(tuple(int(r) for r in GRID_RESOLUTION))
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
    return torch.maximum(close_volume(occ, 5), occ).numpy()


def mvs_train_queries(occ: np.ndarray, rng: np.random.Generator, kernel: int = 5
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The occupancy queries the nets' margin was tuned on: the training
    sampler's points (mvs.sampling.sample_occ_training_points, drawn from
    `rng`) in world space. Returns (world points (N, 3) float32, labels (N,)
    int32)."""
    import torch

    from .coords import voxel_to_world
    from .mvs.sampling import sample_occ_training_points
    pts_v, labels = sample_occ_training_points(occ, kernel, seed=rng)
    return voxel_to_world(torch.from_numpy(pts_v)).numpy(), labels


# ---------------------------------------------------------------------------
# the capture case (tools/make_capture_case.py): stage 1's inputs
# ---------------------------------------------------------------------------

CAPTURE_FOV_Y = 24.0            # deg; head ~55% of frame height
CAPTURE_CAM_R_NERF = 6.67       # -> MVS ring radius ~1.10
CAPTURE_HEAD_R_NERF = 0.72      # -> MVS head radius ~0.119
CAPTURE_HAIR_POLAR_DEG = 70.0   # hair cap: polar angle < this
_SKIN = np.array([0.80, 0.62, 0.52])
_HAIR = np.array([0.23, 0.16, 0.10])
_BG = 0.92
_LIGHT = np.array([0.4, 0.7, 0.45]) / np.linalg.norm([0.4, 0.7, 0.45])


def capture_orbit_pose(a: float, elev: float = 0.12) -> np.ndarray:
    """NeRF-frame c2w of an orbit camera at azimuth a looking at the origin."""
    eye = np.array([math.cos(a), elev, math.sin(a)])
    eye = eye / np.linalg.norm(eye) * CAPTURE_CAM_R_NERF
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], 1)
    c2w[:3, 3] = eye
    return c2w


def capture_render_view(c2w: np.ndarray, f_pix: float, H: int, W: int):
    """Analytic lambertian head with a striped hair cap on a light background:
    (image (H, W, 3) in [0, 1], hair label (H, W) bool, head silhouette (H, W)
    bool)."""
    rows, cols = np.meshgrid(np.arange(H, dtype=np.float32) + 0.5,
                             np.arange(W, dtype=np.float32) + 0.5, indexing="ij")
    x = (cols - W / 2) / f_pix
    y = -(rows - H / 2) / f_pix
    d = np.stack([x, y, -np.ones_like(x)], -1) @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    b = d @ o
    disc = b * b - (o @ o - CAPTURE_HEAD_R_NERF ** 2)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    p = o[None, None] + d * t[..., None]
    n = p / CAPTURE_HEAD_R_NERF
    shade = np.clip(n @ _LIGHT, 0.0, 1.0) * 0.75 + 0.25
    polar = np.degrees(np.arccos(np.clip(n[..., 1], -1.0, 1.0)))
    az = np.arctan2(n[..., 2], n[..., 0])
    stripes = 0.55 + 0.45 * np.sin(48.0 * az)          # combed-down texture
    img = np.full((H, W, 3), _BG, np.float32)
    hair = hit & (polar < CAPTURE_HAIR_POLAR_DEG)
    skin = hit & ~hair
    img[skin] = _SKIN[None] * shade[skin, None]
    img[hair] = _HAIR[None] * (shade[hair] * stripes[hair])[:, None]
    return img, hair, hit


def uv_sphere(radius: float, rings: int = 48, sectors: int = 96,
              max_polar_deg: float = 180.0) -> Tuple[np.ndarray, np.ndarray]:
    """A closed UV sphere at the origin, as tools/make_capture_case.py and
    tools/make_mvs_cases.py build it (or its cap above max_polar_deg, open at
    the rim): (vertices (V, 3) float64, faces (F, 3) int64)."""
    closed = max_polar_deg >= 180.0
    th = np.linspace(0, math.radians(max_polar_deg), rings + 1)[1:]
    th = th[:-1] if closed else th
    ph = np.linspace(0, 2 * math.pi, sectors, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], -1)
    poles = [[[0, -1, 0]]] if closed else []
    verts = np.concatenate([[[0, 1, 0]], ring.reshape(-1, 3)] + poles, 0)
    base, south = 1 + (len(th) - 1) * sectors, len(verts) - 1
    faces = []
    for j in range(sectors):
        faces.append([0, 1 + (j + 1) % sectors, 1 + j])
        if closed:
            faces.append([south, base + j, base + (j + 1) % sectors])
    for i in range(len(th) - 1):
        for j in range(sectors):
            a = 1 + i * sectors + j
            b = 1 + i * sectors + (j + 1) % sectors
            faces += [[a, b, a + sectors], [b, b + sectors, a + sectors]]
    return verts * radius, np.asarray(faces, np.int64)


# The capture scene is drawn with +y up, the MVS and bust frames' up, and the
# rig stands upright in the MVS frame: the key frame (frame 0's NGP pose) and
# rig view 0 (frame 0's MVS pose) then anchor the chain with the turn back
# from instant-ngp's axes (coords.nerf_to_ngp: NGP = (y, z, x) of NeRF) and a
# +1.5 translation, so every frame's MVS pose is its NeRF pose scaled by
# 0.33 / 2 about the origin. tools/make_capture_case.py writes the rig in
# NGP axes instead (its anchor turns nothing), which puts the scene's up, and
# the hair cap, at MVS +x, away from its bust, scalp and SMPL-X.


def capture_mvs_pose(c2w: np.ndarray) -> np.ndarray:
    """The MVS c2w that stage 1's pose chain gives a frame of NeRF pose `c2w`
    (the writer's rig and key frame): the same rotation, the translation
    scaled by 0.33 / 2."""
    from .coords import _NGP_SCALE
    m = np.eye(4)
    m[:3, :3] = np.asarray(c2w, np.float64)[:3, :3]
    m[:3, 3] = np.asarray(c2w, np.float64)[:3, 3] * _NGP_SCALE / 2.0
    return m


def capture_mesh_axes(v: np.ndarray) -> np.ndarray:
    """NeRF-frame points (N, 3) in the axes of instant-ngp's mesh export (NGP's
    order, NeRF's scale), which nerf.poses.convert_mesh_nerf_to_mvs takes."""
    return np.asarray(v)[:, [1, 2, 0]]


def capture_hair_cap_shares(case_root: str, image_size, cap_polar_deg: float = 50.0,
                            num: int = 20000) -> List[Tuple[str, float, float]]:
    """Per view of <case_root>/ours/cam_params.json: (view, the share of the
    true hair cap on the frame's hair label under PMVO's pixel lookup
    (camera.pixel_index_and_validity), the same under the renderer's GL flip
    (ops.rasterize._pixel_from_ndc, rounded)). The cap is `num` points spread
    evenly by area over the head sphere within cap_polar_deg of up (NeRF
    +y), in the axes convert_mesh_nerf_to_mvs takes (capture_mesh_axes),
    carried through the case's pose chain; each view counts the
    points that face its camera (the sphere hides the rest), and a point out
    of the frame counts as off the label."""
    import torch

    from .camera import pixel_index_and_validity, project
    from .io.cameras_io import load_cam_params
    from .io.image_io import read_png
    from .nerf.poses import convert_mesh_nerf_to_mvs
    from .ops.rasterize import _pixel_from_ndc

    H, W = image_size
    k = np.arange(num) + 0.5
    y = 1.0 - k / num * (1.0 - math.cos(math.radians(cap_polar_deg)))
    r, phi = np.sqrt(1.0 - y * y), k * math.pi * (3.0 - math.sqrt(5.0))
    cap = np.stack([r * np.cos(phi), y, r * np.sin(phi)], 1) * CAPTURE_HEAD_R_NERF
    colmap, calib = os.path.join(case_root, "colmap"), os.path.join(case_root,
                                                                    "calib_cam_params.json")
    pts = convert_mesh_nerf_to_mvs(capture_mesh_axes(np.concatenate([cap, np.zeros((1, 3))])),
                                   colmap, calib)
    pts, centre = pts[:-1], pts[-1]
    names, cams = load_cam_params(os.path.join(case_root, "ours", "cam_params.json"), "cpu")
    uv, _ = project(cams, torch.from_numpy((pts + BUST_TO_ORIGIN).astype(np.float32)))
    eyes = np.linalg.inv(cams.w2c.double().numpy())[:, :3, 3] - BUST_TO_ORIGIN
    out = []
    for v, name in enumerate(names):
        hair = read_png(os.path.join(case_root, "labels", "hair", name + ".png")) > 127
        facing = ((eyes[v] - pts) * (pts - centre)).sum(1) > 0
        rc_pmvo, off = pixel_index_and_validity(uv[v], (H, W))
        rc_gl = torch.round(_pixel_from_ndc(uv[v], (H, W))).long()
        off_gl = ((rc_gl[:, 0] < 0) | (rc_gl[:, 0] >= H) | (rc_gl[:, 1] < 0)
                  | (rc_gl[:, 1] >= W))
        shares = []
        for rc, outside in ((rc_pmvo, off), (rc_gl, off_gl)):
            rc = rc.numpy().clip(0, [H - 1, W - 1])
            on = hair[rc[:, 0], rc[:, 1]] & ~outside.numpy()
            shares.append(float(on[facing].mean()) if facing.any() else 0.0)
        out.append((name, *shares))
    return out


def capture_cap_share_of_points(case_root: str, points: np.ndarray, shell: float = 0.1
                                ) -> float:
    """The share of `points` (PMVO's frame: the MVS frame plus BUST_TO_ORIGIN,
    as pmvo.points.load_colmap_points gives them) on the true hair cap: within
    CAPTURE_HAIR_POLAR_DEG of up from the head's centre and within `shell`
    (relative) of the head's radius, both carried through the case's pose
    chain as capture_hair_cap_shares carries the cap; 0.0 for no points."""
    from .nerf.poses import convert_mesh_nerf_to_mvs

    centre, top = convert_mesh_nerf_to_mvs(
        capture_mesh_axes(np.array([[0.0, 0.0, 0.0], [0.0, CAPTURE_HEAD_R_NERF, 0.0]])),
        os.path.join(case_root, "colmap"),
        os.path.join(case_root, "calib_cam_params.json")) + BUST_TO_ORIGIN
    if len(points) == 0:
        return 0.0
    up = top - centre
    radius = float(np.linalg.norm(up))
    d = np.asarray(points, np.float64) - centre
    r = np.linalg.norm(d, axis=1)
    cos_polar = d @ (up / radius) / np.maximum(r, 1e-12)
    on = ((np.abs(r / radius - 1.0) <= shell)
          & (cos_polar >= math.cos(math.radians(CAPTURE_HAIR_POLAR_DEG))))
    return float(on.mean())


def capture_config(data_root: str, case: str, H: int, W: int, frame_interval: int,
                   modnet: str = None, parser: str = None) -> Config:
    """The capture case's config: synthwig_config's keys with the capture
    case's data, rig, stage-1 flags, the tool's PMVO keys and, when given, the
    hair-parser weights."""
    root = os.path.join(data_root, case)
    cfg = synthwig_config(data_root, case)
    cfg.data["image_size"] = [H, W]
    cfg.data["frame_interval"] = frame_interval
    cfg["camera_path"] = os.path.join(root, "calib_cam_params.json")
    cfg["name"] = "capture"
    cfg["prepare_data"] = Config({
        "select_images": True, "process_camera": True, "run_ngp": None,
        "fit_bust": None, "process_bust": True, "render_depth": True,
        "process_imgs": True})
    cfg["segment"] = Config({"modnet_flax": modnet, "parser_flax": parser,
                             "modnet_width": 1.0, "parser_width": 1.0})
    # scene metadata, not budget: the NeRF composites the backdrop behind the
    # volume, as configs/reconstruct/bigsynth.yaml sets it
    cfg["ngp"] = Config({"background": [_BG] * 3})
    # the tool's PMVO keys (tools/make_capture_case.py:349-354): synthwig's
    # conf_threshold of 0.4 suits its drawn maps, not Gabor's confidence on
    # these frames (on the hair label at 1280x720 its median is ~0.08)
    cfg.PMVO.update(patch_size=7, conf_threshold=0.1, threshold=0.05)
    return cfg


def write_capture_case(data_root: str, case: str = "capture", num_frames: int = 32,
                       H: int = 720, W: int = 1280, frame_interval: int = 2,
                       modnet: str = None, parser: str = None, ext: str = ".png") -> dict:
    """Write stage 1's inputs for an orbit of `num_frames` frames around the
    analytic head (tools/make_capture_case.py:41-80,156-250, without OpenCV):
    colmap/images/frame_XXXX<ext> (ext ".png", or ".JPG"/".jpg" for frames
    written as JPEG at quality 95 by the port's encoder), colmap/transforms.json,
    colmap/key_frame.json (frame 0's NGP pose), calib_cam_params.json (the rig: every 2nd frame's
    MVS pose, upright, see capture_mvs_pose), the
    head sphere as ours/colmap_points.obj (through the port's
    convert_mesh_nerf_to_mvs, standing in for the NeRF's mesh), a Bust/ head
    sphere and scalp cap, and labels/{hair,hit}/frame_XXXX.png (the hair label
    and head silhouette of each frame, 0/255).

    Returns {"config": the case's Config, "mvs_poses": {frame: 4x4 MVS c2w}}.
    """
    from .coords import nerf_to_ngp
    from .io.image_io import imwrite, write_png
    from .io.mesh_io import save_obj
    from .nerf.poses import _se3, convert_mesh_nerf_to_mvs, save_base_cam

    if ext not in (".png", ".JPG", ".jpg"):
        raise ValueError(f"write_capture_case: ext {ext!r} is not .png, .JPG or .jpg")
    root = os.path.join(data_root, case)
    for sub in ("colmap/images", "ours", "Bust", "labels/hair", "labels/hit"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    f_pix = (H / 2) / math.tan(math.radians(CAPTURE_FOV_Y) / 2)
    angles = [2 * math.pi * j / num_frames for j in range(num_frames)]
    # even frames on the low ring (the MVS rig), odd frames on two raised tiers
    odd_tiers = (0.6, 1.1)
    poses = [capture_orbit_pose(a, elev=(0.12 if j % 2 == 0 else odd_tiers[(j // 2) % 2]))
             for j, a in enumerate(angles)]
    frames, mvs_poses = [], {}
    for j, c2w in enumerate(poses):
        img, hair, hit = capture_render_view(c2w, f_pix, H, W)
        name = f"frame_{j:04d}"
        imwrite(os.path.join(root, "colmap/images", name + ext), (img * 255).astype(np.uint8))
        write_png(os.path.join(root, "labels/hair", name + ".png"),
                  hair.astype(np.uint8) * 255)
        write_png(os.path.join(root, "labels/hit", name + ".png"),
                  hit.astype(np.uint8) * 255)
        frames.append({"file_path": f"images/{name}{ext}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "colmap/transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 2 * math.atan(W / (2 * f_pix)),
                   "camera_angle_y": math.radians(CAPTURE_FOV_Y),
                   "fl_x": f_pix, "fl_y": f_pix, "cx": W / 2, "cy": H / 2,
                   "w": W, "h": H, "frames": frames}, f, indent=1)

    B = [nerf_to_ngp(p) for p in poses]
    save_base_cam(os.path.join(root, "colmap/key_frame.json"),
                  [_se3(B[0][:, :3], B[0][:, 3])], [CAPTURE_FOV_Y])
    for j, c2w in enumerate(poses):
        mvs_poses[f"frame_{j:04d}"] = capture_mvs_pose(c2w)
    # the rig: every 2nd frame's MVS pose, upright in the MVS frame
    fy_rig = 1920.0 / (3.0 * math.tan(math.radians(CAPTURE_FOV_Y) / 2))
    ndc = [2 * f_pix / W, 2 * f_pix / H, 0.0, 0.0]
    cam_list = []
    for k, j in enumerate(range(0, num_frames, 2)):
        cam_list.append({"file": f"{k:03d}", "intrin": [0.0] * 4,
                         "intrin_op": [fy_rig, fy_rig, 0.0, 0.0], "dist": [0.0] * 5,
                         "pose": mvs_poses[f"frame_{j:04d}"].tolist(), "ndc_prj": ndc})
    calib_path = os.path.join(root, "calib_cam_params.json")
    with open(calib_path, "w") as f:
        json.dump({"cam_list": cam_list}, f, indent=1)

    # the head sphere as instant-ngp's mesh export gives it (NeRF scale, NGP
    # axes), through the pose chain to the MVS bust frame: what the coarse
    # NeRF's mesh would be
    hv, hf = uv_sphere(CAPTURE_HEAD_R_NERF)
    colmap_dir = os.path.join(root, "colmap")
    save_obj(os.path.join(root, "ours/colmap_points.obj"),
             convert_mesh_nerf_to_mvs(capture_mesh_axes(hv), colmap_dir, calib_path), hf)
    # Bust/: the head sphere and its hair cap in the MVS bust frame
    head_r_mvs = CAPTURE_HEAD_R_NERF * 0.33 / 2.0
    bv, bf = uv_sphere(head_r_mvs * 0.98)
    save_obj(os.path.join(root, "Bust/bust_long.obj"), bv - BUST_TO_ORIGIN, bf)
    sv, sf = uv_sphere(head_r_mvs * 0.98, max_polar_deg=CAPTURE_HAIR_POLAR_DEG)
    save_obj(os.path.join(root, "Bust/scalp.obj"), sv - BUST_TO_ORIGIN, sf)
    return {"config": capture_config(data_root, case, H, W, frame_interval, modnet, parser),
            "mvs_poses": mvs_poses}


# ---------------------------------------------------------------------------
# the capture case's bust fit: a synthetic SMPL-X model and annotations from
# truth (tools/make_capture_case.py:82-111,242-255, at the official sizes)
# ---------------------------------------------------------------------------

# the SMPL-X kinematic tree (55 joints: body 0-21, jaw 22, eyes 23-24, hands)
SMPLX_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
                          18, 19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34,
                          35, 20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50,
                          21, 52, 53])
# official sizes: 10,475 vertices, 20,908 faces, 300 + 100 shape/expression
# dirs, 54 x 9 pose dirs. The head sphere (72 latitude rings x 144 sectors)
# takes 10,370 vertices and 20,736 faces, a hidden inner sphere (2 x 43) the
# other 172 faces, and 17 vertices stay unused.
SMPLX_OFFICIAL = dict(head_rings=73, head_sectors=144, inner_rings=3, inner_sectors=43,
                      num_verts=10475)
# a small model of the same layout for the tests on the CPU
SMPLX_SMALL = dict(head_rings=13, head_sectors=24, inner_rings=3, inner_sectors=6,
                   num_verts=320)
# the similarity that carries the model's template onto the capture head:
# ~5 degrees of rotation, ~1 cm of translation, scale 1.05
BUST_TRUE_ROT = np.array([0.05, -0.04, 0.06])
BUST_TRUE_TRANSL = np.array([0.006, -0.005, 0.006])
BUST_TRUE_SCALE = 1.05
CAPTURE_HEAD_R_MVS = CAPTURE_HEAD_R_NERF * 0.33 / 2.0


def rotation_from_axis_angle(r: np.ndarray) -> np.ndarray:
    """float64 Rodrigues of one axis-angle vector."""
    angle = float(np.linalg.norm(r))
    if angle == 0.0:
        return np.eye(3)
    k = r / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def bust_true_similarity() -> np.ndarray:
    """The 4x4 that the bust fit should export as model_tsfm.dat."""
    m = np.eye(4)
    m[:3, :3] = BUST_TRUE_SCALE * rotation_from_axis_angle(BUST_TRUE_ROT)
    m[:3, 3] = BUST_TRUE_TRANSL
    return m


def uv_sphere_uvs(rings: int, sectors: int) -> np.ndarray:
    """Per-vertex (u, v) of uv_sphere(r, rings, sectors): u = azimuth / 2pi,
    v = 1 - polar / pi (the poles at v = 1 and 0)."""
    th = np.linspace(0, math.pi, rings + 1)[1:-1]
    ph = np.linspace(0, 2 * math.pi, sectors, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    uv = np.concatenate([[[0.5, 1.0]], np.stack([P.ravel() / (2 * math.pi),
                                                 1.0 - T.ravel() / math.pi], -1), [[0.5, 0.0]]])
    return uv


def synthetic_smplx(rng: np.random.Generator, sizes: dict = SMPLX_OFFICIAL) -> dict:
    """An SMPL-X npz's arrays in the official key layout, whose head sphere is
    the capture head carried by the inverse of bust_true_similarity(): head
    vertices skin to the head joint (15) with no pose dirs, so the template
    posed at the fit's start pose and carried by the similarity is the
    capture head to ~1e-6. Also returns the head's vertex count, its faces and
    the true head vertices (MVS frame)."""
    head_v, head_f = uv_sphere(CAPTURE_HEAD_R_MVS, sizes["head_rings"], sizes["head_sectors"])
    inner_v, inner_f = uv_sphere(CAPTURE_HEAD_R_MVS * 0.6, sizes["inner_rings"],
                                 sizes["inner_sectors"])
    Vh, V, J = len(head_v), sizes["num_verts"], len(SMPLX_PARENTS)
    spare = V - Vh - len(inner_v)
    true = np.concatenate([head_v, inner_v, np.zeros((spare, 3))])     # spares at the centre
    S = bust_true_similarity()
    template = (true - S[:3, 3]) @ np.linalg.inv(S[:3, :3]).T          # S^-1(true)
    faces = np.concatenate([head_f, inner_f + Vh])
    weights = np.zeros((V, J), np.float32)
    weights[:Vh, 15] = 1.0                              # head joint
    weights[Vh:Vh + len(inner_v), 12] = 1.0             # neck
    weights[Vh + len(inner_v):, 0] = 1.0
    Jr = np.zeros((J, V), np.float32)
    for j in range(J):
        ids = rng.choice(V, 16, replace=False)
        Jr[j, ids] = rng.random(16) + 0.1
    Jr /= Jr.sum(-1, keepdims=True)
    dirs = np.zeros((V, 3, 400), np.float32)
    dirs[..., :300] = rng.normal(size=(V, 3, 300)).astype(np.float32) * 0.002
    dirs[..., 300:] = rng.normal(size=(V, 3, 100)).astype(np.float32) * 0.001
    posedirs = (rng.normal(size=(V, 3, (J - 1) * 9)) * 1e-3).astype(np.float32)
    posedirs[:Vh] = 0.0
    return dict(npz=dict(v_template=template.astype(np.float32), f=faces.astype(np.int64),
                         J_regressor=Jr, weights=weights,
                         kintree_table=np.stack([SMPLX_PARENTS, np.arange(J)]),
                         shapedirs=dirs, posedirs=posedirs),
                head_count=Vh, head_faces=head_f, true_verts=true)


def _project_rc(ndc: np.ndarray, c2w: np.ndarray, pts: np.ndarray, H: int, W: int):
    """The bust fit's project_to_pixels in float64: (row, col) of (N, 3)."""
    cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
    u = ndc[0] * cam[:, 0] / cam[:, 2] + ndc[2]
    v = ndc[1] * cam[:, 1] / cam[:, 2] + ndc[3]
    return np.stack([(v + 1.0) * 0.5 * H, (-u + 1.0) * 0.5 * W], -1)


def write_bust_fit_assets(case_root: str, cfg: Config, mvs_poses: dict, H: int, W: int,
                          sizes: dict = SMPLX_OFFICIAL, iters: int = 2000,
                          seed: int = 0) -> dict:
    """The bust fit's inputs for a capture case (write_capture_case's
    `mvs_poses`), in <case_root>/assets and <case_root>/optimize:
    SMPLX_SYNTH.npz (synthetic_smplx), landmark_vertex_ids.npy (68 head
    vertices), head_template.obj (the head sphere with UVs, the FLAME
    template), flame_vertex_ids.npy (the head's ids), scalp_mask.png (red over
    the hair cap, polar angle < 70 degrees), and every frame's annotations
    written from truth, so that the annotation step reports them cached:
    landmark2d/ (the landmark vertices of the true head, projected as the fit
    projects them), iris/ (vertices 9503 and 10049, or two head vertices on a
    smaller model), matting/ (the frame with the labels/hit silhouette as
    alpha) and face_parsing/ (class 17 on labels/hair, 1 on the rest of hit).
    Sets cfg's bustfit and optimize keys. Returns {"similarity": the true 4x4,
    "landmark_truth": (68, 3) true landmark vertices (MVS frame),
    "lmk_ids", "template": (V, 3) template, "head_count": the head's
    vertex count (the first vertices)}."""
    from .io.image_io import _find, imread_rgb, read_png, write_png

    rng = np.random.default_rng(seed)
    assets = os.path.join(case_root, "assets")
    opt = os.path.join(case_root, "optimize")
    for sub in ("landmark2d", "iris", "matting", "face_parsing"):
        os.makedirs(os.path.join(opt, sub), exist_ok=True)
    os.makedirs(assets, exist_ok=True)
    model = synthetic_smplx(rng, sizes)
    np.savez(os.path.join(assets, "SMPLX_SYNTH.npz"), **model["npz"])
    Vh, true = model["head_count"], model["true_verts"]
    lmk_ids = np.sort(rng.choice(Vh, 68, replace=False)).astype(np.int64)
    np.save(os.path.join(assets, "landmark_vertex_ids.npy"), lmk_ids)
    iris_ids = np.array([9503, 10049]) if Vh > 10049 else np.array([Vh // 3, 2 * Vh // 3])
    # the FLAME template: the head sphere's topology with UVs
    uv = uv_sphere_uvs(sizes["head_rings"], sizes["head_sectors"])
    with open(os.path.join(assets, "head_template.obj"), "w") as f:
        f.write("".join(f"v {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n" for p in true[:Vh]))
        f.write("".join(f"vt {t[0]:.8f} {t[1]:.8f}\n" for t in uv))
        f.write("".join("f {0}/{0} {1}/{1} {2}/{2}\n".format(*(k + 1)) for k in model["head_faces"]))
    np.save(os.path.join(assets, "flame_vertex_ids.npy"), np.arange(Vh, dtype=np.int64))
    mask = np.zeros((256, 256, 3), np.uint8)
    mask[:int(256 * CAPTURE_HAIR_POLAR_DEG / 180.0), :, 0] = 255      # v > 1 - 70/180
    write_png(os.path.join(assets, "scalp_mask.png"), mask)

    f_pix = (H / 2) / math.tan(math.radians(CAPTURE_FOV_Y) / 2)
    ndc = np.array([2 * f_pix / W, 2 * f_pix / H, 0.0, 0.0])
    for name, c2w in sorted(mvs_poses.items()):
        rc = _project_rc(ndc, c2w, true[lmk_ids], H, W)
        np.savetxt(os.path.join(opt, "landmark2d", name + ".txt"), rc[:, ::-1])
        irc = _project_rc(ndc, c2w, true[iris_ids], H, W)
        np.savetxt(os.path.join(opt, "iris", name + ".txt"),
                   np.concatenate([irc[:, ::-1], np.ones((2, 1))], 1))
        img = imread_rgb(_find(os.path.join(case_root, "colmap", "images", name)))
        hit = read_png(os.path.join(case_root, "labels", "hit", name + ".png")) > 127
        hair = read_png(os.path.join(case_root, "labels", "hair", name + ".png")) > 127
        write_png(os.path.join(opt, "matting", name + ".png"),
                  np.dstack([img, hit.astype(np.uint8) * 255]))
        cls = np.where(hair, 17, np.where(hit, 1, 0)).astype(np.uint8)
        write_png(os.path.join(opt, "face_parsing", name + ".png"), cls)
    cfg["bustfit"] = Config({
        "smplx_model": os.path.join(assets, "SMPLX_SYNTH.npz"),
        "landmark_vertex_ids": os.path.join(assets, "landmark_vertex_ids.npy"),
        "flame_template": os.path.join(assets, "head_template.obj"),
        "flame_vertex_ids": os.path.join(assets, "flame_vertex_ids.npy"),
        "scalp_mask": os.path.join(assets, "scalp_mask.png"),
        "bust_cut_y": -0.4})
    cfg["optimize"] = Config({"iter": iters})
    return {"similarity": bust_true_similarity(), "landmark_truth": true[lmk_ids],
            "lmk_ids": lmk_ids, "template": model["npz"]["v_template"], "head_count": Vh}
