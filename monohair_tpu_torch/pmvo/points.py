"""Raw point-cloud preparation for PMVO (port of monohair_tpu/pmvo/points.py;
numpy on the host, the same numpy generator, so the point sets are identical).

Mirror of load_colmap_points / SamplePointsAroundmesh (PMVO_utils.py:316-362):
sample the coarse NGP mesh surface uniformly (5x its vertex count), bin the
samples into a fine (512, 512, 384) grid, and emit `num_per_grid` jittered
samples per occupied voxel.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np

from ..constants import BUST_TO_ORIGIN, VOXEL_MIN
from ..io.mesh_io import load_obj, sample_mesh_surface

# the last mesh's surface samples: PMVO's candidates and infer_inner's
# colmap-guided queries draw the same ones from one file
_SURFACE: dict = {}


def sample_points_around_mesh(points_world: np.ndarray, bbox_min: np.ndarray,
                              vsize: float, num_per_grid: int = 4,
                              grid_resolution=(512, 512, 384),
                              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Voxel-bin world points and draw jittered samples per occupied voxel
    (PMVO_utils.py:316-339). Jitter is uniform in [0, 1) voxel (corner anchor)."""
    rng = rng or np.random.default_rng(0)
    res = np.asarray(grid_resolution)
    p = points_world.copy()
    p[:, 1:] *= -1
    idx = np.round((p - bbox_min) / vsize).astype(np.int64)
    idx = np.clip(idx, 0, res - 1)
    flat = (idx[:, 0] * res[1] + idx[:, 1]) * res[2] + idx[:, 2]
    uniq = np.unique(flat)
    ux = uniq // (res[1] * res[2])
    uy = (uniq // res[2]) % res[1]
    uz = uniq % res[2]
    base = np.stack([ux, uy, uz], -1).astype(np.float64)
    base = np.repeat(base, num_per_grid, 0)
    sample = base + rng.random(base.shape)
    sample = sample * vsize + bbox_min
    sample[:, 1:] *= -1
    return sample.astype(np.float32)


def mesh_surface_samples(path: str, seed: int = 0) -> Tuple[np.ndarray, np.random.Generator]:
    """The mesh's surface samples (5 a vertex; its vertices when it has no
    faces) drawn by a generator seeded `seed`, and that generator after the
    draws. The last file's samples are kept, keyed by its contents' digest,
    and handed out again with the generator's state."""
    with open(path, "rb") as f:
        key = (hashlib.blake2b(f.read(), digest_size=16).digest(), seed)
    if key not in _SURFACE:
        verts, faces = load_obj(path)
        rng = np.random.default_rng(seed)
        if len(faces):
            pts, _ = sample_mesh_surface(verts, faces, num_points=5 * len(verts), rng=rng,
                                         normals=False)
        else:
            pts = verts
        pts.setflags(write=False)
        _SURFACE.clear()
        _SURFACE[key] = (pts, rng.bit_generator.state)
    pts, state = _SURFACE[key]
    rng = np.random.default_rng(seed)
    rng.bit_generator.state = state
    return pts, rng


def load_colmap_points(path: str, bbox_min=VOXEL_MIN,
                       bust_to_origin=BUST_TO_ORIGIN, vsize: float = 0.005 / 4,
                       grid_resolution=(512, 512, 384), num_per_grid: int = 4,
                       seed: int = 0) -> np.ndarray:
    """Load the coarse mesh and produce the PMVO query samples
    (PMVO_utils.py:341-362 + PMVO.py:843-845 call site)."""
    pts, rng = mesh_surface_samples(path, seed)
    pts = pts + np.asarray(bust_to_origin)
    return sample_points_around_mesh(pts, np.asarray(bbox_min), vsize,
                                     num_per_grid, grid_resolution, rng)
