"""Training samples for the occupancy/orientation nets (port of
monohair_tpu/mvs/sampling.py; reference sampleOcc, DeepMVSHair
sampleOcc.py:128-169).

Positives inside occupied voxels (6 a voxel), near negatives in the shell the
kernel-wide dilation adds (4 a voxel), far negatives at every `far_stride`-th
empty voxel beyond it (1 a voxel), each jittered uniformly inside its voxel.
The draws are numpy's `default_rng(seed)` in the JAX package's order, so the
points equal the JAX package's bitwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.pool3d import max_pool3d


def rand_samples_from_grid(indices: np.ndarray, per_grid: int,
                           rng: np.random.Generator) -> np.ndarray:
    """`per_grid` points uniformly inside each (X, Y, Z) voxel index."""
    base = np.repeat(indices.astype(np.float32), per_grid, 0)
    return base + rng.random(base.shape).astype(np.float32)


def sample_occ_training_points(occ: np.ndarray, kernel: int = 5, seed: int = 0,
                               pos_per_grid: int = 6, near_per_grid: int = 4,
                               far_stride: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """(voxel-space points (N, 3) float32, labels (N,) int32) from an (X, Y, Z)
    occupancy grid: the positives first, then the near and far negatives.
    `seed` is an int or a numpy Generator to draw from (np.random.default_rng
    passes a Generator through)."""
    rng = np.random.default_rng(seed)
    enlarged = max_pool3d(torch.from_numpy(np.ascontiguousarray(occ, np.float32)),
                          kernel).numpy()
    pos_idx = np.argwhere(occ > 0)
    near_idx = np.argwhere((enlarged > 0) & (occ == 0))
    far_idx = np.argwhere(enlarged == 0)[::far_stride]

    pos = rand_samples_from_grid(pos_idx, pos_per_grid, rng)
    near = rand_samples_from_grid(near_idx, near_per_grid, rng)
    far = rand_samples_from_grid(far_idx, 1, rng)
    pts = np.concatenate([pos, near, far], 0)
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(near) + len(far))])
    return pts, labels.astype(np.int32)


def sample_ori_training_points(occ: np.ndarray, ori: np.ndarray, seed: int = 0,
                               per_grid: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Points inside the occupied voxels that carry a direction (|ori| > 1e-6),
    each paired with its voxel's direction (OriDataset: supervised only where
    the occupancy is positive; a closed volume's interior carries none).
    Returns (voxel-space points (N, 3) float32, directions (N, 3) float32)."""
    rng = np.random.default_rng(seed)
    pos_idx = np.argwhere((occ > 0) & (np.linalg.norm(ori, axis=-1) > 1e-6))
    pts = rand_samples_from_grid(pos_idx, per_grid, rng)
    dirs = np.repeat(ori[pos_idx[:, 0], pos_idx[:, 1], pos_idx[:, 2]], per_grid, 0)
    return pts, dirs.astype(np.float32)
