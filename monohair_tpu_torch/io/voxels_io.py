"""voxels.dat binary I/O, byte-compatible with the reference (port of
monohair_tpu/io/voxels_io.py).

Disk layout (reference: submodules/DeepMVSHair/mvs_eval.py:38,222-226 — one
flat float32 stream):

    float32 grid_resolution[3]      ((bbox_max - bbox_min) / vsize)
    float32 bbox_min[3]
    float32 vsize
    float32 count                   (number of positive points)
    float32 data[count * 6]         (point xyz ++ orientation xyz, row-major)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def save_voxels_dat(path: str, points: np.ndarray, oris: np.ndarray,
                    grid_resolution: np.ndarray, bbox_min, vsize: float) -> None:
    """Write (N,3) points + (N,3) orientations in the reference layout."""
    header = np.concatenate([
        np.asarray(grid_resolution, np.float32).reshape(3),
        np.asarray(bbox_min, np.float32).reshape(3),
        [np.float32(vsize)], [np.float32(len(points))]])
    data = np.concatenate([points, oris], 1).reshape(-1).astype(np.float32)
    np.concatenate([header, data]).astype(np.float32).tofile(path)


def load_voxels_dat(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray, float]:
    """Read voxels.dat -> (points (N,3), oris (N,3), grid_resolution (3,),
    bbox_min (3,), vsize)."""
    raw = np.fromfile(path, dtype=np.float32)
    count = int(raw[7])
    data = raw[8:8 + count * 6].reshape(count, 6)
    return (np.ascontiguousarray(data[:, :3]), np.ascontiguousarray(data[:, 3:]),
            raw[0:3], raw[3:6], float(raw[6]))
