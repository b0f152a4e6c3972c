""".hair strand binary I/O (a copy of monohair_tpu/io/hair_io.py: numpy only,
byte-identical files).

Format (reference: Utils/Utils.py:25-66 `load_strand`, PMVO_utils.py:662-680
`save_hair_strands`):

    uint32  num_strands
    uint32  num_points          (sum of all segment lengths)
    uint16  segments[num_strands]   points per strand
    float32 points[num_points * 3]

The reference writes this with a per-vertex Python struct.pack loop; we write the
whole buffer with vectorized numpy (orders of magnitude faster for ~1e6 points).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def load_hair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .hair file -> (segments (S,), points (N, 3)) numpy arrays."""
    with open(path, "rb") as f:
        raw = f.read()
    num_strands = np.frombuffer(raw, dtype=np.uint32, count=1, offset=0)[0]
    num_points = np.frombuffer(raw, dtype=np.uint32, count=1, offset=4)[0]
    segments = np.frombuffer(raw, dtype=np.uint16, count=int(num_strands), offset=8)
    points = np.frombuffer(raw, dtype=np.float32, count=int(num_points) * 3,
                           offset=8 + 2 * int(num_strands)).reshape(-1, 3)
    if int(segments.sum()) != int(num_points):
        raise ValueError(f"corrupt .hair file {path}: segments sum "
                         f"{int(segments.sum())} != point count {int(num_points)}")
    return segments.astype(np.int64), points.copy()


def save_hair(path: str, strands: Sequence[np.ndarray]) -> None:
    """Write a list of (Ni, 3) strand arrays to a .hair file."""
    segments = np.array([s.shape[0] for s in strands], dtype=np.uint16)
    points = (np.concatenate(strands, 0) if len(strands) else
              np.zeros((0, 3))).astype(np.float32)
    with open(path, "wb") as f:
        f.write(np.uint32(len(segments)).tobytes())
        f.write(np.uint32(points.shape[0]).tobytes())
        f.write(segments.tobytes())
        f.write(np.ascontiguousarray(points).tobytes())


def strands_from_flat(segments: np.ndarray, points: np.ndarray) -> List[np.ndarray]:
    """Split flat (N, 3) points into a list of per-strand arrays."""
    ends = np.cumsum(segments)
    begs = ends - segments
    return [points[b:e] for b, e in zip(begs, ends)]


def flat_from_strands(strands: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    segments = np.array([s.shape[0] for s in strands], dtype=np.int64)
    points = np.concatenate(strands, 0) if len(strands) else np.zeros((0, 3), np.float32)
    return segments, points


def strand_directions(strand: np.ndarray) -> np.ndarray:
    """Per-vertex forward differences, last repeated; unit length
    (reference: Utils/Utils.py:83-86)."""
    d = np.concatenate([strand[1:] - strand[:-1], strand[-1:] - strand[-2:-1]], 0)
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
