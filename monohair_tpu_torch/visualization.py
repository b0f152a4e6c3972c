"""Debug exports (port of monohair_tpu/visualization.py; the reference's
visualization.py / visual_utils.py open open3d windows, headless hosts get
PLY and image files instead): the same bytes as the JAX package's, with the
slices written by the port's PNG writer."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .io.image_io import write_png


def save_ply_points(path: str, points: np.ndarray,
                    colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud; colors in [0,1] -> uint8."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            c8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for p, c in zip(points, c8):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def save_oriented_points(path: str, points: np.ndarray, dirs: np.ndarray) -> None:
    """Directions colour-coded as (d+1)/2, the reference's vis_point_colud
    convention (visualization.py:5-66)."""
    save_ply_points(path, points, (np.asarray(dirs) + 1.0) * 0.5)


def save_strands_ply(path: str, strands: List[np.ndarray]) -> None:
    """Strands as polyline edges in a PLY (viewable in meshlab/blender)."""
    pts = np.concatenate(strands, 0)
    edges = []
    off = 0
    for s in strands:
        n = len(s)
        edges.extend([(off + i, off + i + 1) for i in range(n - 1)])
        off += n
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")


def save_occ_slices(path_prefix: str, occ: np.ndarray, axis: int = 2,
                    num: int = 6) -> None:
    """PNG slices of an occupancy grid at 20%..80% of an axis, for a quick look."""
    Z = occ.shape[axis]
    for i, z in enumerate(np.linspace(Z * 0.2, Z * 0.8, num).astype(int)):
        sl = np.take(occ, z, axis=axis)
        write_png(f"{path_prefix}_slice{i}.png", (np.asarray(sl) * 255).astype(np.uint8))
