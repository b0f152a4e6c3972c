"""Minimal OBJ mesh I/O and surface sampling (port of monohair_tpu/io/mesh_io.py;
numpy only, no trimesh/open3d).

Covers what the pipeline needs: vertex/face read-write (reference loads meshes
with trimesh/o3d at PMVO_utils.py:176-181,341-362; HairGrow.py:880-884) and
uniform area-weighted surface sampling with normals (o3d
`sample_points_uniformly` equivalent).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices (V,3) float64, faces (F,3) int64).

    Handles `v x y z` and `f a b c` / `f a/b/c ...` lines; polygons are
    fan-triangulated. Ignores normals/uvs/materials. A file of `v x y z` and
    `f a b c` records only (as save_obj writes it) is parsed in bulk.
    """
    plain = _load_plain_triangles(path)
    if plain is not None:
        return plain
    v, fa, _, _ = load_obj_with_uv(path)
    return v, fa


def _load_plain_triangles(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(vertices, faces) of an OBJ whose vertex and face records are all
    `v x y z` and `f a b c` with positive indices (other records ignored, no
    texture coordinates), else None."""
    with open(path) as f:
        lines = f.read().splitlines()
    if any(line.startswith("vt ") for line in lines):
        return None
    vrec = [line[2:] for line in lines if line.startswith("v ")]
    frec = [line[2:] for line in lines if line.startswith("f ")]
    fjoined = " ".join(frec)
    if "/" in fjoined:
        return None
    # numpy's text parser rounds as float() does; text it cannot read ends
    # the array early (the counts below refuse it) or raises, as later numpy does
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        try:
            verts = np.fromstring(" ".join(vrec), dtype=np.float64, sep=" ")
            faces = np.fromstring(fjoined, dtype=np.int64, sep=" ")
        except ValueError:
            return None
    if len(verts) != 3 * len(vrec) or len(faces) != 3 * len(frec):
        return None
    faces = faces.reshape(-1, 3)
    if len(faces) and faces.min() < 1:
        return None
    return verts.reshape(-1, 3), faces - 1


def load_obj_with_uv(path: str):
    """Parse an OBJ with texture coordinates.

    Returns (vertices (V,3), faces (F,3), uvs (T,2), face_uvs (F,3) int64 or
    None) — face_uvs index into uvs per face corner.
    """
    verts, faces, uvs, face_uvs = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                toks = line.split()[1:]
                vidx, tidx = [], []
                for p in toks:
                    comp = p.split("/")
                    i = int(comp[0])
                    vidx.append(i - 1 if i > 0 else len(verts) + i)
                    if len(comp) > 1 and comp[1]:
                        t = int(comp[1])
                        tidx.append(t - 1 if t > 0 else len(uvs) + t)
                for k in range(1, len(vidx) - 1):
                    faces.append([vidx[0], vidx[k], vidx[k + 1]])
                    if len(tidx) == len(vidx):
                        face_uvs.append([tidx[0], tidx[k], tidx[k + 1]])
    v = np.array(verts, dtype=np.float64).reshape(-1, 3)  # (0, 3) when empty
    fa = np.array(faces, dtype=np.int64) if faces else np.zeros((0, 3), np.int64)
    uv = np.array(uvs, dtype=np.float64) if uvs else np.zeros((0, 2))
    fuv = (np.array(face_uvs, dtype=np.int64)
           if face_uvs and len(face_uvs) == len(faces) else None)
    return v, fa, uv, fuv


def save_obj(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
             rows: int = 65536) -> None:
    """`v x y z` lines (%.8f) then 1-based `f a b c` lines, formatted
    `rows` records at a time."""
    with open(path, "w") as f:
        _write_records(f, "v %.8f %.8f %.8f\n", np.asarray(vertices, np.float64), rows)
        if faces is not None:
            _write_records(f, "f %d %d %d\n", np.asarray(faces, np.int64) + 1, rows)


def _write_records(f, fmt: str, table: np.ndarray, rows: int) -> None:
    for beg in range(0, len(table), rows):
        part = table[beg:beg + rows]
        f.write((fmt * len(part)) % tuple(part.reshape(-1).tolist()))


def _face_cross(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Each face's edge cross product (its normal times twice its area)."""
    e1 = vertices[faces[:, 1]] - vertices[faces[:, 0]]
    e2 = vertices[faces[:, 2]] - vertices[faces[:, 0]]
    return np.cross(e1, e2)


def _unit(n: np.ndarray) -> np.ndarray:
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit face normals (F, 3), by the right-hand rule on the face's order."""
    return _unit(_face_cross(vertices, faces))


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals (V, 3) (bustfit.soft_raster has the
    device version that the fit differentiates)."""
    fn = _face_cross(vertices, faces)
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return _unit(vn)


def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray, num_points: int,
                        rng: Optional[np.random.Generator] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform area-weighted surface sampling -> (points (N,3), normals (N,3)).

    Equivalent of o3d.sample_points_uniformly (used at HairGrow.py:881-884 to
    draw 60k scalp seeds and PMVO_utils.py:346 for colmap-mesh points).
    """
    rng = rng or np.random.default_rng(0)
    e1 = vertices[faces[:, 1]] - vertices[faces[:, 0]]
    e2 = vertices[faces[:, 2]] - vertices[faces[:, 0]]
    fn = np.cross(e1, e2)
    areas = 0.5 * np.linalg.norm(fn, axis=-1)
    probs = areas / max(areas.sum(), 1e-12)
    fidx = rng.choice(len(faces), size=num_points, p=probs)
    u = rng.random(num_points)
    v = rng.random(num_points)
    flip = u + v > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    pts = (vertices[faces[fidx, 0]]
           + u[:, None] * e1[fidx]
           + v[:, None] * e2[fidx])
    normals = fn[fidx] / np.maximum(np.linalg.norm(fn[fidx], axis=-1, keepdims=True), 1e-12)
    return pts, normals
