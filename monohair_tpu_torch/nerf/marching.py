"""Marching tetrahedra iso-surface extraction for the coarse-mesh export
(port of monohair_tpu/nerf/marching.py).

``marching_tetrahedra`` runs the port's copy of the JAX package's host C++
(csrc/marching.cpp, built with g++ by ops/_build.py with the JAX package's
flags), which is what the JAX stage runs wherever g++ works: the same
triangles in the same order. A failed build raises. ``marching_tetrahedra_plain``
is its arithmetic in numpy, for the tests: the C++'s x-major cube corners,
u = 0.5 on a flat edge, triangles in the C++'s order (cube by cube in x, y, z
order, then tetrahedron, then triangle). The JAX package's numpy fallback
orders its corners otherwise and gives a different triangulation of some
cubes; it is not the reference here.

Each cube splits into 6 tetrahedra sharing the 0-7 diagonal; each
tetrahedron gives 0-2 triangles from a 16-case table. The mesh feeds surface
sampling and depth rasterisation only, so winding does not matter. Vertices
are not shared (a triangle soup).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..ops import _build

SOURCE = "marching.cpp"

# cube corner k -> (x, y, z) offset (the C++'s CUBE: k = 4x + 2y + z)
CUBE = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                 [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]])
TETS = np.array([[0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
                 [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]])
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
# case (bit k set = tet vertex k inside) -> up to 2 triangles of tet-edge ids
CASES = -np.ones((16, 2, 3), np.int64)
CASES[0b0001, 0] = [0, 1, 2]
CASES[0b0010, 0] = [0, 3, 4]
CASES[0b0011] = [[1, 2, 4], [1, 4, 3]]
CASES[0b0100, 0] = [1, 3, 5]
CASES[0b0101] = [[0, 2, 5], [0, 5, 3]]
CASES[0b0110] = [[0, 5, 1], [0, 4, 5]]
CASES[0b0111, 0] = [2, 5, 4]
CASES[0b1000, 0] = [2, 4, 5]
CASES[0b1001] = [[0, 1, 5], [0, 5, 4]]
CASES[0b1010] = [[0, 5, 2], [0, 3, 5]]
CASES[0b1011, 0] = [1, 5, 3]
CASES[0b1100] = [[1, 4, 2], [1, 3, 4]]
CASES[0b1101, 0] = [0, 4, 3]
CASES[0b1110, 0] = [0, 2, 1]

_LIB = None


def _lib() -> ctypes.CDLL:
    """The C++ library, built with g++ at first use, with its C signature set."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        lib.marching_tets.restype = ctypes.c_int64
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        _LIB = lib
    return _LIB


def crossing_cubes(inside: np.ndarray) -> np.ndarray:
    """(X-1, Y-1, Z-1) bool: cubes whose 8 corners are neither all inside
    nor all outside."""
    corners = [inside[x:inside.shape[0] - 1 + x, y:inside.shape[1] - 1 + y,
                      z:inside.shape[2] - 1 + z] for x, y, z in CUBE]
    anyc, allc = corners[0].copy(), corners[0].copy()
    for c in corners[1:]:
        anyc |= c
        allc &= c
    return anyc & ~allc


def _soup(tris: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    verts = tris.reshape(-1, 3).astype(np.float64)
    return verts, np.arange(len(verts), dtype=np.int64).reshape(-1, 3)


def marching_tetrahedra(grid: np.ndarray, iso: float) -> Tuple[np.ndarray, np.ndarray]:
    """(X, Y, Z) scalar grid -> (vertices (V, 3) float64 in grid coordinates,
    faces (V/3, 3) int64), through the C++ kernel."""
    g = np.ascontiguousarray(grid, np.float32)
    if g.ndim != 3:
        raise ValueError(f"marching_tetrahedra takes an (X, Y, Z) grid, got {g.shape}")
    # at most 12 triangles a crossing cube; np.empty only reserves the pages
    max_tris = 12 * int(crossing_cubes(g > np.float32(iso)).sum())
    out = np.empty((max(max_tris, 1), 9), np.float32)
    n = _lib().marching_tets(g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             *map(ctypes.c_int64, g.shape), ctypes.c_float(iso),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             ctypes.c_int64(max_tris))
    if n < 0:
        raise RuntimeError(f"marching_tets overflowed its bound of {max_tris} triangles")
    return _soup(out[:n])


def marching_tetrahedra_plain(grid: np.ndarray, iso: float, slab: int = 16
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The C++ kernel's arithmetic and triangle order in numpy float32,
    `slab` x-layers of cubes at a time."""
    g = np.ascontiguousarray(grid, np.float32)
    iso = np.float32(iso)
    X, Y, Z = g.shape
    crossing = crossing_cubes(g > iso)
    out = []
    for x0 in range(0, X - 1, slab):
        cubes = np.argwhere(crossing[x0:x0 + slab])              # C order: x, y, z
        if not len(cubes):
            continue
        cubes[:, 0] += x0
        cidx = cubes[:, None, :] + CUBE[None]                     # (C, 8, 3)
        vals = g[cidx[..., 0], cidx[..., 1], cidx[..., 2]]        # (C, 8)
        pos = cidx.astype(np.float32)
        tv = vals[:, TETS]                                        # (C, 6, 4)
        tp = pos[:, TETS]                                         # (C, 6, 4, 3)
        case = ((tv > iso) << np.arange(4)).sum(-1)               # (C, 6)
        a, b = tv[..., TET_EDGES[:, 0]], tv[..., TET_EDGES[:, 1]]  # (C, 6, 6)
        denom = b - a
        flat = (denom > np.float32(-1e-12)) & (denom < np.float32(1e-12))
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.where(flat, np.float32(0.5), (iso - a) / denom)
        u = np.clip(u, np.float32(0), np.float32(1)).astype(np.float32)
        pa, pb = tp[..., TET_EDGES[:, 0], :], tp[..., TET_EDGES[:, 1], :]
        epts = pa + (pb - pa) * u[..., None]                      # (C, 6, 6, 3)
        tris = CASES[case]                                        # (C, 6, 2, 3)
        keep = tris[..., 0] >= 0                                  # (C, 6, 2)
        c, t, k = np.nonzero(keep)                                # (cube, tet, k) order
        out.append(epts[c[:, None], t[:, None], tris[c, t, k]])   # (M, 3, 3)
    if not out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return _soup(np.concatenate(out, 0))
