"""The port's marching tetrahedra (monohair_tpu_torch/csrc/marching.cpp through
nerf/marching.py) against the JAX package's C++ (monohair_tpu.native), which
the JAX stage runs wherever g++ works: the same triangles, bitwise, in the
same order. The plain numpy version gives the same set of triangles; an empty
grid gives (0, 3) arrays; a failed g++ build raises. The OBJ files the export
writes are the JAX package's bytes and read back."""

import numpy as np
import pytest

from monohair_tpu.native import marching_tetrahedra_native
from monohair_tpu_torch.nerf import marching


def sphere_grid(n=40):
    ax = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return ((1.0 - (X ** 2 / 0.5 + Y ** 2 / 0.3 + Z ** 2 / 0.4)) * 10).astype(np.float32), 3.0


def random_grid():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(17, 19, 23)).astype(np.float32)
    g[3, 4] = 0.25                 # flat edges at the iso level: u = 0.5
    return g, 0.25


GRIDS = {"sphere": sphere_grid, "random": random_grid}


def jax_native(grid, iso):
    out = marching_tetrahedra_native(grid, iso)
    if out is None:                # a racing worker made the JAX build give up
        import monohair_tpu.native as nat
        nat._BUILD_FAILED = False
        out = marching_tetrahedra_native(grid, iso)
    assert out is not None, "the JAX package's C++ did not build"
    return out


@pytest.mark.parametrize("name", list(GRIDS))
def test_cpp_is_the_jax_packages_cpp_bitwise(name):
    grid, iso = GRIDS[name]()
    verts, faces = marching.marching_tetrahedra(grid, iso)
    jverts, jfaces = jax_native(grid, iso)
    assert len(faces) > 1000
    assert verts.dtype == jverts.dtype and faces.dtype == jfaces.dtype
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)


@pytest.mark.parametrize("name", list(GRIDS))
def test_plain_version_gives_the_cpps_triangles(name):
    grid, iso = GRIDS[name]()
    verts, faces = marching.marching_tetrahedra(grid, iso)
    pverts, pfaces = marching.marching_tetrahedra_plain(grid, iso, slab=5)
    assert pfaces.shape == faces.shape
    tri = np.sort(verts.reshape(-1, 9), axis=0)
    ptri = np.sort(pverts.reshape(-1, 9), axis=0)
    np.testing.assert_allclose(ptri, tri, rtol=0, atol=1e-5)
    # and in the same order
    np.testing.assert_allclose(pverts, verts, rtol=0, atol=1e-5)


def test_empty_grid_gives_no_triangles():
    for fn in (marching.marching_tetrahedra, marching.marching_tetrahedra_plain):
        verts, faces = fn(np.zeros((6, 7, 8), np.float32), 3.0)
        assert verts.shape == (0, 3) and faces.shape == (0, 3)
        verts, faces = fn(np.full((6, 7, 8), 5.0, np.float32), 3.0)
        assert verts.shape == (0, 3) and faces.shape == (0, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    from monohair_tpu_torch.ops import _build
    (tmp_path / "marching.cpp").write_text("int marching_tets( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(marching, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*marching.cpp"):
        marching.marching_tetrahedra(sphere_grid(8)[0], 3.0)


def test_mesh_files_are_the_jax_packages_and_read_back(tmp_path):
    """The export's OBJ writer (formatted in bulk) writes the JAX package's
    bytes; the bulk reader of plain triangle files gives the general parser's
    arrays, and files it does not cover (polygons, uvs, a/b/c faces) take the
    general parser."""
    from monohair_tpu.io import mesh_io as jmesh
    from monohair_tpu_torch.io import mesh_io
    verts, faces = marching.marching_tetrahedra(*sphere_grid(24))
    verts = verts * np.array([1e-9, 1.0, 1e5])
    mesh_io.save_obj(str(tmp_path / "port.obj"), verts, faces, rows=1000)
    jmesh.save_obj(str(tmp_path / "jax.obj"), verts, faces)
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    v, f = mesh_io.load_obj(str(tmp_path / "port.obj"))
    v2, f2, _, _ = mesh_io.load_obj_with_uv(str(tmp_path / "port.obj"))
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)
    (tmp_path / "poly.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\n"
                                       "f 1/1 2/1 3/1 4/1\nf -1 -2 -3\n")
    v, f = mesh_io.load_obj(str(tmp_path / "poly.obj"))
    assert v.shape == (4, 3) and f.tolist() == [[0, 1, 2], [0, 2, 3], [3, 2, 1]]
    mesh_io.save_obj(str(tmp_path / "empty.obj"), np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    v, f = mesh_io.load_obj(str(tmp_path / "empty.obj"))
    assert v.shape == (0, 3) and f.shape == (0, 3)
