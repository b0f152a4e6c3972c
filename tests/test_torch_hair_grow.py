"""Stage 4 (HairGrow) of the PyTorch port against the JAX package on the CPU:
each module on the same numpy inputs, and the stage on one written case."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu import coords as jcoords
from monohair_tpu.io import hair_io as jhio
from monohair_tpu.strands import connect as jconn
from monohair_tpu.strands import resample as jres
from monohair_tpu.strands import scalp_diffusion as jdiff
from monohair_tpu.strands import smooth as jsm
from monohair_tpu.strands import trace as jtr
from monohair_tpu_torch import coords as tcoords
from monohair_tpu_torch.io import hair_io as thio
from monohair_tpu_torch.strands import connect as tconn
from monohair_tpu_torch.strands import resample as tres
from monohair_tpu_torch.strands import scalp_diffusion as tdiff
from monohair_tpu_torch.strands import smooth as tsm
from monohair_tpu_torch.strands import trace as ttr
from monohair_tpu_torch.synthetic import curved_strand_batch, grow_field

torch.set_num_threads(1)

SHAPE = (48, 48, 36)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def field():
    """A small swirl field: 250 curved strands of 30 points voxelised into
    (48, 48, 36) grids, and more curved strands for the connect passes."""
    rng = np.random.default_rng(0)
    occ, ori = grow_field(rng, num_strands=250, length=30, grid_shape=SHAPE)
    return occ, ori, rng


def same_strands(a, b, atol=1e-4):
    """(count equal, share of strands with equal length and coordinates
    within atol, pairing strands in order)."""
    if len(a) != len(b):
        return False, 0.0
    ok = [x.shape == y.shape and np.allclose(x, y, rtol=0, atol=atol) for x, y in zip(a, b)]
    return True, float(np.mean(ok)) if ok else 1.0


# ---------------------------------------------------------------------------
# coordinates and files
# ---------------------------------------------------------------------------

def test_coords_match_jax_bitwise(rng):
    """voxel_to_world, world_to_voxel and the direction flip equal the JAX
    package's eager calls bit for bit; a round trip is within float32."""
    vox = (rng.random((5000, 3)) * [256, 256, 192]).astype(np.float32)
    world = tcoords.voxel_to_world(t(vox)).numpy()
    np.testing.assert_array_equal(world, np.asarray(jcoords.voxel_to_world(vox)))
    back = tcoords.world_to_voxel(t(world)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jcoords.world_to_voxel(world)))
    np.testing.assert_allclose(back, vox, rtol=0, atol=1e-4)
    dirs = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcoords.world_dir_to_voxel(t(dirs)).numpy(),
                                  np.asarray(jcoords.world_dir_to_voxel(dirs)))
    np.testing.assert_array_equal(tcoords.voxel_dir_to_world(t(dirs)).numpy(), dirs * [1, -1, -1])


def test_hair_files_are_byte_identical(tmp_path, rng):
    strands = [rng.normal(size=(n, 3)) for n in (2, 7, 30)] + [rng.normal(size=(5, 3)).astype(np.float32)]
    thio.save_hair(str(tmp_path / "t.hair"), strands)
    jhio.save_hair(str(tmp_path / "j.hair"), strands)
    raw = (tmp_path / "t.hair").read_bytes()
    assert raw == (tmp_path / "j.hair").read_bytes()
    seg, pts = thio.load_hair(str(tmp_path / "t.hair"))
    jseg, jpts = jhio.load_hair(str(tmp_path / "j.hair"))
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_array_equal(pts, jpts)
    for a, b in zip(thio.strands_from_flat(seg, pts), strands):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    # a segment count that disagrees with the point count is refused by both
    bad = bytearray(raw)
    bad[8:10] = np.uint16(9).tobytes()
    (tmp_path / "bad.hair").write_bytes(bytes(bad))
    for load in (thio.load_hair, jhio.load_hair):
        with pytest.raises(ValueError, match="corrupt .hair file"):
            load(str(tmp_path / "bad.hair"))


# ---------------------------------------------------------------------------
# smoothing
# ---------------------------------------------------------------------------

def test_smooth_padded_matches_jax(rng):
    """Batched CG within atol 1e-5 (sums in another order); padding passes
    through unchanged."""
    pts = rng.normal(size=(6, 40, 3)).astype(np.float32).cumsum(1)
    lens = np.array([40, 2, 17, 33, 5, 1])
    pts[2, 17:] = 777.0
    out = tsm.smooth_strands_padded(t(pts), t(lens), 4.0, 2.0).numpy()
    ref = np.asarray(jsm.smooth_strands_padded(jnp.asarray(pts), jnp.asarray(lens), 4.0, 2.0))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[2, 17:], 777.0)


def test_smooth_strand_list_matches_jax(rng):
    strands = [rng.normal(size=(n, 3)).cumsum(0) * 0.01 for n in (3, 12, 64, 65, 130, 7)]
    strands[1] = strands[1].astype(np.float32)
    out = tsm.smooth_strand_list(strands, 4.0, 2.0)
    ref = jsm.smooth_strand_list(strands, 4.0, 2.0)
    assert [o.shape for o in out] == [r.shape for r in ref]
    assert all(o.dtype == np.float32 for o in out)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-5)
    tips = tsm.smooth_strand_list(strands, 4.0, 2.0, fix_tips=True, bucket=32)
    tips_ref = jsm.smooth_strand_list(strands, 4.0, 2.0, fix_tips=True, bucket=32)
    for o, r in zip(tips, tips_ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_trace_bidirectional_matches_jax(field):
    """The same kept strands, >= 99% of them with equal length and points
    within 1e-4 voxels (the dot products are rounded as XLA rounds them)."""
    occ, ori, _ = field
    seeds = np.argwhere(occ > 0)[::5][:600]
    noise = np.random.default_rng(1).random((len(seeds), 3)).astype(np.float32)
    rj = jtr.trace_bidirectional(jnp.asarray(occ), jnp.asarray(ori), jnp.asarray(seeds),
                                 jnp.asarray(noise), 0.8)
    rt = ttr.trace_bidirectional(t(occ), t(ori), t(seeds), t(noise), 0.8)
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    lj, lt = jtr.strands_to_list(rj, 5), ttr.strands_to_list(rt, 5)
    assert len(lj) > 100
    count_ok, share = same_strands(lj, lt)
    assert count_ok and share >= 0.99, (len(lj), len(lt), share)


def scalp_case(occ):
    """Scalp seeds on a plane above the field's head, normals down (voxel +y)."""
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(12, 36, 300), np.full(300, 5.0),
                    rng.uniform(10, 26, 300)], -1).astype(np.float32)
    nrm = rng.normal(size=(300, 3)) * 0.3 + [0.0, 1.0, 0.0]
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    return pts, nrm


def test_trace_from_scalp_and_update_flag_match_jax(field):
    occ, ori, _ = field
    sp, sn = scalp_case(occ)
    rj = jtr.trace_from_scalp(jnp.asarray(occ), jnp.asarray(ori), jnp.asarray(sp),
                              jnp.asarray(sn), 0.8)
    rt = ttr.trace_from_scalp(t(occ), t(ori), t(sp), t(sn), 0.8)
    lj, lt = jtr.strands_to_list(rj, 2), ttr.strands_to_list(rt, 2)
    assert len(lj) > 20
    count_ok, share = same_strands(lj, lt)
    assert count_ok and share >= 0.99, (len(lj), len(lt), share)
    # coverage counts: whole numbers, so exact in any order
    fj = jtr.update_flag(jnp.zeros_like(jnp.asarray(occ)), rj)
    ft = ttr.update_flag(torch.zeros(occ.shape), rt)
    if share == 1.0:
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert abs(float(ft.sum()) - float(jnp.sum(fj))) <= 0.01 * float(jnp.sum(fj))


def test_generate_guide_and_segments_matches_jax(field):
    """Guides, then two flag-suppressed sweeps in chunks of 512 seeds: the same
    num_root, the same strand count, >= 99% of strands equal within 1e-4."""
    occ, ori, _ = field
    sp, sn = scalp_case(occ)
    sj, nj = jtr.generate_guide_and_segments(occ, ori, sp, sn, 0.8, chunk=512)
    st, nt = ttr.generate_guide_and_segments(t(occ), t(ori), sp, sn, 0.8, chunk=512)
    assert nt == nj > 0
    count_ok, share = same_strands(sj, st)
    assert count_ok and share >= 0.99, (len(sj), len(st), share)
    assert len(sj) > nj


# ---------------------------------------------------------------------------
# scalp diffusion and resampling
# ---------------------------------------------------------------------------

def test_diffuse_scalp_matches_jax():
    """The fixture of tests/test_resample_diffusion.py: occ exact, ori within
    1e-5 (direction sums in another order)."""
    occ = np.zeros((32, 32, 32), np.float32)
    occ[10:22, 20:26, 10:22] = 1.0
    ori = np.zeros((32, 32, 32, 3), np.float32)
    ori[..., 1] = 1.0
    ori *= occ[..., None]
    scalp_pts = np.stack([np.linspace(12, 20, 8), np.full(8, 14.0),
                          np.full(8, 16.0)], -1).astype(np.float32)
    normals = np.tile([0.0, 1.0, 0.0], (8, 1)).astype(np.float32)
    jo, jc = jdiff.diffuse_scalp(jnp.asarray(occ), jnp.asarray(ori), jnp.asarray(scalp_pts),
                                 jnp.asarray(normals))
    to, tc = tdiff.diffuse_scalp(t(occ), t(ori), t(scalp_pts), t(normals))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    assert tc.numpy()[16, 15:20, 16].sum() >= 4


def test_diffuse_scalp_on_a_swirl_field_matches_jax(field):
    """Bridges of every length on a curved field: occ exact, ori within 1e-4.
    XLA fuses the bridge length and the Hermite sums into multiply-adds in an
    order the port does not pin, so a sample can differ by an ulp; a short
    bridge's tangent is the difference of two nearby samples, which turns
    that ulp into ~1e-5 of the averaged direction (1.9e-5 at most here)."""
    occ, ori, _ = field
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(8, 40, 200), rng.uniform(2, 14, 200),
                    rng.uniform(8, 28, 200)], -1).astype(np.float32)
    nrm = rng.normal(size=(200, 3)) * 0.4 + [0.0, 1.0, 0.0]
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    jo, jc = jdiff.diffuse_scalp(jnp.asarray(occ), jnp.asarray(ori), jnp.asarray(pts),
                                 jnp.asarray(nrm))
    to, tc = tdiff.diffuse_scalp(t(occ), t(ori), t(pts), t(nrm))
    assert (tc.numpy() != occ).sum() > 0
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-4)


def test_resample_strands_equal(rng):
    strands = [np.stack([np.sin(np.linspace(0, 1, n) * 3), np.linspace(0, 1, n),
                         np.cos(np.linspace(0, 1, n) * 2)], -1) for n in (4, 8, 20)]
    strands.append(np.repeat(rng.random((1, 3)), 7, 0) + np.arange(7)[:, None] * [0, 0.1, 0])
    strands[-1][3] = strands[-1][2]                      # a duplicate point
    out, ref = tres.resample_strands(strands, 50), jres.resample_strands(strands, 50)
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    for o, r in zip(tres.pad_strands(strands), jres.pad_strands(strands)):
        np.testing.assert_array_equal(o, r)


# ---------------------------------------------------------------------------
# connection
# ---------------------------------------------------------------------------

def world_segments(rng, count, length):
    """Curved world-space segments inside the grid of SHAPE at the standard
    voxel size (the frame connect_all_segments works in)."""
    vox = curved_strand_batch(rng, count, length, SHAPE, step=0.6)
    return [np.asarray(jcoords.voxel_to_world(v), np.float64) for v in vox]


def test_segment_connector_and_connect_all_segments_equal(field):
    occ, ori, _ = field
    rng = np.random.default_rng(4)
    segs = world_segments(rng, 120, 12)
    # split half of them in two so that there are tips and roots to join
    segs = [p for s in segs[:60] for p in (s[:6], s[6:])] + segs[60:]
    from monohair_tpu.constants import VOXEL_MIN as vmin, VOXEL_SIZE as vsize
    jc = jconn.SegmentConnector(segs, 0.005, 0.7)
    tc = tconn.SegmentConnector(segs, 0.005, 0.7)
    ji, ti = jc.find_connect_info(), tc.find_connect_info()
    assert ti == ji
    assert sum(i["tip"] is not None for i in ji) > 10
    for i in range(0, len(segs), 7):
        np.testing.assert_array_equal(tc.chain(ti, i), jc.chain(ji, i))
    out = tconn.connect_all_segments(segs, occ, ori, 0.005, 0.7, vmin, vsize)
    ref = jconn.connect_all_segments(segs, occ, ori, 0.005, 0.7, vmin, vsize)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


def scalp_strands(rng, n_root=40, n_free=160):
    arcs = curved_strand_batch(rng, n_root + n_free, 20, SHAPE, step=1.0)
    return [arcs[i] for i in range(len(arcs))], n_root


def test_connect_to_scalp_native_is_bit_exact_against_jax(field):
    """The port's copy of the C++, built with the JAX package's flags, gives
    the JAX package's native result bit for bit."""
    from monohair_tpu import native as jnative
    occ, ori, _ = field
    strands, n_root = scalp_strands(np.random.default_rng(5))
    out = tconn.connect_to_scalp(strands, n_root, occ, ori, out_ratio_threshold=0.3)
    ref = jnative.connect_to_scalp_native(strands, n_root, occ, ori, 0.3)
    if ref is None:
        # the JAX package builds its library in place, and a test worker can
        # find another's half-written file; it then gives up: build it again
        jnative._LIB, jnative._BUILD_FAILED = None, False
        ref = jnative.connect_to_scalp_native(strands, n_root, occ, ori, 0.3)
    ref, _ = ref
    assert len(out) == len(ref) > n_root
    for o, r in zip(out, ref):
        assert o.dtype == np.float64
        np.testing.assert_array_equal(o, r)
    assert tconn.connect_to_scalp([], 0, occ, ori) == []


def test_connect_to_scalp_plain_equals_jax_python(field):
    occ, ori, _ = field
    strands, n_root = scalp_strands(np.random.default_rng(6), 20, 60)
    out = tconn.connect_to_scalp_plain(strands, n_root, occ, ori, out_ratio_threshold=0.3)
    ref = jconn.connect_to_scalp(strands, n_root, occ, ori, out_ratio_threshold=0.3,
                                 use_native=False)
    assert len(out) == len(ref) > n_root
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


def test_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s output; nothing falls back."""
    from monohair_tpu_torch.ops import _build
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*broken.cpp"):
        _build.build("broken.cpp")
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

def test_stage_matches_jax_on_a_written_case(tmp_path):
    """run_hair_grow on the CPU against the JAX stage on one case: refine/
    grids written straight from the synthetic wig's voxelised strands (no
    PMVO), the case's scalp cap. num_root exact, strand counts within 1%,
    matched strands within 1e-5 (world units)."""
    import os
    import shutil

    from monohair_tpu.config import Config as JConfig
    from monohair_tpu.io.hair_io import load_hair
    from monohair_tpu.pipeline.hair_grow_stage import run_hair_grow as jax_stage
    from monohair_tpu_torch.io.mat_io import save_occ_ori_mat
    from monohair_tpu_torch.pipeline.common import case_paths
    from monohair_tpu_torch.pipeline.hair_grow_stage import run_hair_grow
    from monohair_tpu_torch.synthetic import make_wig, wig_grids, write_synthwig_case

    cfg = case_paths(write_synthwig_case(str(tmp_path), num_views=2))
    refine = os.path.join(cfg.output_path, "refine")
    save_occ_ori_mat(refine, *wig_grids(make_wig(rng=np.random.default_rng(0))))
    steps = run_hair_grow(cfg, device="cpu")
    assert set(steps) == {"load", "trace", "smooth", "connect_segments", "connect_scalp"}
    names = ["scalp_segment.hair", "scalp_segment_smooth.hair", "strands.hair",
             "connected_strands.hair", "num_root.npy"]
    os.makedirs(os.path.join(refine, "port"))
    for name in names:
        shutil.move(os.path.join(refine, name), os.path.join(refine, "port", name))
    jax_stage(JConfig(cfg.to_dict()))

    num_root = int(np.load(os.path.join(refine, "num_root.npy")))
    assert int(np.load(os.path.join(refine, "port", "num_root.npy"))) == num_root > 0
    for name in names[:4]:
        seg_j, pts_j = load_hair(os.path.join(refine, name))
        seg_t, pts_t = load_hair(os.path.join(refine, "port", name))
        assert len(seg_j) > 0
        assert abs(len(seg_t) - len(seg_j)) <= 0.01 * len(seg_j), name
        sj, st = jhio.strands_from_flat(seg_j, pts_j), jhio.strands_from_flat(seg_t, pts_t)
        matched = [a.shape == b.shape and np.allclose(a, b, rtol=0, atol=1e-5)
                   for a, b in zip(sj, st)]
        assert np.mean(matched) >= 0.99, (name, np.mean(matched))
