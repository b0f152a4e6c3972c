"""Repairs of the port: PMVO's near-surface file is this run's or none, and
the tap-loop kernel's limits raise a ValueError that names them."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import os

import numpy as np
import pytest
import torch

from monohair_tpu_torch.io.mat_io import load_occ_mat, load_ori_mat
from monohair_tpu_torch.ops import patch_kernels as pk
from monohair_tpu_torch.pipeline.common import case_paths
from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
from monohair_tpu_torch.synthetic import write_synthwig_case

torch.set_num_threads(1)


def grids(cfg):
    refine = os.path.join(cfg.output_path, "refine")
    return (load_occ_mat(os.path.join(refine, "Occ3D.mat")),
            load_ori_mat(os.path.join(refine, "Ori3D.mat")))


@pytest.fixture(scope="module")
def unfiltered(tmp_path_factory):
    """A synthwig case run with PMVO.filter_point off and no near-surface file;
    returns (config, its grids)."""
    cfg = case_paths(write_synthwig_case(str(tmp_path_factory.mktemp("case")), num_views=12))
    cfg.PMVO.filter_point = False
    run_pmvo(cfg, device="cpu")
    fu = os.path.join(cfg.output_path, "optimize", "filter_unvisible.npy")
    assert not os.path.exists(fu)
    return cfg, grids(cfg)


def stale_points(cfg):
    """Near-surface points an earlier run might have left: samples beside the
    wig, which refine would stamp into the grids."""
    pts = np.load(os.path.join(cfg.output_path, "optimize", "select_p.npy"))
    return (pts[::3] + np.array([0.01, 0.0, 0.0], np.float32)).astype(np.float32)


def test_optimize_branch_ignores_a_stale_near_surface_file(unfiltered):
    cfg, (occ, ori) = unfiltered
    fu = os.path.join(cfg.output_path, "optimize", "filter_unvisible.npy")
    np.save(fu, stale_points(cfg))
    try:
        run_pmvo(cfg, device="cpu")
        occ2, ori2 = grids(cfg)
    finally:
        os.remove(fu)
    np.testing.assert_array_equal(occ2, occ)
    np.testing.assert_array_equal(ori2, ori)


def test_resume_branch_runs_without_the_near_surface_file(unfiltered):
    cfg, (occ, ori) = unfiltered
    cfg.PMVO.optimize = False
    try:
        run_pmvo(cfg, device="cpu")
    finally:
        cfg.PMVO.optimize = True
    occ2, ori2 = grids(cfg)
    np.testing.assert_array_equal(occ2, occ)
    np.testing.assert_array_equal(ori2, ori)


def test_resume_branch_reads_the_near_surface_file_when_present(unfiltered):
    """The file is the optimize run's output when it exists, and it matters:
    the same stale points change the resumed grids."""
    cfg, (occ, _) = unfiltered
    fu = os.path.join(cfg.output_path, "optimize", "filter_unvisible.npy")
    np.save(fu, stale_points(cfg))
    cfg.PMVO.optimize = False
    try:
        run_pmvo(cfg, device="cpu")
        occ2, _ = grids(cfg)
    finally:
        cfg.PMVO.optimize = True
        os.remove(fu)
    assert (occ2 > 0).sum() > (occ > 0).sum()


@pytest.mark.parametrize("V,S,P,limit", [
    (2 ** 24 + 1, 90, 49, "at most 16777216 views"),
    (2 ** 24 + 1, 1, 9, "at most 16777216 views"),
    (16, 1, 961, "shared-memory budget"),    # refine at patch_size 31
    (16, 2, 909, "shared-memory budget"),
    (16, 90, 14529, "shared-memory budget"),  # one window beyond 227 KB
])
def test_tap_loop_limits_raise_a_named_error(V, S, P, limit):
    with pytest.raises(ValueError, match=limit):
        pk.check_min_loss_limits(V, S, P)


@pytest.mark.parametrize("V", [1, 16, 150, 1023, 1100])
@pytest.mark.parametrize("S,P", [(90, 9), (90, 49), (90, 81), (1, 9), (1, 49), (1, 81),
                                 (1, 191), (3, 81), (1, 225), (2, 193), (1, 900)])
def test_tap_loop_limits_pass_the_shipped_shapes(V, S, P):
    pk.check_min_loss_limits(V, S, P)


def test_plain_tap_loop_has_no_view_limit():
    g = torch.Generator().manual_seed(0)
    V, N, S, P = 1024, 2, 1, 9
    out = pk.patch_min_loss(torch.randn((V, N, S, 2), generator=g),
                            torch.randn((V, N, P, 2), generator=g),
                            torch.rand((V, N, P), generator=g),
                            torch.rand((V, N), generator=g), 0.15)
    assert all(o.shape == (N, S) for o in out)
    assert out[2].max().item() > 1023
