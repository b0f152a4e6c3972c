"""Repairs of the port: PMVO's near-surface file is this run's or none, the
tap-loop kernel's limits raise a ValueError that names them, stage 1 turns
TF32 off on the card, and the trainer's validation split is the same in every
process (the JAX trainer seeds it with the per-process salted hash())."""

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


def test_prepare_data_turns_tf32_off_on_the_card():
    """run_prepare_data with every step off and device "cuda" (no card is
    needed: no step runs) leaves both TF32 flags False; on "cpu" it leaves
    them as they were."""
    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.pipeline.prepare_data_stage import run_prepare_data
    steps = dict.fromkeys(("select_images", "process_camera", "run_ngp", "fit_bust",
                           "process_bust", "render_depth", "process_imgs"), False)
    cfg = Config({"data": {"root": "unused"}, "prepare_data": steps})
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        assert run_prepare_data(cfg, device="cpu") == {}
        assert [f.allow_tf32 for f in flags] == [True, True]
        assert run_prepare_data(cfg, device="cuda") == {}
        assert [f.allow_tf32 for f in flags] == [False, False]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


SPLIT = """
import hashlib, sys
import numpy as np
from monohair_tpu_torch.train_mvs import CaseStore
entry = CaseStore(sys.argv[1], sys.argv[2], "occ", 0.25, device="cpu").get("caseA")
print(hashlib.sha256(np.ascontiguousarray(entry["val"][0]).tobytes()).hexdigest(),
      hash("caseA"))
"""


def test_case_store_split_is_the_same_in_every_process(tmp_path, rng):
    """The validation split of a case in two processes with different
    PYTHONHASHSEED values: equal (crc32 seeds it), where the hash() of the
    case name, which the JAX trainer adds to its seed, differs."""
    import subprocess
    import sys
    from tests.test_train_mvs_cli import _build_case
    calib = _build_case(tmp_path / "data", rng)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed, OMP_NUM_THREADS="1")
        proc = subprocess.run([sys.executable, "-c", SPLIT, str(tmp_path / "data"), str(calib)],
                              cwd=repo, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout.split())
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] != outs[1][1]
