"""The port's stage-2 CLI (python -m monohair_tpu_torch.PMVO) on a case
written by tests/make_synthetic_case.py, driven through resolve_config."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WIG = np.array([0.0, -1.0, 0.0])


@pytest.fixture
def synthwig_case(tmp_path, monkeypatch):
    """A case written by tests/make_synthetic_case.py, with its YAML beside
    a copy of base.yaml in a scratch working directory."""
    import os
    import shutil
    from tests import make_synthetic_case
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(tmp_path)
    os.makedirs("configs/reconstruct")
    shutil.copy(os.path.join(repo, "configs/reconstruct/base.yaml"), "configs/reconstruct/")
    make_synthetic_case.main(str(tmp_path / "data"), "synthwig")
    return tmp_path


def test_stage_cli_on_a_written_case(synthwig_case, capsys):
    from monohair_tpu.io.mat_io import load_occ_mat, load_ori_mat
    from monohair_tpu_torch import PMVO as cli
    from monohair_tpu_torch.pipeline.common import resolve_config
    cli.main(["--yaml=configs/reconstruct/synthwig", "--device=cpu"])
    out = synthwig_case / "data/synthwig/output/verify"
    assert (out / "options.yaml").exists()
    occ = load_occ_mat(str(out / "refine/Occ3D.mat"))
    ori = load_ori_mat(str(out / "refine/Ori3D.mat"))
    assert occ.shape == (256, 256, 192) and ori.shape == (256, 256, 192, 3)
    assert occ.sum() > 500
    assert np.median(np.abs(ori[occ > 0] @ WIG)) > 0.95

    # resume branch: reload optimize/*.npy and refine again -> the same grids
    from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
    run_pmvo(resolve_config(["--yaml=configs/reconstruct/synthwig", "--PMVO.optimize=",
                             "--PMVO.infer_inner!"]), device="cpu")
    np.testing.assert_array_equal(load_occ_mat(str(out / "refine/Occ3D.mat")), occ)
    np.testing.assert_array_equal(load_ori_mat(str(out / "refine/Ori3D.mat")), ori)

    with pytest.raises(KeyError, match="unknown config key"):
        resolve_config(["--yaml=configs/reconstruct/synthwig", "--PMVO.bogus=1"])
    # bf16 maps (PMVO.bf16_maps) on the resume branch: the refine pass on bf16
    # windows keeps the f32 run's grids (tests/test_torch_bf16_maps.py holds
    # the option against the JAX package's)
    run_pmvo(resolve_config(["--yaml=configs/reconstruct/synthwig", "--PMVO.optimize=",
                             "--PMVO.infer_inner!", "--PMVO.bf16_maps"]), device="cpu")
    occ16 = load_occ_mat(str(out / "refine/Occ3D.mat"))
    ori16 = load_ori_mat(str(out / "refine/Ori3D.mat"))
    both = (occ > 0) & (occ16 > 0)
    assert both.sum() >= 0.99 * ((occ > 0) | (occ16 > 0)).sum()
    assert np.median(np.abs(np.sum(ori[both] * ori16[both], -1))) >= 0.999


def test_zero_points_raise_right_after_loading(synthwig_case):
    from monohair_tpu_torch.pipeline.common import resolve_config
    from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
    (synthwig_case / "data/synthwig/ours/colmap_points.obj").write_text("")
    with pytest.raises(RuntimeError, match="loaded 0 points"):
        run_pmvo(resolve_config(["--yaml=configs/reconstruct/synthwig"]), device="cpu")
