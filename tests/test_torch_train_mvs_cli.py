"""The port's trainer CLI (python -m monohair_tpu_torch.train_mvs) on the CPU, on
tests/test_train_mvs_cli.py's case layout (2 views of 16x16 written by cv2, a
32x32x24 occupancy block): the stats columns, the checkpoint and --resume,
--holdout_cases, the written occ.npz loading through infer_inner's load_net,
and the case store's points against the JAX trainer's."""

import os

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import numpy as np
import pytest
import torch

from monohair_tpu_torch import train_mvs
from tests.test_train_mvs_cli import _build_case

torch.set_num_threads(1)


def common(tmp_path, calib, kind="occ", **flags):
    argv = [f"--data_root={tmp_path / 'data'}", f"--calib={calib}", f"--kind={kind}",
            "--batch=64", "--eval_every=2", "--save_every=100", f"--out={tmp_path / 'ckpt'}",
            "--device=cpu"]
    return argv + [f"--{k}={v}" for k, v in flags.items()]


def test_occ_stats_checkpoint_and_resume(tmp_path, rng):
    """4 steps: stats_occ.txt holds a row of 6 finite columns (train loss,
    precision, recall, then val's) at steps 0 and 2; occ.npz and
    occ_train.npz hold the net and step 4. --resume to 8 steps continues at
    step 4 (the restored net and Adam state are the saved ones) and appends
    two rows."""
    from monohair_tpu_torch.checkpoint import load_train_state
    from monohair_tpu_torch.models.pifu import OccAttn
    from monohair_tpu_torch.mvs.train import create_state
    calib = _build_case(tmp_path / "data", rng)
    out = tmp_path / "ckpt"
    first = train_mvs.main(common(tmp_path, calib, steps=4))
    stats = np.loadtxt(out / "stats_occ.txt", ndmin=2)
    assert stats.shape == (2, 6) and np.isfinite(stats).all()
    assert first["start"] == 0 and len(first["losses"]) == 4
    with np.load(out / "occ_train.npz") as data:
        assert int(data["step"]) == 4 and int(data["count"]) == 4
        assert {k.split("/")[0] for k in data.files} == {"mu", "nu", "count", "step"}

    restored = create_state(OccAttn(num_views=2), torch.Generator().manual_seed(5), 1e-4, 8)
    load_train_state(str(out), "occ", restored)
    with np.load(out / "occ.npz") as saved:
        for k, v in restored.model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)
    assert restored.step == 4 and restored.opt.count == 4

    second = train_mvs.main(common(tmp_path, calib, steps=8) + ["--resume"])
    assert second["start"] == 4 and len(second["losses"]) == 4
    stats2 = np.loadtxt(out / "stats_occ.txt", ndmin=2)
    assert stats2.shape == (4, 6) and np.array_equal(stats2[:2], stats)
    with np.load(out / "occ_train.npz") as data:
        assert int(data["step"]) == 8


def test_ori_stats(tmp_path, rng):
    """The ori trainer writes 2 columns (train L1, val L1) and ori.npz."""
    calib = _build_case(tmp_path / "data", rng)
    train_mvs.main(common(tmp_path, calib, kind="ori", steps=3))
    stats = np.loadtxt(tmp_path / "ckpt" / "stats_ori.txt", ndmin=2)
    assert stats.shape == (2, 2) and np.isfinite(stats).all()
    assert (tmp_path / "ckpt" / "ori.npz").exists()


def test_holdout_cases_train_on_the_first_cases_only(tmp_path, rng, monkeypatch, capsys):
    """--holdout_cases=1 over caseA and caseB: every batch is drawn from
    caseA, the val columns come from caseB alone."""
    calib = _build_case(tmp_path / "data", rng, case="caseA")
    _build_case(tmp_path / "data", rng, case="caseB")
    drawn = []
    real = train_mvs.balanced_batch

    def spy(entry, g, batch):
        drawn.append(id(entry))
        return real(entry, g, batch)

    monkeypatch.setattr(train_mvs, "balanced_batch", spy)
    store = {}
    real_get = train_mvs.CaseStore.get

    def get(self, case):
        entry = real_get(self, case)
        store[case] = id(entry)
        return entry

    monkeypatch.setattr(train_mvs.CaseStore, "get", get)
    train_mvs.main(common(tmp_path, calib, steps=3, holdout_cases=1))
    assert "1 training / 1 held-out cases" in capsys.readouterr().out
    assert len(drawn) == 3 and set(drawn) == {store["caseA"]}
    stats = np.loadtxt(tmp_path / "ckpt" / "stats_occ.txt", ndmin=2)
    assert stats.shape == (2, 6) and np.isfinite(stats).all()


def test_written_checkpoint_loads_in_infer_inner(tmp_path, rng):
    """occ.npz loads through load_net as it is, named by its file or by the
    tree directory <out>/occ (weights_path finds the .npz beside it), with the
    trained weights, and runs through deep_mvs_eval on the case's maps."""
    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.mvs.eval import deep_mvs_eval, load_mvs_inputs
    from monohair_tpu_torch.pipeline.infer_inner_stage import load_net
    calib = _build_case(tmp_path / "data", rng)
    out = tmp_path / "ckpt"
    train_mvs.main(common(tmp_path, calib, steps=2, eval_every=10))
    with np.load(out / "occ.npz") as saved:
        for path in (out / "occ.npz", out / "occ"):
            net = load_net(Config({"mvs": {"occ_model_path": str(path)}}), "occ", 2, "cpu")
            assert not net.training
            for k, v in net.state_dict().items():
                np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)
    ori = load_net(Config({"mvs": {}}), "ori", 2, "cpu")
    inputs, _ = load_mvs_inputs(str(tmp_path / "data" / "caseA"), str(calib), device="cpu")
    queries = rng.uniform(-0.1, 0.1, (64, 3)).astype(np.float32)
    pts, orients, occ = deep_mvs_eval(inputs, net, ori, query_points=queries, batch=64)
    assert occ.shape == (64,) and orients.shape == (64, 3) and np.isfinite(orients).all()


def test_case_store_samples_the_jax_trainers_points(tmp_path, rng):
    """The port's CaseStore and the JAX trainer's draw the same training points
    and targets (voxel samples bitwise, world points within 1e-7): their
    splits differ (the JAX seed is hash()-salted), so the union of train and
    val is compared, sorted."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import train_mvs as jtrainer
    calib = _build_case(tmp_path / "data", rng)
    for kind in ("occ", "ori"):
        t = train_mvs.CaseStore(str(tmp_path / "data"), str(calib), kind, 0.25,
                                device="cpu").get("caseA")
        j = jtrainer.CaseStore(str(tmp_path / "data"), str(calib), kind, 0.25).get("caseA")

        def union(e):
            pts = np.concatenate([e["train"][0], e["val"][0]])
            tg = np.concatenate([e["train"][1], e["val"][1]]).reshape(len(pts), -1)
            order = np.lexsort(pts.T)
            return pts[order], tg[order]

        (tp, tt), (jp, jt) = union(t), union(j)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(tt, jt)
        assert len(t["val"][0]) == int(len(tp) * 0.25)
        np.testing.assert_array_equal(t["inputs"].imgs.numpy(), np.asarray(j["inputs"].imgs))


def test_train_mvs_runs_on_the_card_unless_told_otherwise():
    """The trainer's device is the card unless --device says otherwise."""
    argv = ["--data_root=unused", "--calib=unused"]
    assert train_mvs.parse_args(argv).device == "cuda"
    assert train_mvs.parse_args(argv + ["--device=cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        train_mvs.parse_args(argv + ["--kind=bogus"])
