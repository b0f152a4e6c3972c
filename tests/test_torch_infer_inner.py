"""The port's stage 3 (python -m monohair_tpu_torch.infer_inner) against the JAX
package's stage on a written synthwig case, on the CPU, with the same .pth
weights in both: the rendered maps, ours/{voxels.dat,raw.npy,Voxel_hair} and
the fused full/{Occ3D,Ori3D}.mat. Also the weight and margin lookups."""

import json
import os
import shutil

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import numpy as np
import pytest
import torch

from monohair_tpu_torch.io.image_io import read_png
from monohair_tpu_torch.io.mat_io import load_occ_mat, load_ori_mat
from monohair_tpu_torch.io.voxels_io import load_voxels_dat
from monohair_tpu_torch.models.pifu import OccAttn, OriAttn, random_init
from monohair_tpu_torch.render import MAP_NAMES

torch.set_num_threads(1)

VIEWS = 8


def write_case(tmp_path):
    """A synthwig case of VIEWS views after the port's PMVO, its YAML, and
    full-width random weights as .pth files."""
    from monohair_tpu_torch.io.yaml_io import dump_yaml
    from monohair_tpu_torch.pipeline.common import case_paths
    from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
    from monohair_tpu_torch.synthetic import write_synthwig_case
    cfg = write_synthwig_case(str(tmp_path / "t"), num_views=VIEWS)
    for kind, cls, seed in (("occ", OccAttn, 3), ("ori", OriAttn, 4)):
        net = random_init(cls(num_views=VIEWS), torch.Generator().manual_seed(seed))
        torch.save({"model_state_dict": net.state_dict()}, tmp_path / f"{kind}.pth")
        cfg.mvs[f"{kind}_model_path"] = str(tmp_path / f"{kind}.pth")
    cfg.mvs.update(eval_vsize=0.08, eval_batch=256)
    cfg.infer_inner.render_size = [64, 48]
    with open(tmp_path / "case.yaml", "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    run_pmvo(case_paths(type(cfg)(cfg.to_dict())), device="cpu")
    return cfg


def jax_config(cfg, root_from, root_to, **infer_inner):
    from monohair_tpu.config import Config
    from monohair_tpu_torch.pipeline.common import case_paths
    d = json.loads(json.dumps(case_paths(type(cfg)(cfg.to_dict())).to_dict())
                   .replace(root_from, root_to))
    d["infer_inner"].update(infer_inner)
    return Config(d)


def margin_at_median(cfg, case_dir):
    """The occupancy margin that splits the MVS queries of the rendered maps
    in half, so that both decisions occur."""
    from monohair_tpu_torch.models.pifu import mvs_projection
    from monohair_tpu_torch.mvs.eval import colmap_guided_queries, load_mvs_inputs
    from monohair_tpu_torch.pipeline.infer_inner_stage import load_net
    inputs, _ = load_mvs_inputs(case_dir, cfg.camera_path, device="cpu")
    net = load_net(cfg, "occ", VIEWS, "cpu")
    pts = torch.from_numpy(colmap_guided_queries(
        os.path.join(case_dir, "ours/colmap_points.obj"), vsize=cfg.mvs.eval_vsize))
    coord, cam = mvs_projection(inputs.w2c, inputs.ndc, pts)
    with torch.no_grad():
        logits = net(inputs.imgs, pts, cam, coord)
    return float(torch.median(logits[:, 1] - logits[:, 0]))


def test_stage_cli_matches_the_jax_stage(tmp_path):
    from monohair_tpu.pipeline.infer_inner_stage import run_infer_inner as j_run
    from monohair_tpu_torch import infer_inner as cli
    cfg = write_case(tmp_path)
    t_case, j_case = tmp_path / "t" / "synthwig", tmp_path / "j" / "synthwig"
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    yaml_arg = "--yaml=" + str(tmp_path / "case")

    # render: the four maps of every view
    cli.main([yaml_arg, "--device=cpu", "--infer_inner.run_mvs!"])
    j_run(jax_config(cfg, str(tmp_path / "t"), str(tmp_path / "j"), run_mvs=False))
    views = sorted(os.listdir(t_case / "imgs"))
    assert len(views) == VIEWS and (t_case / "output/verify/refine/render_segments.hair").exists()
    for view in views:
        for name in MAP_NAMES:
            a = read_png(str(t_case / "imgs" / view / f"{name}.png")).astype(int)
            b = read_png(str(j_case / "imgs" / view / f"{name}.png")).astype(int)
            assert a.shape[:2] == (64, 48)
            assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1, (view, name)
    assert read_png(str(t_case / "imgs" / views[0] / "mask.png")).any()

    # MVS and fuse, both on the JAX stage's maps; the depth maps move nearer
    # (camera depth 1.08 instead of 1.81), so that the fuse finds queries
    # seen by fewer than 3 views
    shutil.rmtree(t_case / "imgs")
    shutil.copytree(j_case / "imgs", t_case / "imgs")
    for case in (t_case, j_case):
        for name in os.listdir(case / "render_depth"):
            np.save(case / "render_depth" / name, np.full((128, 128, 3), 1.08 / 2 * 255, np.float32))
    margin = margin_at_median(cfg, str(t_case))
    cli.main([yaml_arg, "--device=cpu", "--infer_inner.render_data!",
              f"--mvs.occ_logit_margin={margin!r}"])
    jcfg = jax_config(cfg, str(tmp_path / "t"), str(tmp_path / "j"), render_data=False)
    jcfg.mvs["occ_logit_margin"] = margin
    j_run(jcfg)

    raw_t, raw_j = np.load(t_case / "ours/raw.npy"), np.load(j_case / "ours/raw.npy")
    assert raw_t.shape == raw_j.shape and raw_t.shape[0] > 200
    np.testing.assert_array_equal(raw_t[:, :3], raw_j[:, :3])
    assert (raw_t[:, 6] == raw_j[:, 6]).mean() >= 0.999 and 0.3 < raw_t[:, 6].mean() < 0.7
    np.testing.assert_allclose(raw_t[:, 3:6], raw_j[:, 3:6], rtol=1e-4, atol=1e-5)
    vt, vj = (load_voxels_dat(str(c / "ours/voxels.dat")) for c in (t_case, j_case))
    for a, b in zip(vt[2:], vj[2:]):
        np.testing.assert_array_equal(a, b)
    assert len(vt[0]) == int(raw_t[:, 6].sum()) and abs(len(vt[0]) - len(vj[0])) <= 1
    for sub in ("ours/Voxel_hair", "output/verify/full"):
        occ_t, occ_j = (load_occ_mat(str(c / sub / "Occ3D.mat")) for c in (t_case, j_case))
        ori_t, ori_j = (load_ori_mat(str(c / sub / "Ori3D.mat")) for c in (t_case, j_case))
        both = (occ_t > 0) & (occ_j > 0)
        assert both.sum() >= 0.999 * max((occ_t > 0).sum(), (occ_j > 0).sum()) > 0, sub
        np.testing.assert_allclose(ori_t[both], ori_j[both], rtol=1e-4, atol=1e-5)
    # the MVS-positive queries seen by fewer than 3 views are the fused interior
    assert len(np.load(t_case / "output/verify/full/coarse.npy")) > 0
    for name in ("coarse.npy", "coarse_ori.npy"):
        np.testing.assert_allclose(np.load(t_case / "output/verify/full" / name),
                                   np.load(j_case / "output/verify/full" / name),
                                   rtol=1e-4, atol=1e-5)


def test_weights_and_margin_lookups(tmp_path, capsys):
    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.pipeline.infer_inner_stage import load_net, occ_margin
    net = random_init(OccAttn(num_views=2), torch.Generator().manual_seed(9))
    (tmp_path / "mvs").mkdir()
    np.savez(tmp_path / "mvs" / "occ.npz", **{k: v.numpy() for k, v in net.state_dict().items()})
    (tmp_path / "mvs" / "occ").mkdir()                      # an orbax tree's directory
    with open(tmp_path / "mvs" / "occ_margin.json", "w") as f:
        json.dump({"margin": 0.25}, f)
    cfg = Config({"mvs": {"occ_model_path": str(tmp_path / "mvs" / "occ"),
                          "ori_model_path": str(tmp_path / "nowhere.pth"),
                          "occ_logit_margin": None}})
    loaded = load_net(cfg, "occ", 2, "cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in net.state_dict().items())
    assert occ_margin(cfg) == 0.25
    cfg.mvs["occ_logit_margin"] = -0.5
    assert occ_margin(cfg) == -0.5
    a, b = load_net(cfg, "ori", 2, "cpu"), load_net(cfg, "ori", 2, "cpu")
    assert "RANDOM-INIT" in capsys.readouterr().out
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    shutil.rmtree(tmp_path / "mvs" / "occ")
    os.remove(tmp_path / "mvs" / "occ.npz")
    (tmp_path / "mvs" / "occ").mkdir()
    with pytest.raises(FileNotFoundError, match="export_mvs_weights"):
        load_net(cfg, "occ", 2, "cpu")
    cfg.mvs["occ_model_path"] = None
    cfg.mvs["occ_logit_margin"] = ""
    assert occ_margin(cfg) == 0.0
