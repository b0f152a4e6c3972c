"""The port's one-process pipeline (python -m monohair_tpu_torch.run_pipeline)
against its four stage CLIs run one after another, on the CPU, on a 4-view
synthwig case with random full-width nets: the written refine/, full/ (with
connected_strands.hair) and ours/ files equal byte for byte. Also the stage
logger (monohair_tpu_torch.log) against the JAX package's metric lines."""

import json
import os

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import numpy as np
import pytest
import torch

from monohair_tpu_torch.io.yaml_io import dump_yaml
from monohair_tpu_torch.models.pifu import OccAttn, OriAttn, mvs_projection, random_init

torch.set_num_threads(1)

VIEWS = 4
STAGES = ("prepare_data", "pmvo", "infer_inner", "hair_grow")


def write_case(root, weights, margin=None):
    """A VIEWS-view synthwig case for the whole pipeline: prepare_data's steps
    off, PMVO.infer_inner on (HairGrow grows from full/), a small render and
    coarse queries, the depth maps at camera depth 1.08 (so the fuse finds
    queries seen by fewer than 3 views), its YAML at <root>/case.yaml."""
    from monohair_tpu_torch.synthetic import write_synthwig_case
    cfg = write_synthwig_case(os.path.join(root, "t"), num_views=VIEWS)
    cfg["prepare_data"] = dict.fromkeys(("select_images", "process_camera", "run_ngp",
                                         "fit_bust", "process_bust", "render_depth",
                                         "process_imgs"), False)
    cfg.PMVO["infer_inner"] = True
    cfg.mvs.update(occ_model_path=weights["occ"], ori_model_path=weights["ori"],
                   eval_vsize=0.08, eval_batch=512, occ_logit_margin=margin)
    cfg.infer_inner["render_size"] = [48, 40]
    case = os.path.join(root, "t", "synthwig")
    for name in os.listdir(os.path.join(case, "render_depth")):
        np.save(os.path.join(case, "render_depth", name),
                np.full((128, 128, 3), 1.08 / 2 * 255, np.float32))
    with open(os.path.join(root, "case.yaml"), "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    return case, cfg


def median_margin(root, case, cfg):
    """The occupancy margin that splits the case's MVS queries in half (after
    PMVO and the render), so that the fuse takes an interior."""
    from monohair_tpu_torch import PMVO, infer_inner
    from monohair_tpu_torch.mvs.eval import colmap_guided_queries, load_mvs_inputs
    from monohair_tpu_torch.pipeline.infer_inner_stage import load_net
    argv = ["--yaml=" + os.path.join(root, "case"), "--device=cpu"]
    PMVO.main(argv)
    infer_inner.main(argv + ["--infer_inner.run_mvs!"])
    inputs, _ = load_mvs_inputs(case, cfg.camera_path, device="cpu")
    net = load_net(cfg, "occ", VIEWS, "cpu")
    pts = torch.from_numpy(colmap_guided_queries(os.path.join(case, "ours/colmap_points.obj"),
                                                 vsize=0.08))
    coord, cam = mvs_projection(inputs.w2c, inputs.ndc, pts)
    with torch.no_grad():
        logits = net(inputs.imgs, pts, cam, coord)
    return float(torch.median(logits[:, 1] - logits[:, 0]))


def same_bytes(a, b, name):
    """Equal byte for byte; a .mat file's 116-byte text header holds its
    writing time (scipy's 'Created on: ...'), so it is compared from the
    header's end."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        da, db = fa.read(), fb.read()
    if name.endswith(".mat"):
        assert da[:116].startswith(b"MATLAB 5.0 MAT-file") and db[:116].startswith(
            b"MATLAB 5.0 MAT-file"), name
        da, db = da[116:], db[116:]
    return da == db


def files_under(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from monohair_tpu_torch import HairGrow, PMVO, infer_inner, prepare_data, run_pipeline
    tmp = tmp_path_factory.mktemp("pipeline")
    weights = {}
    for kind, cls, seed in (("occ", OccAttn, 3), ("ori", OriAttn, 4)):
        net = random_init(cls(num_views=VIEWS), torch.Generator().manual_seed(seed))
        weights[kind] = str(tmp / f"{kind}.pth")
        torch.save({"model_state_dict": net.state_dict()}, weights[kind])
    margin = median_margin(str(tmp / "m"), *write_case(str(tmp / "m"), weights))
    cases = {route: write_case(str(tmp / route), weights, margin)[0]
             for route in ("clis", "pipeline")}
    argv = ["--yaml=" + str(tmp / "clis" / "case"), "--device=cpu"]
    for cli in (prepare_data, PMVO, infer_inner, HairGrow):
        cli.main(argv)
    steps = run_pipeline.main(["--yaml=" + str(tmp / "pipeline" / "case"), "--device=cpu"])
    return cases, steps


@pytest.mark.parametrize("sub", ["output/verify/refine", "output/verify/full", "ours"])
def test_pipeline_writes_what_the_four_clis_write(runs, sub):
    """Every file the four CLIs wrote under refine/, full/ and ours/ is
    written by the pipeline, byte for byte (a .mat file after its header's
    time stamp); full/ holds a fused interior and connected_strands.hair."""
    cases, _ = runs
    a, b = (os.path.join(cases[r], sub) for r in ("clis", "pipeline"))
    names = files_under(a)
    assert names == files_under(b) and len(names) >= 2
    for name in names:
        assert same_bytes(os.path.join(a, name), os.path.join(b, name), name), name
    if sub.endswith("full"):
        assert "connected_strands.hair" in names
        assert len(np.load(os.path.join(b, "coarse.npy"))) > 0


def test_pipeline_logs_each_stages_seconds(runs):
    """metrics.jsonl beside the outputs holds stage/<name>/seconds for the four
    stages, in order; the pipeline returns each stage's steps."""
    cases, steps = runs
    with open(os.path.join(cases["pipeline"], "output/verify/metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["name"] for line in lines] == [f"stage/{s}/seconds" for s in STAGES]
    assert all(line["value"] >= 0 for line in lines)
    assert list(steps) == list(STAGES) and steps["prepare_data"] == {}
    assert set(steps["infer_inner"]) == {"segments", "render", "load", "mvs", "fuse"}


def test_log_matches_the_jax_loggers_lines(tmp_path):
    """The port's Log writes the JAX package's metric lines (test_misc's
    check); a stage with trace_dir writes a torch.profiler trace."""
    from monohair_tpu.log import Log as JLog
    from monohair_tpu_torch.log import Log
    lines = {}
    for name, cls in (("t", Log), ("j", JLog)):
        log = cls(metrics_path=str(tmp_path / name / "metrics.jsonl"))
        log.metric("stage/test/seconds", 1.5, extra=2)
        with log.stage("demo"):
            pass
        with open(tmp_path / name / "metrics.jsonl") as f:
            lines[name] = [json.loads(line) for line in f]
    for a, b in zip(lines["t"], lines["j"]):
        assert sorted(a) == sorted(b) and a["name"] == b["name"]
    assert lines["t"][0]["value"] == 1.5 and lines["t"][0]["extra"] == 2
    log = Log()
    with log.stage("traced", trace_dir=str(tmp_path / "trace"), device="cpu"):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "traced.json") as f:
        assert "traceEvents" in json.load(f)


def test_pipeline_runs_on_the_card_unless_told_otherwise(monkeypatch, tmp_path):
    """run_pipeline hands "cuda" to every stage unless --device says otherwise;
    only the arguments are looked at."""
    from monohair_tpu_torch import run_pipeline
    from monohair_tpu_torch.config import Config
    seen = []
    cfg = Config({"output_path": str(tmp_path)})
    monkeypatch.setattr(run_pipeline, "resolve_config", lambda argv: cfg)
    monkeypatch.setattr(run_pipeline, "STAGES", tuple(
        (name, lambda args, device, n=name: seen.append((n, device))) for name in STAGES))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    run_pipeline.main(["--yaml=unused"])
    run_pipeline.main(["--yaml=unused", "--device=cpu"])
    assert seen == [(s, "cuda") for s in STAGES] + [(s, "cpu") for s in STAGES]
