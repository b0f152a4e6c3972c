#!/usr/bin/env python
"""Write a capture case and run the port's whole pipeline on it through its
CLI, every step on at the shipped budgets, then print what each stage did.

    python tools/run_capture_case.py [--frames 32] [--size 720x1280] [--device cuda]
        [--out DIR] [--log FILE] [--set KEY=VALUE ...]

The case (synthetic.write_capture_case, frame_interval 2): the orbit's frames,
the shipped hair-parser weights (trained/hair_parser), the bust fit's assets
at the official SMPL-X sizes with annotations from truth
(synthetic.write_bust_fit_assets, optimize.iter 2000), the shipped MVS nets
(trained/mvs/{occ,ori}.npz, their margin in occ_margin.json beside them) and
PMVO.infer_inner on, so HairGrow grows from full/. Then

    python -m monohair_tpu_torch.run_pipeline --yaml=<case> --device=<device>

runs in a child process with every step of prepare_data on (the NeRF at
ngp's shipped 4000 steps, the fit, the depth maps, the masks and Gabor),
then PMVO, infer_inner and HairGrow; its output goes to --log (default
<out>/run_pipeline.log). `--set KEY=VALUE` sets a key of the case's config
before it is written (dotted, the value read as JSON, else as a string), for
example `--set ngp.train_steps=2000` or, for a rehearsal on the CPU,
`--set prepare_data.run_ngp=false`.

Printed after the run: each stage's seconds and peak device memory
(<output>/metrics.jsonl), prepare_data's steps, PMVO's candidates after each
of its filters, the share of its surface points on the true hair cap,
connect_all_segments' free segments and ms a segment, the strands of
full/connected_strands.hair and the child's peak host memory; then, as the
last line, one JSON object of all of it. Exits non-zero if the pipeline
fails or grows no strand.

On one H100 (~20 min at 32 frames of 1280x720):

    python3 tools/run_capture_case.py --log run_capture_case.log
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from monohair_tpu_torch.io.hair_io import load_hair  # noqa: E402
from monohair_tpu_torch.io.yaml_io import dump_yaml  # noqa: E402
from monohair_tpu_torch.pipeline.common import load_pmvo_maps, resolve_config  # noqa: E402
from monohair_tpu_torch.pmvo.points import load_colmap_points  # noqa: E402
from monohair_tpu_torch.pmvo.solver import filter_masks  # noqa: E402
from monohair_tpu_torch.synthetic import (SMPLX_OFFICIAL,  # noqa: E402
                                          capture_cap_share_of_points, write_bust_fit_assets,
                                          write_capture_case)

WEIGHTS = os.path.join(REPO, "trained")
PREPARE_STEPS = ("select_images", "process_camera", "run_ngp", "fit_bust", "process_bust",
                 "render_depth", "process_imgs")
FILTER_CHUNK = 65536


def set_key(cfg, dotted: str, value: str) -> None:
    """cfg[a][b]... = value, parsed as JSON where it parses."""
    try:
        value = json.loads(value)
    except ValueError:
        pass
    *parents, last = dotted.split(".")
    for key in parents:
        if key not in cfg or cfg[key] is None:
            cfg[key] = {}
        cfg = cfg[key]
    cfg[last] = value


def write_case(out: str, frames: int, H: int, W: int, sets) -> str:
    """The capture case under `out`; returns its YAML path without .yaml."""
    parser = os.path.join(WEIGHTS, "hair_parser")
    written = write_capture_case(out, "capture", frames, H, W, frame_interval=2,
                                 modnet=os.path.join(parser, "modnet.npz"),
                                 parser=os.path.join(parser, "bisenet.npz"))
    cfg = written["config"]
    write_bust_fit_assets(os.path.join(out, "capture"), cfg, written["mvs_poses"], H, W,
                          sizes=SMPLX_OFFICIAL)
    cfg["prepare_data"] = dict.fromkeys(PREPARE_STEPS, True)
    cfg.PMVO["infer_inner"] = True
    cfg.mvs.update(occ_model_path=os.path.join(WEIGHTS, "mvs", "occ.npz"),
                   ori_model_path=os.path.join(WEIGHTS, "mvs", "ori.npz"))
    for item in sets:
        key, _, value = item.partition("=")
        set_key(cfg, key, value)
    yaml = os.path.join(out, "case")
    with open(yaml + ".yaml", "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    return yaml


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_child(yaml: str, device: str, log_path: str) -> tuple:
    """run_pipeline's CLI in a child process, its output teed to log_path;
    returns (exit code, wall seconds, the lines it printed)."""
    cmd = [sys.executable, "-m", "monohair_tpu_torch.run_pipeline", "--yaml=" + yaml,
           f"--device={device}"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    lines = []
    t = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, bufsize=1)
        for line in proc.stdout:
            log.write(line)
            lines.append(line.rstrip("\n"))
        code = proc.wait()
    return code, time.perf_counter() - t, lines


def read_stage_metrics(output_path: str) -> dict:
    """{stage: {"seconds", "peak_bytes" (on a card)}} from metrics.jsonl."""
    out = {}
    with open(os.path.join(output_path, "metrics.jsonl")) as f:
        for line in f:
            m = json.loads(line)
            out[m["name"].split("/")[1]] = {"seconds": m["value"],
                                            "peak_bytes": m.get("peak_bytes")}
    return out


def printed_steps(lines) -> dict:
    """The steps' seconds the stages printed: prepare_data's summary, the
    NeRF's parts, PMVO's, infer_inner's and HairGrow's `[stage] step: Xs`
    lines, and connect_all_segments' segments."""
    out = {"prepare_data": {}, "pmvo": {}, "hair_grow": {}}
    for line in lines:
        if line.startswith("[prepare_data] done in") and ":" in line:
            for part in line.split(": ", 1)[1].split(", "):
                name, sec = part.rsplit(" ", 1)
                out["prepare_data"][name] = float(sec.rstrip("s"))
        elif line.startswith("[ngp] train"):
            out["ngp"] = {k: float(v) for k, v in re.findall(r"(\w+) ([\d.]+)s", line)}
        elif m := re.match(r"\[(pmvo|hair_grow)\] (\w+): ([\d.]+)s$", line):
            out[m.group(1)][m.group(2)] = float(m.group(3))
        elif m := re.match(r"\[hair_grow\] connect_all_segments: (\d+) free segments in "
                           r"([\d.]+)s", line):
            out["connect_all_segments"] = {"segments": int(m.group(1)),
                                           "seconds": float(m.group(2))}
        elif m := re.match(r"(total|process) points: (\d+)", line):
            out["pmvo"][m.group(1) + "_points"] = int(m.group(2))
    return out


def survivors(yaml: str, device: str) -> tuple:
    """PMVO's candidates after each of its filters, on `device`
    (pmvo/solver.py::filter_masks), and the args."""
    args = resolve_config(["--yaml=" + yaml])
    maps, _ = load_pmvo_maps(args, device)
    points = load_colmap_points(os.path.join(args.data.root, args.data.raw_points_path),
                                num_per_grid=args.PMVO.num_sample_per_grid)
    counts = np.zeros(4, np.int64)
    counts[0] = len(points)
    for beg in range(0, len(points), FILTER_CHUNK):
        k = filter_masks(maps, torch.from_numpy(points[beg:beg + FILTER_CHUNK]).to(device),
                         args.PMVO.patch_size, args.PMVO.conf_threshold,
                         args.PMVO.visible_threshold)
        seen, confident, hair = k["seen"], ~k["low_conf"], k["hair"]
        counts[1:] += [int(seen.sum()), int((seen & confident).sum()),
                       int((seen & confident & hair).sum())]
    return dict(zip(("loaded", "seen in > 1 views", "and not low-confidence in > 4",
                     "and on the hair mask in >= half"), counts.tolist())), args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", default="720x1280", help="HxW of the frames")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="the case's directory (default: a temporary one, removed)")
    ap.add_argument("--log", help="run_pipeline's output (default <out>/run_pipeline.log)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    opts = ap.parse_args(argv)
    if torch.device(opts.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device=cpu for a rehearsal on the host", file=sys.stderr)
        return 2
    H, W = (int(x) for x in opts.size.lower().split("x"))
    out = opts.out or tempfile.mkdtemp(prefix="capture_case_")
    os.makedirs(out, exist_ok=True)
    try:
        if torch.device(opts.device).type == "cuda":
            print(f"card: {card_line()} ({torch.cuda.get_device_name(0)})", flush=True)
        t = time.perf_counter()
        yaml = write_case(out, opts.frames, H, W, opts.set)
        written_s = time.perf_counter() - t
        print(f"capture case: {opts.frames} frames at {W}x{H} written in {written_s:.2f} s "
              f"({out})", flush=True)
        log_path = opts.log or os.path.join(out, "run_pipeline.log")
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        code, wall, lines = run_child(yaml, opts.device, log_path)
        host_peak = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
        if code != 0:
            print("\n".join(lines[-40:]))
            print(f"run_pipeline exited with {code} after {wall:.1f} s (log: {log_path})")
            return 1
        kept, args = survivors(yaml, opts.device)
        output = args.output_path
        stages = read_stage_metrics(output)
        steps = printed_steps(lines)
        surface = np.load(os.path.join(output, "optimize", "surface.npy"))
        cap_share = capture_cap_share_of_points(args.data.root, surface)
        segments, points = load_hair(os.path.join(output, "full", "connected_strands.hair"))
        connect = steps.get("connect_all_segments", {})
        ms_a_segment = connect.get("seconds", 0.0) / max(connect.get("segments", 0), 1) * 1e3
        result = dict(frames=opts.frames, size=[H, W], device=opts.device, wall_s=wall,
                      stages=stages, steps=steps, survivors=kept, surface_on_cap=cap_share,
                      connect_ms_a_segment=ms_a_segment, strands=len(segments),
                      strand_points=len(points), finite=bool(np.isfinite(points).all()),
                      host_peak_bytes=host_peak)
        print(f"run_pipeline: {wall:.1f} s; host peak memory {host_peak / 2**30:.3f} GiB")
        for name, m in stages.items():
            peak = m["peak_bytes"]
            print(f"  {name}: {m['seconds']} s, peak device memory "
                  f"{'n/a' if peak is None else f'{peak / 2**30:.3f} GiB'}")
        for name in ("prepare_data", "ngp", "pmvo", "hair_grow"):
            if steps.get(name):
                print(f"  {name} steps: {json.dumps(steps[name])}")
        print("PMVO's candidates through its filters: " + ", ".join(
            f"{k} {v}" for k, v in kept.items()))
        print(f"PMVO's surface points on the true hair cap: {cap_share:.4f} of {len(surface)}")
        print(f"connect_all_segments: {connect.get('segments')} free segments in "
              f"{connect.get('seconds')} s = {ms_a_segment:.3f} ms a segment")
        print(f"full/connected_strands.hair: {len(segments)} strands, {len(points)} points, "
              f"finite {result['finite']}")
        if torch.device(opts.device).type == "cuda":
            print(card_line())
        print(json.dumps(result), flush=True)
        return 0 if len(segments) and result["finite"] else 1
    finally:
        if not opts.out:
            shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
