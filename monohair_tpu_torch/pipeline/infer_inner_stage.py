"""Stage 3 — interior inference (port of monohair_tpu/pipeline/infer_inner_stage.py;
reference infer_inner.py :30-90).

render_data: trace temporary render segments from the refined field and
rasterize the 4 per-view maps; run_mvs: stream the query points through the
occ/ori nets; then fuse interior and exterior by running the PMVO refine
branch as a function call (the reference shells out to PMVO.py,
infer_inner.py:89-90).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import torch

from ..config import Config
from ..constants import BUST_TO_ORIGIN
from ..coords import voxel_to_world, world_dir_to_voxel
from ..io.cameras_io import load_cam_params, subsample_views
from ..io.hair_io import save_hair
from ..io.mat_io import load_occ_mat, load_ori_mat
from ..io.mesh_io import load_obj
from ..models.convert import load_weights, read_state_dict, weights_path
from ..models.pifu import OccAttn, OriAttn, random_init
from ..mvs.eval import colmap_guided_queries, deep_mvs_eval, load_mvs_inputs
from ..pmvo.driver import exact_f32
from ..render import render_data
from ..strands.trace import generate_segments
from .pmvo_stage import run_pmvo

def render_segments(args: Config, device="cuda") -> list:
    """Strands traced through refine/{Occ3D,Ori3D}.mat in world coordinates
    (no bust shift), also saved as refine/render_segments.hair."""
    refine_path = os.path.join(args.output_path, "refine")
    occ = torch.as_tensor(load_occ_mat(os.path.join(refine_path, "Occ3D.mat")), device=device)
    ori_voxel = world_dir_to_voxel(torch.as_tensor(
        load_ori_mat(os.path.join(refine_path, "Ori3D.mat")), device=device))
    segs = generate_segments(occ, ori_voxel, thr_dot=0.8, sweeps=3)
    strands = [voxel_to_world(torch.from_numpy(s)).numpy() for s in segs]
    save_hair(os.path.join(refine_path, "render_segments.hair"), strands)
    return strands


def load_net(args: Config, kind: str, num_views: int, device="cuda") -> torch.nn.Module:
    """The occ or ori net with the weights of `mvs.<kind>_model_path`: a
    ``.npz`` or ``.pth`` file, or an orbax tree's path through the ``.npz``
    beside it (`weights_path`); a path that does not exist gives random
    weights (with a warning), as in the JAX package; so does no path."""
    model = (OccAttn if kind == "occ" else OriAttn)(num_views=num_views)
    ckpt = args.get("mvs", {}).get(f"{kind}_model_path")
    if ckpt and os.path.exists(weights_path(ckpt)):
        load_weights(model, read_state_dict(weights_path(ckpt)))
    else:
        if ckpt:
            print(f"[infer_inner] WARNING: {kind}_model_path={ckpt} does not "
                  "exist — falling back to RANDOM-INIT weights", flush=True)
        random_init(model, torch.Generator().manual_seed(0 if kind == "occ" else 1))
    return model.to(device).eval()


def occ_margin(args: Config) -> float:
    """The occ decision threshold: an explicit `mvs.occ_logit_margin` wins;
    else the margin of occ_margin.json beside the occ checkpoint, else 0.0."""
    margin = args.get("mvs", {}).get("occ_logit_margin")
    if margin is not None and margin != "":
        return float(margin)
    occ_dir = args.get("mvs", {}).get("occ_model_path") or ""
    sidecar = os.path.join(os.path.dirname(occ_dir.rstrip("/")),
                           "occ_margin.json") if occ_dir else ""
    if sidecar and os.path.exists(sidecar):
        with open(sidecar) as f:
            margin = float(json.load(f)["margin"])
        print(f"[infer_inner] occ logit margin {margin:.3f} ({sidecar})")
        return margin
    return 0.0


def run_infer_inner(args: Config, device="cuda", mesh=None) -> Dict[str, float]:
    """Render the MVS maps from refine/, run the nets into ours/, fuse into
    full/{Occ3D,Ori3D}.mat, as the infer_inner flags ask. Runs on `device`
    (the card unless the caller asks for "cpu"); the MVS batches and the fuse's
    points are sharded over `mesh` (a tuple of devices) when given. Returns the
    wall seconds of each step."""
    exact_f32()
    t0 = time.monotonic()
    steps: Dict[str, float] = {}

    def step(name: str, t: float) -> float:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        now = time.monotonic()
        steps[name] = now - t
        print(f"[infer_inner] {name}: {steps[name]:.2f}s", flush=True)
        return now

    root = args.data.root
    t = t0
    if args.infer_inner.render_data:
        strands = render_segments(args, device)
        t = step("segments", t)
        bust_v, bust_f = load_obj(os.path.join(root, args.data.bust_path))
        names, cams = load_cam_params(args.camera_path, device)
        names, cams = subsample_views(names, cams)
        rsize = tuple(args.infer_inner.get("render_size", [1280, 720]))
        render_data(cams, names, strands, bust_v + BUST_TO_ORIGIN, bust_f, rsize,
                    os.path.join(root, "imgs"))
        t = step("render", t)

    if args.infer_inner.run_mvs:
        mvs = args.get("mvs", {})
        inputs, _ = load_mvs_inputs(root, args.camera_path, device=device)
        V = inputs.imgs.shape[0]
        occ_model = load_net(args, "occ", V, device)
        ori_model = load_net(args, "ori", V, device)
        vsize = float(mvs.get("eval_vsize", 0.005))
        # colmap-guided fine sampling (EvalDataset.py:39-52): on by default
        # whenever the coarse mesh exists, like the reference real-data config
        queries = None
        colmap_path = os.path.join(root, "ours", "colmap_points.obj")
        if mvs.get("use_colmap_points", True) and os.path.exists(colmap_path):
            queries = colmap_guided_queries(colmap_path, vsize=vsize)
            print(f"[infer_inner] colmap-guided queries: {len(queries)}")
        t = step("load", t)
        deep_mvs_eval(inputs, occ_model, ori_model, save_folder=os.path.join(root, "ours"),
                      query_points=queries, batch=int(mvs.get("eval_batch", 32768)),
                      vsize=vsize, occ_margin=occ_margin(args), mesh=mesh)
        del inputs, occ_model, ori_model
        t = step("mvs", t)

        fuse_args = Config(args.to_dict())
        fuse_args.PMVO["infer_inner"] = True
        fuse_args.PMVO["optimize"] = False
        run_pmvo(fuse_args, device=device, mesh=mesh)
        step("fuse", t)
    print(f"[infer_inner] done in {time.monotonic() - t0:.1f}s")
    return steps
