#!/usr/bin/env python
"""Follow a capture case's candidate points through PMVO, then run the rest of
the pipeline: where do the points go?

    python tools/trace_capture_points.py [num_frames] [--jax]

Writes a small capture case (tools/check_capture_camera_roll.py's: 16 frames
at 96x128 by default, the port's writer, the shipped hair-parser weights) in a
temp directory and runs the port's prepare_data on the CPU with run_ngp and
fit_bust off (the case's head sphere stands in for the NeRF's mesh, the
identity for the fit). Then it prints:
- the candidate points that survive each of PMVO's filters in turn
  (solver.filter_masks: seen in more than one view at the 0.1 depth
  tolerance; not low-confidence in more than 4 of them; on the hair mask in
  at least half of them);
- for each view, the share of the candidates in its frame that land on its
  hair mask, under PMVO's pixel convention (camera.ndc_to_pixel) and under the
  renderer's GL flip;
- then it runs PMVO, infer_inner (random nets: the shipped ones hold 16
  views, the case has num_frames / 2) and HairGrow through the port's
  run_pipeline and prints the strands of full/connected_strands.hair.
With --jax it also runs the JAX package's PMVO on the same files and prints
its survivors (needs JAX).
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from monohair_tpu_torch import prepare_data, run_pipeline  # noqa: E402
from monohair_tpu_torch.camera import ndc_to_pixel, project  # noqa: E402
from monohair_tpu_torch.io.hair_io import load_hair  # noqa: E402
from monohair_tpu_torch.io.yaml_io import dump_yaml  # noqa: E402
from monohair_tpu_torch.ops.rasterize import _pixel_from_ndc  # noqa: E402
from monohair_tpu_torch.pipeline.common import load_pmvo_maps, resolve_config  # noqa: E402
from monohair_tpu_torch.pmvo.points import load_colmap_points  # noqa: E402
from monohair_tpu_torch.pmvo.solver import filter_masks  # noqa: E402
from monohair_tpu_torch.synthetic import write_capture_case  # noqa: E402

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "trained", "hair_parser")


def filter_survivors(maps, points, patch, conf_thr, visible_thr):
    """The candidates left after each of PMVO's surface filters, in turn
    (solver.filter_masks, which solver.filter_points combines)."""
    k = filter_masks(maps, torch.from_numpy(points), patch, conf_thr, visible_thr)
    seen, confident, hair = k["seen"], ~k["low_conf"], k["hair"]
    return [("loaded", len(points)), ("seen in > 1 views", int(seen.sum())),
            ("and not low-confidence in > 4", int((seen & confident).sum())),
            ("and on the hair mask in >= half", int((seen & confident & hair).sum()))]


def mask_shares(maps, points):
    """Per view: (in-frame candidates, share on the hair mask under PMVO's
    convention, share under the renderer's GL flip)."""
    H, W = maps.image_size
    uv, z = project(maps.cameras, torch.from_numpy(points))
    rows = []
    for v in range(uv.shape[0]):
        mask = maps.mask[v] > 0.5
        shares, n = [], 0
        for rc in (ndc_to_pixel(uv[v], (H, W)), _pixel_from_ndc(uv[v], (H, W))):
            rc = rc.floor().long()
            ok = (rc[:, 0] >= 0) & (rc[:, 0] < H) & (rc[:, 1] >= 0) & (rc[:, 1] < W)
            n = max(n, int(ok.sum()))
            shares.append(float(mask[rc[ok, 0], rc[ok, 1]].float().mean()) if ok.any() else 0.0)
        rows.append((n, *shares))
    return rows


def main(num_frames: int = 16, H: int = 96, W: int = 128, with_jax: bool = False) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_capture_case(tmp, "cap", num_frames=num_frames, H=H, W=W,
                                 modnet=os.path.join(WEIGHTS, "modnet.npz"),
                                 parser=os.path.join(WEIGHTS, "bisenet.npz"))["config"]
        cfg.PMVO["infer_inner"] = True
        cfg.infer_inner["render_size"] = [96, 64]
        cfg.mvs["eval_vsize"] = 0.02
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        argv = ["--yaml=" + os.path.join(tmp, "case"), "--device=cpu",
                "--prepare_data.run_ngp=", "--prepare_data.fit_bust="]
        prepare_data.main(argv)
        args = resolve_config(argv[:1] + argv[2:])
        maps, names = load_pmvo_maps(args, "cpu")
        points = load_colmap_points(os.path.join(args.data.root, args.data.raw_points_path),
                                    num_per_grid=args.PMVO.num_sample_per_grid)
        print(f"PMVO's candidates through its filters ({len(names)} views of {H}x{W}):")
        for what, n in filter_survivors(maps, points, args.PMVO.patch_size,
                                        args.PMVO.conf_threshold,
                                        args.PMVO.visible_threshold):
            print(f"  {what}: {n}")
        print("per view: in-frame candidates, share on the hair mask (PMVO convention, "
              "GL flip)")
        for name, (n, pmvo, gl) in zip(names, mask_shares(maps, points)):
            print(f"  {name}: {n} in frame, {pmvo:.3f} (PMVO), {gl:.3f} (GL)")
        if with_jax:
            import jax
            jax.config.update("jax_platforms", "cpu")
            from monohair_tpu.config import Config as JConfig
            from monohair_tpu.pipeline.pmvo_stage import run_pmvo as jax_pmvo
            jargs = JConfig(args.to_dict())
            jargs["output_path"] = os.path.join(tmp, "jax_out")
            jargs.PMVO["infer_inner"] = False
            os.makedirs(jargs.output_path, exist_ok=True)
            jax_pmvo(jargs)
            surface = np.load(os.path.join(jargs.output_path, "optimize", "surface.npy"))
            print(f"the JAX package's PMVO keeps {len(surface)} surface points")
        run_pipeline.main(argv + ["--prepare_data.select_images=",
                                  "--prepare_data.process_camera=",
                                  "--prepare_data.process_bust=",
                                  "--prepare_data.render_depth=",
                                  "--prepare_data.process_imgs="])
        segments, pts = load_hair(os.path.join(args.output_path, "full",
                                               "connected_strands.hair"))
        print(f"full/connected_strands.hair: {len(segments)} strands, {len(pts)} points")


if __name__ == "__main__":
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    nums = [int(a) for a in sys.argv[1:] if not a.startswith("--")]
    main(*nums[:1], with_jax="--jax" in flags)
