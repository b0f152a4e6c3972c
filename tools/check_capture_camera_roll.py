#!/usr/bin/env python
"""Check which pixel convention maps the capture case's MVS cameras onto its
frames: the true hair cap (the head sphere's points within 50 degrees of the
NeRF frame's up axis, taken through the pose chain to the MVS frame) is
projected with every view of ours/cam_params.json, through the PMVO
convention (camera.ndc_to_pixel) and the renderer's (GL flip), and the share
of its pixels on the frame's hair label is printed for each.

    python tools/check_capture_camera_roll.py [num_frames]

Runs the port's prepare_data CLI (select_images and process_camera only) on
the CPU on a small capture case in a temp directory.
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from monohair_tpu_torch import prepare_data  # noqa: E402
from monohair_tpu_torch.camera import project, ndc_to_pixel  # noqa: E402
from monohair_tpu_torch.constants import BUST_TO_ORIGIN  # noqa: E402
from monohair_tpu_torch.io.cameras_io import load_cam_params  # noqa: E402
from monohair_tpu_torch.io.image_io import read_png  # noqa: E402
from monohair_tpu_torch.io.yaml_io import dump_yaml  # noqa: E402
from monohair_tpu_torch.nerf.poses import convert_mesh_nerf_to_mvs  # noqa: E402
from monohair_tpu_torch.ops.rasterize import _pixel_from_ndc  # noqa: E402
from monohair_tpu_torch.synthetic import (CAPTURE_HEAD_R_NERF, uv_sphere,  # noqa: E402
                                          write_capture_case)


def main(num_frames: int = 16, H: int = 96, W: int = 128) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_capture_case(tmp, "cap", num_frames=num_frames, H=H, W=W)["config"]
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        prepare_data.main(["--yaml=" + os.path.join(tmp, "case"), "--device=cpu",
                           "--prepare_data.run_ngp=", "--prepare_data.fit_bust=",
                           "--prepare_data.process_bust=", "--prepare_data.render_depth=",
                           "--prepare_data.process_imgs="])
        case = os.path.join(tmp, "cap")
        cap, _ = uv_sphere(CAPTURE_HEAD_R_NERF, max_polar_deg=50.0)
        cap = convert_mesh_nerf_to_mvs(cap, os.path.join(case, "colmap"),
                                       os.path.join(case, "calib_cam_params.json")) + BUST_TO_ORIGIN
        names, cams = load_cam_params(os.path.join(case, "ours", "cam_params.json"), "cpu")
        uv, _ = project(cams, torch.tensor(cap, dtype=torch.float32))
        for v, name in enumerate(names):
            hair = read_png(os.path.join(case, "labels", "hair", name + ".png")) > 127
            shares = []
            for rc in (ndc_to_pixel(uv[v], (H, W)), _pixel_from_ndc(uv[v], (H, W))):
                rc = rc.numpy().astype(int)
                ok = (rc[:, 0] >= 0) & (rc[:, 0] < H) & (rc[:, 1] >= 0) & (rc[:, 1] < W)
                shares.append(float(hair[rc[ok, 0], rc[ok, 1]].mean()))
            print(f"{name}: hair cap on the hair label {shares[0]:.3f} (PMVO convention), "
                  f"{shares[1]:.3f} (renderer's GL convention)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
