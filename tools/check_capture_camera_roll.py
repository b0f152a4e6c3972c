#!/usr/bin/env python
"""Check that the capture case's MVS cameras agree with its frames: the true
hair cap (the head sphere's points within 50 degrees of up, in the mesh frame
that nerf.poses.convert_mesh_nerf_to_mvs takes, carried through the pose
chain) is projected with every view of ours/cam_params.json, and the share of
its camera-facing points on the frame's hair label is printed under PMVO's
pixel lookup (camera.pixel_index_and_validity) and under the renderer's GL
flip (synthetic.capture_hair_cap_shares). Also prints, per view, the angle
between the pose chain's rotation and the one the writer intended
(synthetic.capture_mvs_pose) and the axis it turns about, in camera axes.

    python tools/check_capture_camera_roll.py [num_frames] [H W]

Runs the port's prepare_data CLI (select_images and process_camera only) on
the CPU on a small capture case (16 frames at 96x128 by default) in a temp
directory.
"""

import json
import os
import sys
import tempfile

import numpy as np
from scipy.spatial.transform import Rotation

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from monohair_tpu_torch import prepare_data  # noqa: E402
from monohair_tpu_torch.io.yaml_io import dump_yaml  # noqa: E402
from monohair_tpu_torch.synthetic import (capture_hair_cap_shares,  # noqa: E402
                                          write_capture_case)


def main(num_frames: int = 16, H: int = 96, W: int = 128) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        out = write_capture_case(tmp, "cap", num_frames=num_frames, H=H, W=W)
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(out["config"].to_dict()))
        prepare_data.main(["--yaml=" + os.path.join(tmp, "case"), "--device=cpu",
                           "--prepare_data.run_ngp=", "--prepare_data.fit_bust=",
                           "--prepare_data.process_bust=", "--prepare_data.render_depth=",
                           "--prepare_data.process_imgs="])
        case = os.path.join(tmp, "cap")
        with open(os.path.join(case, "ours", "cam_params.json")) as f:
            poses = {c["file"]: np.array(c["pose"]) for c in json.load(f)["cam_list"]}
        for name, pmvo, gl in capture_hair_cap_shares(case, (H, W)):
            got, want = poses[name][:3, :3], out["mvs_poses"][name][:3, :3]
            turn = Rotation.from_matrix(got.T @ want).as_rotvec()
            angle = float(np.degrees(np.linalg.norm(turn)))
            axis = turn / max(np.linalg.norm(turn), 1e-12)
            print(f"{name}: pose chain vs writer {angle:.6f} deg about {np.round(axis, 3)}; "
                  f"hair cap on the hair label {pmvo:.3f} (PMVO lookup), {gl:.3f} (renderer's "
                  f"GL flip)")


if __name__ == "__main__":
    nums = [int(a) for a in sys.argv[1:]]
    main(*nums[:1], *nums[1:3])
