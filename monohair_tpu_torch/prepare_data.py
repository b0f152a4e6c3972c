"""Stage 1 entry point of the PyTorch port (its image half):

    python -m monohair_tpu_torch.prepare_data --yaml=configs/reconstruct/<case> \
        --prepare_data.fit_bust= [--device=cpu]

Same CLI contract as the root prepare_data.py (dotted config overrides); runs
on the GPU unless --device=cpu is given. From colmap/images, colmap/
{transforms,key_frame}.json, the calibration rig and Bust/ it writes
capture_images/, colmap/base_cam.json, ours/cam_params.json, the coarse NeRF's
16 fixed-view renders (trainning_images/capture_images/, imgs/<view>/origin.png)
and meshes (colmap/base.obj, ours/colmap_points.obj), ours/*_tsfm.obj,
imgs/<view>/bust_hair_depth.png, render_depth/<view>.npy, hair_mask/, mask/,
mask_hair/, best_ori/, conf/ and Ori/. With --prepare_data.run_ngp= the NeRF
is skipped and ours/colmap_points.obj is read from the case. The bust fit
(fit_bust) is not ported yet: the stage raises when it is on.
"""

import sys

from .pipeline.common import resolve_config, split_device
from .pipeline.prepare_data_stage import check_ported, run_prepare_data


def main(argv):
    """Run the stage; returns its steps' wall seconds."""
    device, rest = split_device(argv)
    return run_prepare_data(resolve_config(rest, check=check_ported), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
