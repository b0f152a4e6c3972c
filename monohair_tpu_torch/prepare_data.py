"""Stage 1 entry point of the PyTorch port:

    python -m monohair_tpu_torch.prepare_data --yaml=configs/reconstruct/<case> [--device=cpu]

Same CLI contract as the root prepare_data.py (dotted config overrides); runs
on the GPU unless --device=cpu is given. From colmap/images, colmap/
{transforms,key_frame}.json, the calibration rig and the bust-fit assets
(bustfit.*: the SMPL-X npz, landmark vertex ids, FLAME template, ids and scalp
mask; segment.*: the annotation nets) it writes capture_images/,
colmap/base_cam.json, ours/cam_params.json, the coarse NeRF's 16 fixed-view
renders (trainning_images/capture_images/, imgs/<view>/origin.png) and meshes
(colmap/base.obj, ours/colmap_points.obj), the bust fit's optimize/
{matting,landmark2d,iris,face_parsing}/, optimize/{model_tsfm.dat,
model_tsfm_semantic.dat,final_template.obj,fit_losses.txt}, their copies at
the case root and Bust/{bust_long,flame_bust,scalp}.obj, ours/*_tsfm.obj,
imgs/<view>/bust_hair_depth.png, render_depth/<view>.npy, hair_mask/, mask/,
mask_hair/, best_ori/, conf/ and Ori/. With --prepare_data.run_ngp= the NeRF
is skipped and ours/colmap_points.obj is read from the case; with
--prepare_data.fit_bust= Bust/ and model_tsfm.dat are.
"""

import sys

from .pipeline.common import resolve_config, split_device
from .pipeline.prepare_data_stage import run_prepare_data


def main(argv):
    """Run the stage; returns its steps' wall seconds."""
    device, rest = split_device(argv)
    return run_prepare_data(resolve_config(rest), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
