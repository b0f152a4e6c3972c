"""Stage 3 entry point of the PyTorch port:

    python -m monohair_tpu_torch.infer_inner --yaml=configs/reconstruct/<case> [--device=cpu]

Same CLI contract as the root infer_inner.py (dotted config overrides); runs
on the GPU unless --device=cpu is given. It reads refine/{Occ3D,Ori3D}.mat
and optimize/*.npy of an earlier PMVO run and writes imgs/<view>/*.png,
ours/{voxels.dat,raw.npy,Voxel_hair/*.mat} and full/{Occ3D,Ori3D}.mat.
"""

import sys

from .pipeline.common import resolve_config, split_device
from .pipeline.infer_inner_stage import run_infer_inner


def main(argv):
    """Run the stage; returns its steps' wall seconds."""
    device, rest = split_device(argv)
    return run_infer_inner(resolve_config(rest), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
