"""Stage 4 entry point of the PyTorch port:

    python -m monohair_tpu_torch.HairGrow --yaml=configs/reconstruct/<case> [--device=cpu]

Same CLI contract as the root HairGrow.py (dotted config overrides); runs on
the GPU unless --device=cpu is given. Reads <output>/refine/{Occ3D,Ori3D}.mat
(full/ with PMVO.infer_inner) and writes the strands beside them.
"""

import sys

from .pipeline.common import resolve_config, split_device
from .pipeline.hair_grow_stage import run_hair_grow


def main(argv):
    device, rest = split_device(argv)
    run_hair_grow(resolve_config(rest), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
