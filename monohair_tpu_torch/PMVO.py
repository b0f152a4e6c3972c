"""Stage 2 entry point of the PyTorch port:

    python -m monohair_tpu_torch.PMVO --yaml=configs/reconstruct/<case> [--device=cpu]

Same CLI contract as the root PMVO.py (dotted config overrides); runs on the
GPU unless --device=cpu is given.
"""

import sys

from .pipeline.common import resolve_config, split_device
from .pipeline.pmvo_stage import run_pmvo


def main(argv):
    device, rest = split_device(argv)
    run_pmvo(resolve_config(rest), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
