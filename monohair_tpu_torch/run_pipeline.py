"""All four stages in one process (port of the root run_pipeline.py; the
reference takes four python invocations and interactive NeRF steps,
readme.md:68-80):

    python -m monohair_tpu_torch.run_pipeline --yaml=configs/reconstruct/<case> [--device=cpu]

Same CLI contract as the stage CLIs (dotted config overrides); runs on the GPU
unless --device=cpu is given. prepare_data, PMVO, infer_inner and HairGrow run
one after another, each under `log.stage`, with the flags of the config, and
write what the four stage CLIs write. Each stage's seconds go to
<output_path>/metrics.jsonl as `stage/<name>/seconds`.
"""

import os
import sys
import time

from .log import Log
from .pipeline.common import resolve_config, split_device
from .pipeline.hair_grow_stage import run_hair_grow
from .pipeline.infer_inner_stage import run_infer_inner
from .pipeline.pmvo_stage import run_pmvo
from .pipeline.prepare_data_stage import run_prepare_data

STAGES = (("prepare_data", run_prepare_data), ("pmvo", run_pmvo),
          ("infer_inner", run_infer_inner), ("hair_grow", run_hair_grow))


def main(argv):
    """Run the four stages; returns each stage's steps (their wall seconds)."""
    device, rest = split_device(argv)
    args = resolve_config(rest)
    log = Log(os.path.join(args.output_path, "metrics.jsonl"))
    t0 = time.monotonic()
    steps = {}
    for name, run in STAGES:
        with log.stage(name, device=device):
            steps[name] = run(args, device=device)
    log.ok(f"full pipeline in {time.monotonic() - t0:.1f}s -> "
           f"{args.output_path}/full/connected_strands.hair")
    return steps


if __name__ == "__main__":
    main(sys.argv[1:])
