"""monohair_tpu_torch — the PyTorch/CUDA port of monohair_tpu, for an NVIDIA H100.

It mirrors monohair_tpu's sub-layout and names (``camera``, ``coords``, ``io``,
``ops``, ``pmvo``, ``pipeline``) so each module's counterpart is easy to find,
and writes the same artifacts. It imports torch, numpy, scipy and the standard
library only. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the two TPU kernels of the PMVO line search are CUDA kernels
(``ops/patch_kernels.py``, ``csrc/patch_kernels.cu``) with plain PyTorch
versions that CPU tensors take.

Ported so far, each with its ``python -m monohair_tpu_torch.<stage>`` entry
point: stage 1 (``prepare_data``, with the coarse NeRF, without the bust
fit), stage 2 (``PMVO``), stage 3 (``infer_inner``) and stage 4
(``HairGrow``).
"""

__version__ = "0.1.0"
