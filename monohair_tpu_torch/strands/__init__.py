"""Strand generation (port of monohair_tpu/strands): batched field tracing and
Laplacian smoothing in torch on any device; segment connection, scalp
attachment and resampling on the host (numpy, scipy and host C++)."""
