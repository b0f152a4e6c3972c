"""NeRF-side plumbing of stage 1. Only the pose chain is ported so far; the
NeRF itself (the Fourier, hash and dense fields, training, marching) is not."""
