"""Compute ops of the port: patch gathers, the PMVO kernels, voxel buckets and
voxelization, OpenCV's resizes and the Gabor bank."""

import torch


def exact_f32() -> None:
    """Keep f32 matmuls and convolutions in full f32 on the card: the camera
    math feeds rounded pixel indices, the Gabor bank's argmax picks among
    near-tied responses, and TF32 keeps about 3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
