"""flax's BatchNorm in train mode, as a drop-in nn.BatchNorm2d (the state
dict's keys are BatchNorm2d's, so the flax converters load it as they are)."""

from __future__ import annotations

import torch
from torch import nn


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train mode computes what flax's nn.BatchNorm
    (use_fast_variance) computes, with flax's `momentum`:
    - the batch variance is E[x^2] - E[x]^2 over (N, H, W), clipped at 0, so
      biased, and 0 where a channel holds one value (a 1x1 map at batch 1,
      where nn.BatchNorm2d raises); the output is
      (x - mean) * (rsqrt(var + eps) * weight) + bias;
    - the running statistics become momentum * running + (1 - momentum) *
      batch, the variance biased too (nn.BatchNorm2d keeps the unbiased one,
      n/(n-1) larger). flax's momentum is 1 - nn.BatchNorm2d's.
    Eval mode is nn.BatchNorm2d's, on the running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
