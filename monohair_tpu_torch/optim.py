"""optax's Adam chains written out in torch, for the loops whose rates and step
counts were tuned on optax (the NeRF's training, the bust fit, the MVS nets'
training).

torch.optim's Adam and clip_grad_norm_ round and clip otherwise: the bias
corrections, the learning-rate schedule and the clip's scale are computed here
in f32 as optax computes them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def cosine_decay_lr(lr: float, decay_steps: int, count: int, alpha: float = 0.0,
                    exponent: float = 1.0) -> float:
    """optax.cosine_decay_schedule(lr, decay_steps, alpha, exponent) at `count`,
    in f32 as optax 0.2.6 computes it:
    lr * ((1 - alpha) * (0.5 * (1 + cos(pi * min(count, T) / T))) ** exponent + alpha).
    The cosine is the correctly rounded one; XLA's f32 cosine is not always,
    so a step's rate can differ from optax's by one f32 ulp."""
    f32 = np.float32
    k = min(f32(count), f32(decay_steps))
    decay = f32(0.5) * (f32(1) + f32(np.cos(np.float64(f32(np.pi) * k / f32(decay_steps)))))
    return float(f32(lr) * ((f32(1) - f32(alpha)) * decay ** f32(exponent) + f32(alpha)))


class OptaxAdam:
    """optax.chain([zero_nans(),] [clip_by_global_norm(max_norm),] adam(
    exponential_decay(lr, transition_steps, decay_rate))) over a list of
    parameters, or with schedule="cosine" optax.adam(cosine_decay_schedule(lr,
    transition_steps)), as optax computes it:
    - with zero_nans, every NaN of a gradient becomes 0 (an inf stays);
    - unless max_norm is None, the global norm g over every gradient; each
      gradient becomes (grad / g) * max_norm unless g < max_norm;
    - mu = (1 - b1) grad + b1 mu, nu = (1 - b2) grad^2 + b2 nu, bias-corrected
      by 1 - b^count with count counted from 1 (b1 0.9, b2 0.999);
    - the update mu_hat / (sqrt(nu_hat) + 1e-8), scaled by -lr(k) at k = the
      steps taken before this one (so the first step uses lr): lr *
      decay_rate^(k / transition_steps), continuous, not staircase; or the
      cosine decay over transition_steps (`cosine_decay_lr`).
    The scalars are f32, as in optax."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], lr: float, transition_steps: int,
                 max_norm: Optional[float] = 10.0, decay_rate: float = 0.1, zero_nans: bool = False,
                 schedule: str = "exponential"):
        if schedule not in ("exponential", "cosine"):
            raise ValueError(f"unknown learning-rate schedule {schedule!r}")
        self.schedule = schedule
        self.params = list(params)
        self.lr, self.transition_steps = lr, transition_steps
        self.max_norm, self.decay_rate, self.zero_nans = max_norm, decay_rate, zero_nans
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self, count: int) -> float:
        if self.schedule == "cosine":
            return cosine_decay_lr(self.lr, self.transition_steps, count)
        f32 = np.float32
        p = f32(count) / f32(self.transition_steps)
        return float(f32(self.lr) * np.power(f32(self.decay_rate), p))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.zero_nans:
            grads = [torch.nan_to_num(g, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
                     for g in grads]
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_norm) for g in grads]
        b1, b2 = self.B1, self.B2
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(self.mu, b1))
        self.nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                     torch._foreach_mul(self.nu, b2))
        count_inc = self.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(count_inc))
        bc2 = float(f32(1) - f32(b2) ** f32(count_inc))
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
        updates = torch._foreach_div(mu_hat, denom)
        step_size = -self.learning_rate(self.count)
        torch._foreach_add_(self.params, torch._foreach_mul(updates, step_size))
        self.count = count_inc
