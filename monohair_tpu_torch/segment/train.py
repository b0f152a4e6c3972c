"""Training of the segmentation nets: BiSeNet as the hair parser and MODNet as
the person matte (the objectives and the step of tools/train_hair_parser.py,
which trained the shipped ``trained/hair_parser/*.npz``).

- The state is the MVS trainer's (`mvs.train.create_state`): weights drawn
  by flax's initialisers from an explicit generator (lecun_normal kernels
  over flax's fan-in, zero biases, norms at scale 1 and shift 0, running
  statistics 0 and 1), and optax.adam(cosine_decay_schedule(lr, steps))
  over the parameters only; the running statistics are buffers.
- A step runs the net in train mode: every BatchNorm normalises with the
  batch statistics and moves its running ones as flax does
  (`ops/norm.py::FlaxBatchNorm2d`, at each layer's flax momentum). The
  tool's MODNet step calls the net without its train flag, so flax runs its
  BatchNorms on the running statistics (0 and 1 from the initialiser, never
  moved): `batch_stats=False` keeps that.
- `parser_loss`: optax.softmax_cross_entropy on one-hot labels, a mean over
  N*H*W, summed over the three heads (train_hair_parser.py:224-230).
- `matte_loss`: MODNet's three terms, l_sem + 10 l_det + l_mat
  (train_hair_parser.py:266-282). The semantic target is
  jax.image.resize(matte, (N, H/8, W/8), "linear") with jax's default
  antialias: a triangle filter widened by the downsampling factor
  (`antialiased_linear_resize`), not the nets' resize_bilinear. The detail
  target and band are resizes to their own size, so the matte and band as
  they are.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..mvs.train import TrainState, create_state

__all__ = ["TrainState", "create_state", "antialiased_linear_resize", "parser_loss",
           "matte_loss", "loss_and_grads", "train_step"]


def _triangle_weights(src: int, dst: int) -> np.ndarray:
    """jax.image's compute_weight_mat for the linear (triangle) kernel with
    antialias, scale dst/src and no translation, in f32 as jax computes it:
    (src, dst), each column normalised to sum 1."""
    f32 = np.float32
    scale = f32(dst) / f32(src)
    inv_scale = f32(1) / scale
    kernel_scale = max(inv_scale, f32(1))
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000) * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def antialiased_linear_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, (..., h, w), "linear") with its default
    antialias=True, on the last two axes of x: rows first, then columns, each
    a product with `_triangle_weights` (jax's order of the spatial axes)."""
    H, W = x.shape[-2:]
    h, w = size
    if h != H:
        wy = torch.as_tensor(_triangle_weights(H, h), dtype=x.dtype, device=x.device)
        x = torch.einsum("...hw,hk->...kw", x, wy)
    if w != W:
        wx = torch.as_tensor(_triangle_weights(W, w), dtype=x.dtype, device=x.device)
        x = torch.einsum("...hw,wk->...hk", x, wx)
    return x


def parser_loss(outputs: Sequence[torch.Tensor], labels: torch.Tensor) -> torch.Tensor:
    """BiSeNet's loss: the mean softmax cross-entropy of each head's
    (N, C, H, W) logits against (N, H, W) integer labels, summed over the
    heads (out, out16, out32)."""
    labels = labels.long()
    return sum(F.cross_entropy(o, labels) for o in outputs)


def matte_loss(outputs: Sequence[torch.Tensor], matte: torch.Tensor,
               band: torch.Tensor) -> torch.Tensor:
    """MODNet's loss on (semantic /8, detail, matte) (N, 1, ., .) outputs,
    the (N, H, W) target matte and its boundary band: the semantic MSE
    against the antialiased downsample of the matte, 10x the detail L1
    inside the band (normalised by the band's area, at least 1), the matte
    L1."""
    sem, det, out = (o[:, 0] for o in outputs)
    sem_gt = antialiased_linear_resize(matte, sem.shape[-2:])
    l_sem = torch.mean((sem - sem_gt) ** 2)
    l_det = torch.sum(band * torch.abs(det - matte)) / torch.clamp_min(torch.sum(band), 1.0)
    l_mat = torch.mean(torch.abs(out - matte))
    return l_sem + 10.0 * l_det + l_mat


def loss_and_grads(state: TrainState, loss_fn: Callable, x: torch.Tensor, *targets,
                   batch_stats: bool = True) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(loss, gradients in parameter order) of the net on the (N, 3, H, W)
    batch x. With batch_stats the net runs in train mode (the BatchNorms
    normalise with the batch's statistics and move their running ones);
    without, in eval mode on the running statistics, which stay."""
    loss = loss_fn(state.model.train(batch_stats)(x), *targets)
    return loss.detach(), torch.autograd.grad(loss, state.opt.params)


def train_step(state: TrainState, loss_fn: Callable, x: torch.Tensor, *targets,
               batch_stats: bool = True) -> torch.Tensor:
    """One Adam step on a batch (`loss_and_grads`, then the optimizer); the
    loss as a 0-d tensor on the device (no host synchronisation)."""
    loss, grads = loss_and_grads(state, loss_fn, x, *targets, batch_stats=batch_stats)
    state.opt.step(grads)
    state.step += 1
    return loss
