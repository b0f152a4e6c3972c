"""Training of the occupancy/orientation nets (port of monohair_tpu/mvs/train.py).

The reference ships datasets and checkpoints but not the trainer (SURVEY.md
§2.4 #27); the JAX package wrote one, and this is its port: optax's Adam over
batched point samples (`optim.OptaxAdam` with the cosine schedule), BatchNorm
statistics as flax tracks them (`models.unet.FlaxBatchNorm2d`), the occ head
trained with cross-entropy and the ori head with sign-agnostic L1 (the losses
of pifu_attn.py:216,331).

Kept from the JAX package, as parts of the result:
- the ori loss normalises the head's output again, though
  `OriAttn.forward_with_feat` already returns unit vectors;
- `occ_metrics` calls a point occupied where logit 1 > logit 0;
- the eval step runs on the running statistics (eval mode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch

from ..models.pifu import OccAttn, OriAttn, flax_init, mvs_projection
from ..optim import OptaxAdam
from ..utils.metrics import OccMetric


@dataclass
class TrainState:
    """The net (its parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""
    model: torch.nn.Module
    opt: OptaxAdam
    step: int = 0

    @property
    def is_occ(self) -> bool:
        return isinstance(self.model, OccAttn)

    def param_names(self):
        return [name for name, _ in self.model.named_parameters()]


def make_optimizer(model: torch.nn.Module, lr: float, steps: int) -> OptaxAdam:
    """optax.adam(optax.cosine_decay_schedule(lr, steps)) over the net's
    parameters, in named_parameters order (train_mvs.py:127-129)."""
    return OptaxAdam(list(model.parameters()), lr, steps, max_norm=None, schedule="cosine")


def create_state(model: torch.nn.Module, generator: torch.Generator, lr: float = 1e-4,
                 steps: int = 20000) -> TrainState:
    """A fresh state: the net drawn by `models.pifu.flax_init` from `generator`
    (the distributions of the JAX package's create_state), Adam's moments 0."""
    return TrainState(flax_init(model, generator), make_optimizer(model, lr, steps))


def load_adam_state(state: TrainState, mu: Mapping, nu: Mapping, count: int) -> None:
    """Set Adam's moments by parameter name (as `models.convert.
    adam_state_from_flax` and `checkpoint.load_train_state` give them)."""
    names = state.param_names()
    dev = state.opt.params[0].device
    state.opt.mu = [torch.as_tensor(np.asarray(mu[n]), device=dev).clone() for n in names]
    state.opt.nu = [torch.as_tensor(np.asarray(nu[n]), device=dev).clone() for n in names]
    state.opt.count = int(count)


def _loss(state: TrainState, out: torch.Tensor, targets: torch.Tensor):
    """(loss, the outputs it was taken on): the ori outputs normalised again."""
    if state.is_occ:
        return OccAttn.loss(out, targets), out
    out = out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
    return OriAttn.loss(out, targets), out


def loss_and_grads(state: TrainState, imgs: torch.Tensor, w2c: torch.Tensor,
                   ndc: torch.Tensor, pts: torch.Tensor, targets: torch.Tensor):
    """(loss, gradients in parameter order) of a batch, BatchNorm in train mode
    (its running statistics move). pts are world-space query points (N, 3);
    targets are int labels (occ) or unit directions (ori)."""
    model = state.model.train()
    coord, cam = mvs_projection(w2c, ndc, pts)
    loss, _ = _loss(state, model(imgs, pts, cam, coord), targets)
    return loss.detach(), torch.autograd.grad(loss, state.opt.params)


def train_step(state: TrainState, imgs: torch.Tensor, w2c: torch.Tensor, ndc: torch.Tensor,
               pts: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """One Adam step on a batch (`loss_and_grads`, then the optimizer).
    Returns the batch's loss as a 0-d tensor on the device (no host
    synchronisation)."""
    loss, grads = loss_and_grads(state, imgs, w2c, ndc, pts, targets)
    state.opt.step(grads)
    state.step += 1
    return loss


@torch.no_grad()
def eval_step(state: TrainState, imgs: torch.Tensor, w2c: torch.Tensor, ndc: torch.Tensor,
              pts: torch.Tensor, targets: torch.Tensor):
    """(loss, outputs) of a batch on the running statistics, nothing updated
    (the val columns of the reference's stats_{occ,ori}.txt curves)."""
    model = state.model.eval()
    coord, cam = mvs_projection(w2c, ndc, pts)
    return _loss(state, model(imgs, pts, cam, coord), targets)


def occ_metrics(logits, labels) -> Dict[str, float]:
    """OccMetric's precision/recall of one batch (Utils/Utils.py:336-363)."""
    logits = torch.as_tensor(logits)
    metric = OccMetric()
    metric.update((logits[:, 1] > logits[:, 0]).cpu().numpy(),
                  np.asarray(torch.as_tensor(labels).cpu()))
    return metric.summary()
