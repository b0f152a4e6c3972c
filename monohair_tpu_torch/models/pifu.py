"""Pixel-aligned implicit occupancy/orientation nets (port of
monohair_tpu/models/pifu.py; DeepMVSHair pifu_attn.py:147-371).

UNet backbone features sampled at each point's projection in every view,
fused by the OccViT view transformer with NeRF positional encodings of the
world- and view-space point coordinates. The eval-time split API is the
reference's: `get_feat` once per view set, `forward_with_feat` streamed over
point batches (pifu_attn.py:240-256).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid_sample import grid_sample_views
from .unet import UNetSimple
from .vit import OccViT


def positional_encoding(x: torch.Tensor, num_freqs: int = 5) -> torch.Tensor:
    """NeRF positional encoding (pifu_attn.py:10-58): [x, sin(2^k x), cos(2^k x)]
    for k = 0..num_freqs-1. (..., D) -> (..., D * (1 + 2*num_freqs))."""
    out = [x]
    for k in range(num_freqs):
        f = 2.0 ** k
        out.append(torch.sin(x * f))
        out.append(torch.cos(x * f))
    return torch.cat(out, -1)


def pt_embed_dim(input_dims: int = 3, num_freqs: int = 5) -> int:
    return input_dims * (1 + 2 * num_freqs)


class _PifuBase(nn.Module):
    vit_attr = ""       # the reference's attribute name of the fusion head
    output_dim = 0

    def __init__(self, num_views: int = 16, vit_dim: int = 128, vit_depth: int = 3,
                 vit_heads: int = 8, in_feat: int = 4, pt_res: int = 5):
        super().__init__()
        self.pt_res = pt_res
        self.backbone = UNetSimple(in_feat, ksize=5)
        setattr(self, self.vit_attr, OccViT(
            self.output_dim, token_dim=vit_dim, feat_dim=self.backbone.output_feat,
            pt_dim=pt_embed_dim(3, pt_res), depth=vit_depth, heads=vit_heads,
            dim_head=vit_dim, mlp_dim=vit_dim, num_views=num_views))

    @property
    def fusion(self) -> OccViT:
        return getattr(self, self.vit_attr)

    def get_feat(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """imgs: (V, H, W, C) -> the 4 NCHW multi-scale feature maps."""
        return self.backbone(imgs.permute(0, 3, 1, 2).contiguous())

    def _fuse(self, feats: Sequence[torch.Tensor], pts_world: torch.Tensor,
              pts_view: torch.Tensor, sample_coord: torch.Tensor) -> torch.Tensor:
        """feats: 4 x (V, c, h, w); pts_world (N, 3); pts_view (V, N, 3);
        sample_coord (V, N, 2) NDC (x=width, y=height, grid_sample convention)."""
        img_feat = torch.cat([grid_sample_views(f, sample_coord) for f in feats], -1)
        pw = positional_encoding(pts_world, self.pt_res)[:, None, :]
        pv = positional_encoding(pts_view, self.pt_res).transpose(0, 1)
        return self.fusion(img_feat.transpose(0, 1), pw, pv)

    def forward(self, imgs, pts_world, pts_view, sample_coord) -> torch.Tensor:
        return self.forward_with_feat(self.get_feat(imgs), pts_world, pts_view, sample_coord)

    def forward_with_feat(self, feats, pts_world, pts_view, sample_coord) -> torch.Tensor:
        raise NotImplementedError


class OccAttn(_PifuBase):
    """2-class occupancy head (pifu_attn.py:147-256). Returns logits (N, 2)."""
    vit_attr = "occ_vit"
    output_dim = 2

    def forward_with_feat(self, feats, pts_world, pts_view, sample_coord):
        return self._fuse(feats, pts_world, pts_view, sample_coord)

    @staticmethod
    def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Cross-entropy (pifu_attn.py:185,216): the mean over the points of
        -log_softmax(logits)[label]."""
        logp = F.log_softmax(logits, -1)
        return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


class OriAttn(_PifuBase):
    """Unit 3-vector orientation head (pifu_attn.py:259-371). Returns (N, 3)."""
    vit_attr = "vit"
    output_dim = 3

    def forward_with_feat(self, feats, pts_world, pts_view, sample_coord):
        out = self._fuse(feats, pts_world, pts_view, sample_coord)
        return out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp_min(1e-12)

    @staticmethod
    def loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """Sign-agnostic L1 (pifu_attn.py:327-331): the mean over the points of
        min(mean |pred - gt|, mean |pred + gt|)."""
        pos = torch.mean(torch.abs(pred - gt), -1)
        neg = torch.mean(torch.abs(pred + gt), -1)
        return torch.mean(torch.minimum(pos, neg))


def _fill(model: nn.Module, generator: torch.Generator, draw_matrix) -> nn.Module:
    """Fresh weights drawn from `generator` (on the CPU), whatever the global
    seed, in named_parameters order: the cls token, position table and
    re-attention mix standard normal; every other weight of 2 or more
    dimensions from draw_matrix(p, fan_in) with flax's fan-in (kernel area x
    input channels; a transposed convolution's input is its deep side,
    torch's dim 0); biases 0; norms scale 1, shift 0, running stats 0 and 1."""
    transposed = {id(m.weight) for m in model.modules() if isinstance(m, nn.ConvTranspose2d)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "pos_embedding", "reattn_weights"):
            new = torch.randn(p.shape, generator=generator)
        elif p.ndim >= 2:
            new = draw_matrix(p, p[:, 0].numel() if id(p) in transposed else p[0].numel())
        elif leaf == "weight":
            new = torch.ones(p.shape)
        else:
            new = torch.zeros(p.shape)
        p.copy_(new)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
    return model


@torch.no_grad()
def random_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """`_fill` with weights uniform in +-1/sqrt(p[0].numel()) (torch's default
    bound for convolutions and linear layers; for a transposed convolution,
    its output channels x kernel area)."""
    def uniform(p, fan_in):
        bound = p[0].numel() ** -0.5
        return (torch.rand(p.shape, generator=generator) * 2 - 1) * bound

    return _fill(model, generator, uniform)


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated to +-2 standard deviations,
    scaled to variance 1 / fan_in (std sqrt(1/fan_in) / 0.8796..., the
    truncated unit normal's std), drawn as jax.random.truncated_normal draws
    it: erfinv of a uniform between the bounds' CDF values."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    unit = math.sqrt(2.0) * torch.erfinv(u)
    return (unit * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)).float()


@torch.no_grad()
def flax_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """`_fill` with the distributions of the JAX package's trainer
    (monohair_tpu/mvs/train.py::create_state, flax's defaults): convolution,
    transposed-convolution and linear weights lecun_normal over flax's
    fan-in; normal(1.0) for the cls token, position table and re-attention
    mix (vit.py:42,99,107)."""
    return _fill(model, generator, lambda p, fan_in: _lecun_normal(p.shape, fan_in, generator))


def mvs_projection(w2c: torch.Tensor, ndc: torch.Tensor, pts: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project (N, 3) world points for grid_sample lookup + view-space coords.

    Mirror of getProjPoints (DeepMVSHair util.py / Utils.py:76-95): divide by
    z and flip x, giving x_gs = -(fx x/z + cx) and y_gs = fy y/z + cy, the
    grid_sample convention (x -> width, y -> height).
    Returns (sample_coord (V, N, 2), pts_view (V, N, 3)).
    """
    cam = torch.einsum("vij,nj->vni", w2c[:, :3, :3], pts) + w2c[:, None, :3, 3]
    z = cam[..., 2]
    fx, fy, cx, cy = ndc.unbind(-1)
    u = -(fx[:, None] * cam[..., 0] / z + cx[:, None])
    v = fy[:, None] * cam[..., 1] / z + cy[:, None]
    return torch.stack([u, v], -1), cam


def check_pts_in_views(sample_coord: torch.Tensor, mode: str = "any") -> torch.Tensor:
    """In-frustum mask (Utils.py:98-207): (V, N, 2) -> (N,)."""
    inb = torch.all(torch.abs(sample_coord) < 1.0, -1)
    return torch.any(inb, 0) if mode == "any" else torch.all(inb, 0)


def occ_decision(logits: torch.Tensor, margin: float) -> torch.Tensor:
    """Occupied where logit1 - logit0 exceeds the margin (0.0 = argmax)."""
    return (logits[:, 1] - logits[:, 0]) > margin
