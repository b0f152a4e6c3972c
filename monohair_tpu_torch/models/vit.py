"""View-fusion transformer with DeepViT re-attention (port of
monohair_tpu/models/vit.py; DeepMVSHair ViT.py:40-231).

V per-view tokens (pixel-aligned image feature + view-space point encoding)
and a cls token (+ world-space point encoding) pass through `depth`
re-attention blocks; an MLP head reads the cls token. The module names are the
reference's torch names; the arithmetic is the JAX package's, which differs
from the reference's torch net in two places: LayerNorm eps is flax's 1e-6
(torch's default is 1e-5) and GELU is flax's tanh approximation.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


class _Permute(nn.Module):
    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class _TanhGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh")


class ReAttention(nn.Module):
    """Multi-head attention whose softmaxed maps are re-mixed across heads by a
    learned (heads, heads) matrix, then LayerNormed over the heads axis."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.reattn_weights = nn.Parameter(torch.randn(heads, heads))
        self.reattn_norm = nn.Sequential(_Permute((0, 2, 3, 1)), nn.LayerNorm(heads, eps=LN_EPS),
                                         _Permute((0, 3, 1, 2)))
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, -1))
        dots = torch.matmul(q, k.transpose(-1, -2)) * self.dim_head ** -0.5
        attn = torch.einsum("bhij,hg->bgij", dots.softmax(-1), self.reattn_weights)
        out = torch.matmul(self.reattn_norm(attn), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # index 2 is the reference's Dropout(0), kept so net.3 is the second Linear
        self.net = nn.Sequential(nn.Linear(dim, hidden), _TanhGELU(), nn.Identity(),
                                 nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class _Residual(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = _PreNorm(dim, fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([_Residual(dim, ReAttention(dim, heads, dim_head)),
                           _Residual(dim, FeedForward(dim, mlp_dim))])
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = ff(attn(x))
        return x


class OccViT(nn.Module):
    """View-fusion head. output_dim=2 for occupancy logits, 3 for orientation."""

    def __init__(self, output_dim: int, token_dim: int = 128, feat_dim: int = 240,
                 pt_dim: int = 33, depth: int = 3, heads: int = 8, dim_head: int = 128,
                 mlp_dim: int = 128, num_views: int = 16):
        super().__init__()
        self.view_fuse_pt = nn.Linear(feat_dim + pt_dim, token_dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, token_dim))
        self.cls_fuse_pt = nn.Linear(token_dim + pt_dim, token_dim)
        self.pos_embedding = nn.Parameter(torch.randn(1, num_views + 1, token_dim))
        self.transformer = Transformer(token_dim, depth, heads, dim_head, mlp_dim)
        self.mlp_head = nn.Sequential(
            nn.LayerNorm(token_dim, eps=LN_EPS), nn.Linear(token_dim, token_dim), nn.ReLU(),
            nn.Linear(token_dim, token_dim), nn.ReLU(), nn.Linear(token_dim, output_dim))

    def forward(self, img_feat: torch.Tensor, pts_world_feat: torch.Tensor,
                pts_view_feat: torch.Tensor) -> torch.Tensor:
        """img_feat: (N, V, C_ft); pts_world_feat: (N, 1, pt_dim);
        pts_view_feat: (N, V, pt_dim) -> (N, output_dim)."""
        n = img_feat.shape[0]
        view_tokens = self.view_fuse_pt(torch.cat([img_feat, pts_view_feat], -1))
        cls = self.cls_token.expand(n, 1, -1)
        cls = self.cls_fuse_pt(torch.cat([cls, pts_world_feat], -1))
        y = torch.cat([cls, view_tokens], 1) + self.pos_embedding
        return self.mlp_head(self.transformer(y)[:, 0])
