"""Albedo texture PCA and spherical-harmonic shading for the bust fit's
image and albedo losses (port of monohair_tpu/bustfit/texture.py).

The reference's FLAMETex is a PCA over a 512x512 UV albedo map; the JAX
package keeps the same optimisation surface (n_tex PCA coefficients ->
albedo, 9x3 SH -> shading) with the albedo *per vertex*, which the soft
rasteriser interpolates barycentrically. The PCA asset loads from an npz
(mean (V, 3), basis (V, 3, T)); without it the albedo is a flat 0.5 and the
basis zero, so the optimisation path still runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import device_constant


class FlameTex(NamedTuple):
    mean: torch.Tensor    # (V, 3) linear albedo
    basis: torch.Tensor   # (V, 3, T)

    @property
    def n_tex(self) -> int:
        return self.basis.shape[-1]


def load_flame_tex(path: Optional[str], num_verts: int, n_tex: int = 50,
                   device="cuda") -> FlameTex:
    if path is not None:
        d = np.load(path)
        return FlameTex(torch.as_tensor(np.asarray(d["mean"], np.float32), device=device),
                        torch.as_tensor(np.asarray(d["basis"], np.float32)[..., :n_tex].copy(),
                                        device=device))
    return FlameTex(torch.full((num_verts, 3), 0.5, device=device),
                    torch.zeros((num_verts, 3, n_tex), device=device))


def albedo_from_tex(tex_model: FlameTex, tex: torch.Tensor) -> torch.Tensor:
    """tex (T,) PCA coefficients -> (V, 3) per-vertex albedo, clipped to [0, 1]
    (FLAMETex: mean + basis @ params)."""
    a = tex_model.mean + torch.einsum("vct,t->vc", tex_model.basis, tex)
    return torch.minimum(torch.maximum(a, a.new_full((), 0.0)), a.new_full((), 1.0))


# SRenderY's SH constant factors (DELTA decalib/utils/renderer add_SHlight),
# band-0/1/2 real SH under the common graphics normalisation.
_SH_CONST = np.array([
    1.0 / np.sqrt(4 * np.pi),
    (2 * np.pi / 3) * np.sqrt(3 / (4 * np.pi)),
    (2 * np.pi / 3) * np.sqrt(3 / (4 * np.pi)),
    (2 * np.pi / 3) * np.sqrt(3 / (4 * np.pi)),
    (np.pi / 4) * 3 * np.sqrt(5 / (12 * np.pi)),
    (np.pi / 4) * 3 * np.sqrt(5 / (12 * np.pi)),
    (np.pi / 4) * 3 * np.sqrt(5 / (12 * np.pi)),
    (np.pi / 4) * 1.5 * np.sqrt(5 / (12 * np.pi)),
    (np.pi / 4) * 0.5 * np.sqrt(5 / (4 * np.pi)),
], dtype=np.float32)


def sh_shading(normals: torch.Tensor, sh_coeff: torch.Tensor) -> torch.Tensor:
    """9-term SH irradiance per vertex. normals (V, 3); sh_coeff (9, 3) ->
    (V, 3), or (B, 9, 3) -> (B, V, 3) (the SRenderY basis order: 1, x, y, z,
    xy, xz, yz, x^2-y^2, 3z^2-1)."""
    x, y, z = normals[:, 0], normals[:, 1], normals[:, 2]
    one = torch.ones_like(x)
    sh = torch.stack([one, x, y, z, x * y, x * z, y * z,
                      x ** 2 - y ** 2, 3 * z ** 2 - 1], -1)       # (V, 9)
    sh = sh * device_constant("sh_const", normals.device, lambda: _SH_CONST)
    if sh_coeff.dim() == 3:
        return torch.einsum("vn,bnc->bvc", sh, sh_coeff)
    return torch.einsum("vn,nc->vc", sh, sh_coeff)


def shaded_vertex_colors(albedo: torch.Tensor, normals: torch.Tensor,
                         sh_coeff: torch.Tensor) -> torch.Tensor:
    """albedo (V, 3) x SH shading -> (V, 3) linear colours, or (B, V, 3) for
    (B, 9, 3) coefficients (SRenderY: albedo_images * shading_images)."""
    return albedo * sh_shading(normals, sh_coeff)
