"""Scalp diffusion: extend the orientation field from the scalp into empty
voxels along blended normals so roots can grow through sparse regions
(port of monohair_tpu/strands/scalp_diffusion.py).

Batched re-design of diffusion_scalp (PMVO_utils.py:467-593): every scalp
point marches at once (like strands.trace); the bridge between the scalp and
the first field hit uses the same cubic Hermite shape, evaluated in closed
form for all seeds at once. The sample sums are rounded as XLA's fused
multiply-adds round them on the CPU (trace._fma) as far as the tests pin it;
XLA contracts the whole fused expression in an order the port does not
follow everywhere, so a sample can still differ by an ulp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .trace import VoxelField, _fma, _where, dot3, norm3


@torch.no_grad()
def diffuse_scalp(occ: torch.Tensor, ori_voxel: torch.Tensor,
                  scalp_points: torch.Tensor, scalp_normals: torch.Tensor,
                  trace_steps: int = 10, threshold: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns the diffused (ori, occ) voxel grids, on the device of `occ`.

    scalp_points/normals in voxel space. Seeds march along their normal for at
    most `trace_steps` voxels; when the field is reached with |cos| >
    threshold, the bridge between scalp and hit point is filled with
    Hermite-interpolated directions. Finally ori/occ gain the diffusion only
    where empty (PMVO_utils.py:590-592).
    """
    field = VoxelField(occ, ori_voxel)
    dev = field.device
    scalp_points = scalp_points.to(dev, torch.float32)
    scalp_normals = scalp_normals.to(dev, torch.float32)
    K = scalp_points.shape[0]

    pos, hit_pos, hit_dir = scalp_points, scalp_points, scalp_normals
    active = torch.ones(K, dtype=torch.bool, device=dev)
    hit = torch.zeros(K, dtype=torch.bool, device=dev)
    for step in range(trace_steps):
        in_field = field.lookup_occ(pos) > 0
        fdir = field.lookup_ori(pos)
        cos = dot3(fdir, scalp_normals)
        if step > 0:
            newly_hit = active & in_field & (torch.abs(cos) > threshold)
            hit = hit | newly_hit
            hit_pos = _where(newly_hit, pos, hit_pos)
            sgn = torch.sign(cos)
            sgn = torch.where(sgn == 0, 1.0, sgn)
            hit_dir = _where(newly_hit, fdir * sgn[:, None], hit_dir)
        active = active & ~in_field
        pos = _where(active, pos + scalp_normals, pos)

    # Hermite bridge samples between scalp point and hit point; t as
    # jnp.linspace makes it (step i/(S-1), the last sample exactly 1)
    S = trace_steps + 1
    t = torch.arange(S, device=dev, dtype=torch.float32) * (1.0 / (S - 1))
    t[-1] = 1.0
    t = t[None, :, None]                                       # (1, S, 1)
    t2 = t * t
    t3 = t * t2
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    p0 = scalp_points[:, None, :]
    p1 = hit_pos[:, None, :]
    dist = norm3(hit_pos - scalp_points)                       # (K,)
    m0 = scalp_normals[:, None, :] * dist[:, None, None]
    m1 = hit_dir[:, None, :] * dist[:, None, None]
    samples = _fma(h11, m1, _fma(h01, p1, _fma(h10, m0, h00 * p0)))  # (K, S, 3)
    tangents = torch.diff(samples, dim=1)
    tangents = torch.cat([tangents, tangents[:, -1:]], 1)
    flat = samples.reshape(-1, 3)
    tflat = tangents.reshape(-1, 3)
    tflat = tflat / torch.clamp_min(norm3(tflat), 1e-8)[:, None]

    valid = (hit & (dist > 0.5))[:, None].expand(K, S).reshape(-1)   # real bridges only
    idx = field.index(flat[valid])
    d_occ = torch.zeros_like(occ).view(-1)
    d_occ.index_put_((idx,), torch.ones_like(idx, dtype=occ.dtype), accumulate=True)
    d_ori = torch.zeros_like(ori_voxel).view(-1, 3)
    d_ori.index_put_((idx,), tflat[valid], accumulate=True)
    d_ori = (d_ori / torch.clamp_min(d_occ[:, None], 1e-6)).view(ori_voxel.shape)
    d_occ = torch.clamp_max(d_occ, 1.0).view(occ.shape)

    new_ori = ori_voxel + (1.0 - occ[..., None]) * d_ori
    new_occ = occ + (1.0 - occ) * d_occ
    return new_ori, new_occ
