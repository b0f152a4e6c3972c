"""SMPL-X style linear-blend-skinning body model in PyTorch (port of
monohair_tpu/bustfit/smplx.py).

Formulation (standard SMPL/SMPL-X):
    v_shaped = template + shapedirs . betas + exprdirs . expression
    joints   = J_regressor @ v_shaped
    v_posed  = v_shaped + posedirs . (R(theta) - I)
    verts    = LBS(v_posed, joint transforms, skinning weights)

The JAX package's einsums run at precision "highest"; on the card they need
TF32 off (``ops.exact_f32``), which run_bust_fit sets. The kinematic
chain is a loop over the static parent table.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import device_constant


class SMPLXModel(NamedTuple):
    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, S)
    posedirs: torch.Tensor      # (P*9, V*3)  (pose-feature major)
    J_regressor: torch.Tensor   # (J, V)
    parents: np.ndarray         # (J,) kinematic tree (static)
    lbs_weights: torch.Tensor   # (V, J)
    faces: np.ndarray           # (F, 3) (static; the fit holds it on the device)
    expr_dirs: Optional[torch.Tensor] = None   # (V, 3, E); None = no expression space

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_expr(self) -> int:
        return 0 if self.expr_dirs is None else self.expr_dirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


def load_smplx_npz(path: str, num_betas: int = 10, num_expr: int = 10,
                   device="cuda") -> SMPLXModel:
    """Load the official SMPL-X npz layout. SMPL-X packs expression dirs after
    the 300 shape components of `shapedirs` (smplx.body_models convention)."""
    d = np.load(path, allow_pickle=True)
    all_dirs = np.asarray(d["shapedirs"], np.float32)
    shapedirs = all_dirs[..., :num_betas]
    if all_dirs.shape[-1] > 300 and num_expr > 0:
        expr_dirs = _t(all_dirs[..., 300:300 + num_expr], device)
    else:  # older layouts without packed expression space
        expr_dirs = None
    posedirs = np.asarray(d["posedirs"], np.float32)
    P = posedirs.shape[-1]
    n_verts3 = posedirs.shape[0] * posedirs.shape[1]
    posedirs = posedirs.reshape(n_verts3, P).T  # (P, V*3)
    return SMPLXModel(
        v_template=_t(d["v_template"], device),
        shapedirs=_t(shapedirs, device),
        posedirs=_t(posedirs, device),
        J_regressor=_t(d["J_regressor"], device),
        parents=np.asarray(d["kintree_table"])[0].astype(np.int64),
        lbs_weights=_t(d["weights"], device),
        faces=np.asarray(d["f"], np.int64),
        expr_dirs=expr_dirs,
    )


def rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """(J, 3) axis-angle -> (J, 3, 3) rotation matrices (the 1e-12 inside the
    norm keeps the zero rotation's gradient finite)."""
    v = rot_vecs + 1e-12
    angle = torch.sqrt(torch.sum(v * v, -1, keepdim=True))   # jnp.linalg.norm's sum
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], -1).reshape(-1, 3, 3)
    eye = torch.eye(3, device=rot_vecs.device)[None]
    return cos * eye + sin * K + (1 - cos) * torch.einsum("ji,jk->jik", axis, axis)


def lbs_forward(model: SMPLXModel, betas: torch.Tensor, pose: torch.Tensor,
                expression: Optional[torch.Tensor] = None,
                global_transl: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """betas (S,), pose (J, 3) axis-angle -> (vertices (V, 3), joints (J, 3))."""
    dev = model.v_template.device
    v_shaped = model.v_template + torch.einsum("vcs,s->vc", model.shapedirs, betas)
    if expression is not None and model.num_expr > 0:
        v_shaped = v_shaped + torch.einsum("vce,e->vc", model.expr_dirs,
                                           expression[:model.num_expr])
    joints = model.J_regressor @ v_shaped
    rots = rodrigues(pose)                                        # (J, 3, 3)
    pose_feat = (rots[1:] - torch.eye(3, device=dev)[None]).reshape(-1)
    n_feat = model.posedirs.shape[0]
    v_posed = v_shaped + (pose_feat[:n_feat] @ model.posedirs).reshape(-1, 3)

    # kinematic chain: world transforms per joint
    J = model.num_joints
    parents = model.parents
    key = "parents" + parents.tobytes().hex()
    has_parent = device_constant(key + "has", dev, lambda: (parents >= 0)[:, None])
    parent_idx = device_constant(key + "idx", dev, lambda: np.maximum(parents, 0))
    rel = joints - torch.where(has_parent, joints[parent_idx], torch.zeros((), device=dev))
    bottom = device_constant("bottom", dev, lambda: np.array([[0.0, 0.0, 0.0, 1.0]], np.float32))
    local = torch.cat([torch.cat([rots, rel[:, :, None]], 2),
                       bottom.expand(J, 1, 4)], 1)                # (J, 4, 4)
    transforms = [None] * J
    for j in range(J):  # the tree is tiny and static
        p = int(parents[j])
        transforms[j] = local[j] if p < 0 else transforms[p] @ local[j]
    A = torch.stack(transforms)                                   # (J, 4, 4)
    # remove the rest-pose joint locations
    joints_h = torch.cat([joints, torch.zeros((J, 1), device=dev)], -1)
    corr = torch.einsum("jab,jb->ja", A, joints_h)
    A = torch.cat([A[:, :3, :3], (A[:, :3, 3] - corr[:, :3])[:, :, None]], 2)   # (J, 3, 4)

    T = torch.einsum("vj,jab->vab", model.lbs_weights, A)          # (V, 3, 4)
    verts = torch.einsum("vab,vb->va", T[:, :, :3], v_posed) + T[:, :, 3]
    posed_joints = model.J_regressor @ verts
    if global_transl is not None:
        verts = verts + global_transl
        posed_joints = posed_joints + global_transl
    return verts, posed_joints


def random_test_model(rng: np.random.Generator, num_verts: int = 64,
                      num_joints: int = 4, num_betas: int = 5,
                      num_expr: int = 0, device="cuda") -> SMPLXModel:
    """A tiny synthetic model for unit tests (no external assets), drawn from
    `rng` in the JAX package's order; vertices centred at the origin."""
    verts = ((rng.random((num_verts, 3)) - 0.5) * 0.4).astype(np.float32)
    parents = np.array([-1] + [j // 2 for j in range(num_joints - 1)])
    Jr = rng.random((num_joints, num_verts)).astype(np.float32)
    Jr /= Jr.sum(-1, keepdims=True)
    W = rng.random((num_verts, num_joints)).astype(np.float32)
    W /= W.sum(-1, keepdims=True)
    return SMPLXModel(
        v_template=_t(verts, device),
        shapedirs=_t(rng.normal(size=(num_verts, 3, num_betas)).astype(np.float32) * 0.01,
                     device),
        posedirs=_t(rng.normal(size=((num_joints - 1) * 9, num_verts * 3))
                    .astype(np.float32) * 0.001, device),
        J_regressor=_t(Jr, device),
        parents=parents,
        lbs_weights=_t(W, device),
        faces=np.zeros((0, 3), np.int64),
        expr_dirs=(_t(rng.normal(size=(num_verts, 3, num_expr)).astype(np.float32) * 0.01,
                      device) if num_expr else None),
    )


def sphere_head_model(subdiv: int = 12, radius: float = 0.12, device="cuda") -> SMPLXModel:
    """A deterministic triangulated sphere 'head' (UV sphere) with one joint,
    the synthetic head of the full-loss fit tests."""
    th = np.linspace(0, np.pi, subdiv + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, 2 * subdiv, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                    -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]], 0) * radius
    nph = len(ph)
    faces = []
    for j in range(nph):  # caps (wound so normals point outward)
        faces.append([0, 1 + (j + 1) % nph, 1 + j])
        base = 1 + (len(th) - 1) * nph
        faces.append([len(verts) - 1, base + j, base + (j + 1) % nph])
    for i in range(len(th) - 1):
        for j in range(nph):
            a = 1 + i * nph + j
            b = 1 + i * nph + (j + 1) % nph
            c = a + nph
            d = b + nph
            faces += [[a, b, c], [b, d, c]]
    V = len(verts)
    return SMPLXModel(
        v_template=_t(verts, device),
        shapedirs=torch.zeros((V, 3, 2), device=device),
        posedirs=torch.zeros((0, V * 3), device=device),
        J_regressor=torch.full((1, V), 1.0 / V, device=device),
        parents=np.array([-1]),
        lbs_weights=torch.ones((V, 1), device=device),
        faces=np.asarray(faces, np.int64),
    )
