"""Bust-fit optimisation (port of monohair_tpu/bustfit/optimize.py): a global
similarity and the SMPL-X parameters against multi-view landmarks, iris,
silhouettes and shaded-image losses (the reference's SMPLX_optimizer.run).

- weighted 2D landmark L1, jaw contour (0:16) and brow points (31:35) x5,
  iris landmarks appended when available
- DECA's eye-distance loss over the eyelid pairs
- mesh-inside-mask hinge + hair-augmented huber mask loss against the soft
  mesh silhouette (soft_raster)
- masked image + albedo losses under FLAMETex-PCA albedo and 9-coefficient SH
  shading, one light a view
- parameter regularisers with the x1000 shoulder-pose anchor

Only global/neck/head/arms/jaw/eyes optimise; 'fix_shoulder' also pins
arms, head, jaw and eyes. The similarity (rot/trans/scale) is its own
parameter block, exported as model_tsfm.dat.

The fit is eager PyTorch on the model's device: optax's chain(zero_nans(),
clip_by_global_norm(1.0), adam(exponential_decay(lr, iters, 0.03))) over the
8 leaves of FitParams (``optim.OptaxAdam``). The JAX package renders the
colour losses one view at a time; here all views go through one call with
each view's own lights, which is the same arithmetic.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..camera import Cameras, ndc_to_pixel, project
from ..optim import OptaxAdam
from . import device_constant
from .smplx import SMPLXModel, lbs_forward, rodrigues
from .soft_raster import soft_render_colors, soft_silhouette_mesh, vertex_normals
from .texture import FlameTex, albedo_from_tex, shaded_vertex_colors

# SMPL-X joint ids: global 0, neck 12, head 15, leftarm 16, rightarm 17,
# jaw 22, eyes 23/24
FREE_JOINTS_DEFAULT = (0, 12, 15, 16, 17, 22, 23, 24)
FIX_SHOULDER_EXTRA = (15, 16, 17, 22, 23, 24)
SHOULDER_JOINTS = (16, 17)

# DECA eyelid pairs for the eye-distance loss (lossfunc.eyed_loss)
_EYE_UP = np.array([37, 38, 43, 44])
_EYE_LOW = np.array([41, 40, 47, 46])


class FitParams(NamedTuple):
    """Optimisable parameters (the reference's PoseModel + configure_optimizers)."""
    betas: torch.Tensor          # (S,)
    expression: torch.Tensor     # (E,)
    tex: torch.Tensor            # (T,)
    sh_light: torch.Tensor       # (V_views, 9, 3) per-view SH (per-frame lights)
    pose: torch.Tensor           # (J, 3) axis-angle deltas on free joints
    global_rot: torch.Tensor     # (3,) axis-angle
    global_transl: torch.Tensor  # (3,)
    log_scale: torch.Tensor      # ()


def init_params(model: SMPLXModel, num_views: int = 1, n_tex: int = 0) -> FitParams:
    dev = model.device
    return FitParams(torch.zeros(model.num_betas, device=dev),
                     torch.zeros(max(model.num_expr, 1), device=dev),
                     torch.zeros(n_tex, device=dev), torch.zeros((num_views, 9, 3), device=dev),
                     torch.zeros((model.num_joints, 3), device=dev),
                     torch.zeros(3, device=dev), torch.zeros(3, device=dev),
                     torch.zeros((), device=dev))


def fit_params_from_numpy(leaves: Sequence[np.ndarray], device="cuda") -> FitParams:
    """FitParams from its 8 leaves as numpy arrays (a JAX FitParams through
    np.asarray), in field order."""
    return FitParams(*(torch.as_tensor(np.array(x, np.float32), device=device)
                       for x in leaves))


def free_joint_mask(num_joints: int, fix_shoulder: bool = False) -> np.ndarray:
    """(J, 1) float mask of optimisable joints (PoseModel.forward fix_idx)."""
    mask = np.zeros((num_joints, 1), np.float32)
    for j in FREE_JOINTS_DEFAULT:
        if j < num_joints:
            mask[j] = 1.0
    if fix_shoulder:
        for j in FIX_SHOULDER_EXTRA:
            if j < num_joints:
                mask[j] = 0.0
    return mask


def effective_pose(params: FitParams, init_pose: torch.Tensor,
                   joint_mask: torch.Tensor) -> torch.Tensor:
    """init pose + deltas on the free joints (fixed joints stay at the init)."""
    return init_pose + joint_mask * params.pose


def default_init_pose(num_joints: int) -> np.ndarray:
    """The reference's init_full_pose: near-zero axis-angle with a +/-60 deg z
    shoulder preset; the root's pi x-flip is absorbed by the similarity."""
    pose = np.full((num_joints, 3), 1e-5, np.float32)
    if num_joints > 17:
        pose[16, 2] = -np.pi * 60 / 180
        pose[17, 2] = np.pi * 60 / 180
    return pose


def apply_similarity(params: FitParams, verts: torch.Tensor) -> torch.Tensor:
    Rg = rodrigues(params.global_rot[None])[0]
    return (torch.exp(params.log_scale) * (verts @ Rg.T)) + params.global_transl


def model_tsfm_matrix(params: FitParams) -> torch.Tensor:
    """The exported 4x4 similarity (model_tsfm.dat's content)."""
    Rg = rodrigues(params.global_rot[None])[0] * torch.exp(params.log_scale)
    top = torch.cat([Rg, params.global_transl[:, None]], 1)
    bottom = torch.zeros((1, 4), device=top.device)
    bottom[0, 3] = 1.0
    return torch.cat([top, bottom], 0)


def posed_vertices(model: SMPLXModel, params: FitParams, init_pose: torch.Tensor,
                   joint_mask: torch.Tensor) -> torch.Tensor:
    verts, _ = lbs_forward(model, params.betas,
                           effective_pose(params, init_pose, joint_mask),
                           expression=params.expression)
    return apply_similarity(params, verts)


# ---------------------------------------------------------------------------
# loss terms
# ---------------------------------------------------------------------------


def landmark_point_weights(n_lmk: int) -> np.ndarray:
    """Per-point weights: jaw contour 0:16 and 31:35 x5; appended iris points
    keep weight 1."""
    w = np.ones(n_lmk, np.float32)
    w[0:16] *= 5.0
    w[31:35] *= 5.0
    return w


def weighted_lmk_l1(pred_px: torch.Tensor, gt_px: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """lossfunc.batch_kp_2d_l1_loss: weighted mean L1 over (V, L, 2)."""
    return torch.mean(weights[None, :, None] * torch.abs(pred_px - gt_px))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm over the last axis, sqrt(sum(x^2)), whose gradient at 0
    is NaN as the JAX package's is (the optimiser zeroes it)."""
    return torch.sqrt(torch.sum(x * x, -1))


def eyed_loss(pred_px: torch.Tensor, gt_px: torch.Tensor) -> torch.Tensor:
    """DECA's eye-closure distance loss on the 68-landmark layout."""
    up = device_constant("eye_up", pred_px.device, lambda: _EYE_UP)
    low = device_constant("eye_low", pred_px.device, lambda: _EYE_LOW)
    pd = _norm(pred_px[:, up] - pred_px[:, low])
    gd = _norm(gt_px[:, up] - gt_px[:, low])
    return torch.mean(torch.abs(pd - gd))


def huber(pred: torch.Tensor, gt: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """lossfunc.huber == smooth-L1 mean."""
    err = torch.abs(pred - gt)
    quad = 0.5 * err ** 2 / delta
    return torch.mean(torch.where(err < delta, quad, err - 0.5 * delta))


def project_to_pixels(cameras: Cameras, image_size, pts: torch.Tensor) -> torch.Tensor:
    uv, _ = project(cameras, pts)
    return ndc_to_pixel(uv, image_size)


class FitTargets(NamedTuple):
    """Per-view ground truth. Pixel coords are (row, col); mask/image tensors
    are at the silhouette's scale."""
    lmk_px: torch.Tensor                       # (V, 68, 2)
    iris_px: Optional[torch.Tensor] = None     # (V, 2, 2)
    mask: Optional[torch.Tensor] = None        # (V, h, w) body matte in [0, 1]
    hair_mask: Optional[torch.Tensor] = None   # (V, h, w)
    face_mask: Optional[torch.Tensor] = None   # (V, h, w)
    image: Optional[torch.Tensor] = None       # (V, h, w, 3) linear RGB

    def to(self, device) -> "FitTargets":
        return FitTargets(*(None if x is None else
                            torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray)
                                            else x, device=device) for x in self))


DEFAULT_WEIGHTS: Dict[str, float] = {
    # the reference's _setup_loss_weight + configs/Bust_fit/base.yaml
    "lmk": 0.3, "eyed": 2.0, "inside_mask": 1.0, "mesh_mask": 1.0,
    "image": 2.0, "albedo": 2.0, "reg_shape": 1e-5, "reg_exp": 1e-5,
    "reg_tex": 5e-5, "reg_scale": 1.0, "reg_shoulder": 1000.0,
}


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device)


def fit_losses(model: SMPLXModel, params: FitParams, cameras: Cameras, image_size,
               targets: FitTargets, lmk_vertex_ids, iris_vertex_ids,
               init_pose: torch.Tensor, joint_mask: torch.Tensor,
               tex_model: Optional[FlameTex], weights: Dict[str, float],
               sil_scale: int = 8, sil_window: int = 8,
               sigma_px: float = 2.0) -> Dict[str, torch.Tensor]:
    """Every loss term, weighted, in the JAX package's order. The vertex ids
    and model.faces may be numpy or tensors on the device (the fit passes
    tensors)."""
    dev = model.device
    verts = posed_vertices(model, params, init_pose, joint_mask)
    losses: Dict[str, torch.Tensor] = {}

    pred_lmk = project_to_pixels(cameras, image_size, verts[_ids(lmk_vertex_ids, dev)])
    gt_lmk = targets.lmk_px
    if targets.iris_px is not None and iris_vertex_ids is not None:
        pred_iris = project_to_pixels(cameras, image_size, verts[_ids(iris_vertex_ids, dev)])
        pred_all = torch.cat([pred_lmk, pred_iris], 1)
        gt_all = torch.cat([gt_lmk, targets.iris_px], 1)
    else:
        pred_all, gt_all = pred_lmk, gt_lmk
    n = pred_all.shape[1]
    w_pts = device_constant(f"lmk_weights{n}", dev, lambda: landmark_point_weights(n))
    losses["lmk"] = weights["lmk"] * weighted_lmk_l1(pred_all, gt_all, w_pts)
    if weights.get("eyed", 0.0) > 0 and pred_lmk.shape[1] >= 68:
        losses["eyed"] = weights["eyed"] * eyed_loss(pred_lmk[:, :68], gt_lmk[:, :68])

    if targets.mask is not None and len(model.faces) > 0:
        mesh_mask = soft_silhouette_mesh(cameras, verts, model.faces, image_size,
                                         scale=sil_scale, window=sil_window, sigma_px=sigma_px)
        # hinge: the mesh stays inside the body matte
        losses["inside_mask"] = weights["inside_mask"] * torch.mean(
            torch.relu(mesh_mask - targets.mask))
        # hair-augmented coverage: hair pixels count as covered
        aug = mesh_mask
        if targets.hair_mask is not None:
            aug = mesh_mask + (1.0 - mesh_mask.detach()) * targets.hair_mask
        losses["mesh_mask"] = weights["mesh_mask"] * huber(aug, targets.mask)

    if targets.image is not None and tex_model is not None and len(model.faces):
        albedo = albedo_from_tex(tex_model, params.tex)
        normals = vertex_normals(verts, model.faces)
        shaded = shaded_vertex_colors(albedo, normals, params.sh_light)     # (V, N, 3)
        both = torch.cat([shaded, albedo[None].expand_as(shaded)], -1)
        out = soft_render_colors(cameras, verts, model.faces, both, image_size,
                                 scale=sil_scale, window=sil_window)
        image, albedo_img = out[..., :3], out[..., 3:]
        fm = (targets.face_mask if targets.face_mask is not None
              else torch.ones_like(image[..., 0]))[..., None]
        losses["image"] = weights["image"] * torch.mean(torch.abs(fm * (targets.image - image)))
        losses["albedo"] = weights["albedo"] * torch.mean(
            torch.abs(fm * (targets.image - albedo_img)))

    losses["reg_shape"] = weights["reg_shape"] * 0.5 * torch.sum(params.betas ** 2)
    losses["reg_exp"] = weights["reg_exp"] * 0.5 * torch.sum(params.expression ** 2)
    if params.tex.numel():
        losses["reg_tex"] = weights["reg_tex"] * 0.5 * torch.sum(params.tex ** 2)
    losses["reg_scale"] = weights["reg_scale"] * torch.exp(params.log_scale)
    sj = [j for j in SHOULDER_JOINTS if j < model.num_joints]
    if sj and weights.get("reg_shoulder", 0.0) > 0:
        pose_eff = effective_pose(params, init_pose, joint_mask)
        sj_t = device_constant(f"shoulders{sj}", dev, lambda: np.array(sj))
        # mean of abs: opposite-sign axis deltas cannot cancel before the
        # x1000 weight lands
        losses["reg_shoulder"] = weights["reg_shoulder"] * torch.mean(
            torch.abs(pose_eff[sj_t] - init_pose[sj_t]))
    return losses


def total_loss(terms: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The terms summed in insertion order from an f32 zero, as the JAX step
    sums them."""
    out = None
    for v in terms.values():
        out = v if out is None else out + v
    return out


def fit_step(params: FitParams, opt: OptaxAdam, loss_fn) -> torch.Tensor:
    """One Adam step on `params` (its leaves are opt.params); returns the loss
    before the step, as a tensor (reading it waits for the card)."""
    for p in params:
        p.requires_grad_(True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])
    return loss.detach()


def fit_setup(model: SMPLXModel, cameras: Cameras, image_size, targets: FitTargets,
              lmk_vertex_ids: np.ndarray, iris_vertex_ids: Optional[np.ndarray] = None,
              tex_model: Optional[FlameTex] = None, iters: int = 1000,
              fix_shoulder: bool = True, weights: Optional[Dict[str, float]] = None,
              lr: float = 5e-3, sil_scale: int = 8, sil_window: int = 8,
              start: Optional[FitParams] = None):
    """fit_bust_full's state before its first step: (params, optimiser,
    loss_fn(params) -> the summed loss), every table on the model's device."""
    dev = model.device
    weights = {**DEFAULT_WEIGHTS, **(weights or {})}
    n_tex = tex_model.n_tex if tex_model is not None else 0
    params = start if start is not None else init_params(model, cameras.num_views, n_tex)
    params = FitParams(*(p.detach().clone() for p in params))
    init_pose = torch.as_tensor(default_init_pose(model.num_joints), device=dev)
    joint_mask = torch.as_tensor(free_joint_mask(model.num_joints, fix_shoulder), device=dev)
    # the decay ends at 3% of lr; zero_nans and the clip keep the fit alive
    # under hostile targets (a failed detector can put a landmark anywhere)
    opt = OptaxAdam(list(params), lr, max(iters, 1), max_norm=1.0, decay_rate=0.03,
                    zero_nans=True)
    # every index table on the device once: a host copy each step would wait
    model = model._replace(faces=_ids(model.faces, dev))
    lmk = _ids(lmk_vertex_ids, dev)
    iris = None if iris_vertex_ids is None else _ids(iris_vertex_ids, dev)
    targets = targets.to(dev)

    def loss_fn(p: FitParams) -> torch.Tensor:
        return total_loss(fit_losses(model, p, cameras, image_size, targets, lmk, iris,
                                     init_pose, joint_mask, tex_model, weights,
                                     sil_scale=sil_scale, sil_window=sil_window))
    return params, opt, loss_fn


def fit_bust_full(model: SMPLXModel, cameras: Cameras, image_size, targets: FitTargets,
                  lmk_vertex_ids: np.ndarray, iris_vertex_ids: Optional[np.ndarray] = None,
                  tex_model: Optional[FlameTex] = None, iters: int = 1000,
                  fix_shoulder: bool = True, weights: Optional[Dict[str, float]] = None,
                  lr: float = 5e-3, sil_scale: int = 8, sil_window: int = 8,
                  log_every: int = 0) -> Tuple[FitParams, list]:
    """The full-objective fit: `iters` Adam steps over the whole multi-view
    batch on the model's device, from init_params. Returns the parameters
    and the loss at every tenth of the run (before that step)."""
    params, opt, loss_fn = fit_setup(model, cameras, image_size, targets, lmk_vertex_ids,
                                     iris_vertex_ids, tex_model, iters, fix_shoulder, weights,
                                     lr, sil_scale, sil_window)
    losses = []
    for i in range(iters):
        loss = fit_step(params, opt, loss_fn)
        if i % max(iters // 10, 1) == 0:
            losses.append(float(loss))
            if log_every and i % log_every == 0:
                print(f"[bust_fit] iter {i}/{iters} loss {losses[-1]:.5f}", flush=True)
    return FitParams(*(p.detach() for p in params)), losses


# ---------------------------------------------------------------------------
# the simple fit (landmarks + point-splat silhouette): the asset-free wig path
# and a cheap first stage
# ---------------------------------------------------------------------------


def landmark_loss(cameras: Cameras, image_size, verts: torch.Tensor, lmk_vertex_ids,
                  target_lmk_px: torch.Tensor, conf: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """L1 between projected landmark vertices and 2D targets per view;
    target_lmk_px (V, L, 2) (row, col)."""
    rc = project_to_pixels(cameras, image_size, verts[_ids(lmk_vertex_ids, verts.device)])
    err = torch.abs(rc - target_lmk_px)
    if conf is not None:
        err = err * conf[..., None]
    return torch.mean(err)


def soft_silhouette(cameras: Cameras, image_size, surface_pts: torch.Tensor,
                    res_divisor: int = 8, sigma_px: float = 2.0) -> torch.Tensor:
    """Differentiable low-res silhouette: a gaussian splat of surface samples
    (for meshes without faces). Returns (V, H/d, W/d) soft coverage."""
    H, W = image_size
    h, w = H // res_divisor, W // res_divisor
    uv, _ = project(cameras, surface_pts)
    rc = ndc_to_pixel(uv, (H, W)) / res_divisor                  # (V, N, 2)
    dev = surface_pts.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    s2 = (sigma_px / res_divisor) ** 2
    # separable gaussian weights -> (V, N, h) x (V, N, w)
    wr = torch.exp(-0.5 * (rc[..., 0:1] - rows) ** 2 / s2)
    wc = torch.exp(-0.5 * (rc[..., 1:2] - cols) ** 2 / s2)
    cover = torch.einsum("vnh,vnw->vhw", wr, wc)
    return 1.0 - torch.exp(-cover)


def fit_bust(model: SMPLXModel, cameras: Cameras, image_size, lmk_vertex_ids: np.ndarray,
             target_lmk_px: np.ndarray, target_masks: Optional[np.ndarray] = None,
             surface_sample_ids: Optional[np.ndarray] = None, iters: int = 500,
             lr: float = 1e-2, weights: Optional[Dict[str, float]] = None
             ) -> Tuple[FitParams, list]:
    """Landmark (+ splat silhouette) fit with plain Adam (optax.adam(lr));
    target_masks (V, H/8, W/8) in [0, 1]."""
    dev = model.device
    weights = weights or {"lmk": 1.0, "mask": 0.5, "reg": 1e-3}
    params = init_params(model)
    opt = OptaxAdam(list(params), lr, 1, max_norm=None, decay_rate=1.0)
    target_lmk = torch.as_tensor(np.asarray(target_lmk_px, np.float32), device=dev)
    masks = (torch.as_tensor(np.asarray(target_masks, np.float32), device=dev)
             if target_masks is not None else None)
    lmk = _ids(lmk_vertex_ids, dev)

    def loss_fn(p: FitParams) -> torch.Tensor:
        verts, _ = lbs_forward(model, p.betas, p.pose, expression=p.expression)
        verts = apply_similarity(p, verts)
        loss = weights["lmk"] * landmark_loss(cameras, image_size, verts, lmk, target_lmk)
        if masks is not None and surface_sample_ids is not None:
            sil = soft_silhouette(cameras, image_size, verts[_ids(surface_sample_ids, dev)])
            loss = loss + weights["mask"] * torch.mean(torch.abs(sil - masks))
        reg = torch.sum(p.betas ** 2) + torch.sum(p.pose ** 2)
        return loss + weights["reg"] * reg

    losses = []
    for i in range(iters):
        loss = fit_step(params, opt, loss_fn)
        if i % max(iters // 10, 1) == 0:
            losses.append(float(loss))
    return FitParams(*(p.detach() for p in params)), losses
