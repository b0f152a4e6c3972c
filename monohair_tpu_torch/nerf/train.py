"""The coarse NeRF's training loop, full-frame render and PSNR (port of
monohair_tpu/nerf/train.py).

train_nerf takes random-ray Adam steps over the capture images, which stay on
the device as uint8 rint(x * 255). Each step draws its rays (frame and pixel
indices), its stratified sample offsets and, for a field with a sparsity
weight, 4096 uniform unit-cube points (``StepDraws``): from a
``torch.Generator`` on the device, or from the caller (the tests pass the
JAX package's draws, so that only the draws differ between the packages,
never the arithmetic).

The optimiser is optax's chain(clip_by_global_norm(10), adam(
exponential_decay(lr, total_steps or steps, 0.1))) written out
(``optim.OptaxAdam``): torch.optim's Adam and clip_grad_norm_ round and clip
otherwise.

The JAX loop's TPU-only knobs (scan_block, sync_every, use_remat and the
platform_limits shape asserts) guard the TPU's fault boundaries and have no
counterpart here.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..io.image_io import imread_rgb
from ..optim import OptaxAdam
from ..utils.metrics import psnr  # noqa: F401  (the JAX module's name for it)
from .ngp import (as_background, camera_rays, init_occupancy_grid, render_rays,
                  render_rays_occ, update_occupancy_grid)

SPARSITY_POINTS = 4096


class NerfDataset(NamedTuple):
    images: np.ndarray     # (F, H, W, 3) float32 in [0, 1]
    c2w: np.ndarray        # (F, 4, 4) NeRF convention
    fx: float
    fy: float
    cx: float
    cy: float


def load_nerf_dataset(transforms_path: str, image_root: str,
                      max_images: Optional[int] = None) -> NerfDataset:
    """The frames of transforms.json (sorted by name) found in `image_root`
    as .png, .jpg or .JPG (in that order, as cv2.imread reads them), with the
    colmap2nerf intrinsics when the file has them, else square pixels from
    camera_angle_y and a centred principal point."""
    from .poses import load_transforms_json
    xforms, fov, intr = load_transforms_json(transforms_path, return_intrinsics=True)
    names = list(xforms)
    if max_images:
        names = names[:: max(1, len(names) // max_images)][:max_images]
    imgs, poses = [], []
    for n in names:
        for ext in (".png", ".jpg", ".JPG"):
            p = os.path.join(image_root, n + ext)
            if os.path.exists(p):
                imgs.append(imread_rgb(p).astype(np.float32) / 255.0)
                poses.append(xforms[n])
                break
    images = np.stack(imgs)
    H, W = images.shape[1:3]
    fy = H / 2.0 / math.tan(math.radians(fov) / 2.0)
    fx = float(intr["fl_x"]) if intr.get("fl_x") else fy
    fy = float(intr["fl_y"]) if intr.get("fl_y") else fy
    cx = float(intr["cx"]) if intr.get("cx") else W / 2.0
    cy = float(intr["cy"]) if intr.get("cy") else H / 2.0
    return NerfDataset(images, np.stack(poses).astype(np.float32), fx=fx, fy=fy, cx=cx, cy=cy)


class StepDraws(NamedTuple):
    """One training step's random draws (the JAX loop's jax.random calls)."""
    frames: torch.Tensor                     # (B,) int64 in [0, F)
    pixels: torch.Tensor                     # (B,) int64 in [0, H*W)
    u: torch.Tensor                          # (B, S) U[0, 1): stratified offsets
    sparse: Optional[torch.Tensor] = None    # (4096, 3) U[0, 1): sparsity points
    occ_jitter: Optional[torch.Tensor] = None  # (R^3, 3) U[0, 1): occupancy update


def draw_step(generator: torch.Generator, num_frames: int, num_pixels: int, rays: int,
              samples: int, sparse: bool, occ_resolution: Optional[int] = None
              ) -> StepDraws:
    """A step's draws from `generator`, on its device."""
    dev = generator.device
    return StepDraws(
        frames=torch.randint(0, num_frames, (rays,), generator=generator, device=dev),
        pixels=torch.randint(0, num_pixels, (rays,), generator=generator, device=dev),
        u=torch.rand((rays, samples), generator=generator, device=dev),
        sparse=(torch.rand((SPARSITY_POINTS, 3), generator=generator, device=dev)
                if sparse else None),
        occ_jitter=(torch.rand((occ_resolution ** 3, 3), generator=generator, device=dev)
                    if occ_resolution else None))


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float) -> torch.Tensor:
    """optax.huber_loss: 0.5 min(|e|, delta)^2 + delta (|e| - min(|e|, delta))."""
    a = torch.abs(pred - target)
    q = torch.clamp_max(a, delta)
    return 0.5 * q ** 2 + delta * (a - q)


def ray_batch(imgs_u8: torch.Tensor, c2w_all: torch.Tensor, frames: torch.Tensor,
              pixels: torch.Tensor, W: int, fx: float, fy: float, cx: float, cy: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(origins, unit directions, target rgb in [0, 1]) of the drawn rays;
    imgs_u8 is (F, H*W, 3) uint8."""
    target = imgs_u8[frames, pixels].float() / 255.0
    rows = torch.div(pixels, W, rounding_mode="floor").float()
    cols = (pixels % W).float()
    c2w = c2w_all[frames]
    x = (cols + 0.5 - cx) / fx
    y = -(rows + 0.5 - cy) / fy
    dirs = torch.stack([x, y, -torch.ones_like(x)], -1)
    d = torch.einsum("nij,nj->ni", c2w[:, :3, :3], dirs)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:, :3, 3], d, target


def nerf_loss(field: nn.Module, o: torch.Tensor, d: torch.Tensor, target: torch.Tensor,
              draws: StepDraws, num_samples: int = 64, background: Optional[torch.Tensor] = None,
              tv_weight: float = 0.0, occ_grid: Optional[torch.Tensor] = None,
              num_fine: int = 64) -> torch.Tensor:
    """A step's loss: mean huber(delta 0.1) of the rendered rgb, plus
    tv_weight * field.tv() for a grid field, plus sparsity_weight *
    mean(1 - exp(-0.05 sigma)) at the drawn unit-cube points. With occ_grid
    the rays are rendered through the grid (num_samples coarse lookups,
    num_fine MLP samples), else with num_samples uniform samples."""
    if occ_grid is not None:
        rgb = render_rays_occ(field, occ_grid, o, d, num_coarse=num_samples,
                              num_fine=num_fine, u=draws.u, background=background)[0]
    else:
        rgb = render_rays(field, o, d, num_samples, u=draws.u, background=background)[0]
    loss = torch.mean(huber_loss(rgb, target, 0.1))
    if tv_weight > 0.0 and hasattr(field, "tv"):
        loss = loss + tv_weight * field.tv()
    sparsity_w = float(getattr(field, "sparsity_weight", 0.0))
    if sparsity_w > 0.0:
        sigma = field.density(draws.sparse)[0]
        loss = loss + sparsity_w * torch.mean(1.0 - torch.exp(-0.05 * sigma))
    return loss


def train_nerf(ds: NerfDataset, field: nn.Module, steps: int = 4000,
               rays_per_batch: int = 4096, lr: float = 1e-2, seed: int = 0,
               log_every: int = 500, use_occupancy: bool = True, occ_resolution: int = 128,
               occ_update_every: int = 16, occ_warmup: int = 256, num_samples: int = 64,
               num_fine: int = 64, verbose: bool = False, tv_weight: float = 0.0,
               total_steps: Optional[int] = None, background=None,
               draws: Optional[Sequence[StepDraws]] = None
               ) -> Tuple[nn.Module, List[float], Optional[torch.Tensor]]:
    """Train `field` (initialised, on its device) in place; returns (field,
    losses at the log points, occupancy grid or None).

    After `occ_warmup` uniform steps an EMA occupancy grid is kept (updated
    before every `occ_update_every`-th step from the last update) and the
    steps render through it. Draws come from a torch.Generator seeded with
    `seed` on the field's device, or from `draws` (one StepDraws a step)."""
    dev = next(field.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    F, H, W = ds.images.shape[:3]
    imgs_u8 = torch.as_tensor(np.clip(np.rint(ds.images.reshape(F, H * W, 3) * 255.0), 0, 255)
                              .astype(np.uint8), device=dev)
    c2w_all = torch.as_tensor(ds.c2w, dtype=torch.float32, device=dev)
    bg = as_background(background, dev)
    sparse = float(getattr(field, "sparsity_weight", 0.0)) > 0.0
    params = [p for p in field.parameters() if p.requires_grad]
    opt = OptaxAdam(params, lr, total_steps or steps)
    occ_grid = init_occupancy_grid(occ_resolution if use_occupancy else 1, device=dev)
    losses: List[float] = []
    next_log, last_update = 0, None
    for step in range(steps):
        in_occ = use_occupancy and step >= occ_warmup
        do_update = in_occ and (last_update is None or step - last_update >= occ_update_every)
        if draws is not None:
            dr = draws[step]
        else:
            dr = draw_step(gen, F, H * W, rays_per_batch, num_fine if in_occ else num_samples,
                           sparse, occ_resolution if do_update else None)
        if do_update:
            last_update = step
            with torch.no_grad():
                occ_grid = update_occupancy_grid(field, occ_grid, dr.occ_jitter)
        o, d, target = ray_batch(imgs_u8, c2w_all, dr.frames, dr.pixels, W,
                                 ds.fx, ds.fy, ds.cx, ds.cy)
        loss = nerf_loss(field, o, d, target, dr, num_samples, bg, tv_weight,
                         occ_grid if in_occ else None, num_fine)
        grads = torch.autograd.grad(loss, params)
        opt.step(grads)
        if step + 1 > next_log:
            losses.append(float(loss.detach()))
            next_log += log_every
            if verbose:
                print(f"[nerf] step {step + 1}/{steps} loss {losses[-1]:.5f}", flush=True)
    return field, losses, occ_grid if use_occupancy else None


@torch.no_grad()
def render_image(field: nn.Module, c2w: np.ndarray, H: int, W: int, fx: float, fy: float,
                 cx: float, cy: float, chunk: int = 16384,
                 occ_grid: Optional[torch.Tensor] = None, num_fine: int = 96,
                 background=None) -> Tuple[np.ndarray, np.ndarray]:
    """Full-frame (rgb (H, W, 3), depth (H, W)) on the host, rendered on the
    field's device in chunks of `chunk` pixels (row-major, the last chunk
    padded with pixel (0, 0); a frame of fewer pixels is one chunk of its
    own size): 192 uniform samples a ray, or with occ_grid
    192 grid lookups and `num_fine` guided samples. `background` must be
    training's for faithful renders."""
    dev = next(field.parameters()).device
    bg = as_background(background, dev)
    rows, cols = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([rows, cols], -1).reshape(-1, 2).astype(np.float32)
    chunk = min(chunk, len(pix))
    n_chunks = -(-len(pix) // chunk)
    pad = n_chunks * chunk - len(pix)
    if pad:
        pix = np.concatenate([pix, np.zeros((pad, 2), np.float32)])
    pix = torch.as_tensor(pix, device=dev)
    c2w_t = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    rgb, depth = [], []
    for beg in range(0, len(pix), chunk):
        o, d = camera_rays(c2w_t, fx, fy, cx, cy, pix[beg:beg + chunk])
        if occ_grid is not None:
            r, z, _ = render_rays_occ(field, occ_grid, o, d, num_coarse=192,
                                      num_fine=num_fine, background=bg)
        else:
            r, z, _ = render_rays(field, o, d, 192, background=bg)
        rgb.append(r)
        depth.append(z)
    rgb = torch.cat(rgb)[:H * W].cpu().numpy()
    depth = torch.cat(depth)[:H * W].cpu().numpy()
    return rgb.reshape(H, W, 3), depth.reshape(H, W)
