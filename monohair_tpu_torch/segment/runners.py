"""Inference runners of the segmentation and landmark nets (port of
monohair_tpu/segment/runners.py), on tensors on any device.

The reference's protocols, with OpenCV's resizes written out
(``ops/resize.py``) in the same order and of the same kinds:
 - MattingRunner: MODNet matte at ref 512. The uint8 frame is area-resized to
   ``_modnet_size`` (multiples of 32), normalised to [-1, 1], and the matte
   area-resized back to the frame (calc_masks.py:38-64).
 - ParsingRunner: BiSeNet at 512x512. The uint8 frame is resized linearly (in
   OpenCV's fixed point) to 512, ImageNet-normalised, run at scales
   0.66/0.80/1.0 (float linear resizes) each with its horizontal flip and the
   left/right class swap, the three mean-fused logits resized back (linear)
   and summed, divided by 3 and resized to the frame (cubic); argmax per pixel
   (calc_masks.py:67-124).
 - LandmarkRunner: FAN on square face crops. Each box is cut from the uint8
   frame into a zero-padded square, resized linearly (fixed point) to 256,
   scaled to [0, 1]; the last module's heatmaps decode on the host to the
   sub-pixel argmax and map back to frame pixels (dataprocess.py:327-373).

Frames are (N, H, W, 3) uint8 RGB tensors; outputs stay on their device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_area, resize_cubic, resize_linear
from .bisenet import HAIR_CLASS, BiSeNet
from .convert import load_flax_npz
from .fan import FAN, decode_heatmaps
from .modnet import MODNet

# CelebAMask-HQ left/right pairs swapped under horizontal flip
# (l_brow/r_brow, l_eye/r_eye, l_ear/r_ear)
FLIP_PAIRS = ((2, 3), (4, 5), (7, 8))

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def save_flax_tree(path: str, tree: dict) -> None:
    """A nested dict of arrays -> an .npz of "a/b/c" keys, in the dict's
    order: the JAX package's files, member for member."""
    flat = {}

    def walk(node: dict, prefix: str) -> None:
        for k, v in node.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat[p] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_flax_tree(path: str) -> dict:
    """The nested dict of an .npz of "a/b/c" keys (save_flax_tree's inverse)."""
    d = np.load(path)
    tree: dict = {}
    for k in d.files:
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = d[k]
    return tree


def _modnet_size(h: int, w: int, ref: int = 512) -> Tuple[int, int]:
    """obtain_modnet_mask's resize rule (calc_masks.py:45-57): scale the short
    side to ref when outside [ref..], then floor both to multiples of 32."""
    if max(h, w) < ref or min(h, w) > ref:
        if w >= h:
            rh, rw = ref, int(w / h * ref)
        else:
            rw, rh = ref, int(h / w * ref)
    else:
        rh, rw = h, w
    return rh - rh % 32, rw - rw % 32


def _planar(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


class MattingRunner:
    def __init__(self, ckpt_path: str, width: float = 1.0, ref_size: int = 512,
                 device="cuda"):
        self.net = load_flax_npz(MODNet(width=width), ckpt_path).to(device)
        self.ref_size = ref_size

    @torch.inference_mode()
    def matte(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, H, W, 3) uint8 RGB -> (N, H, W) float32 matte in [0, 1]."""
        n, H, W, _ = images.shape
        rh, rw = _modnet_size(H, W, self.ref_size)
        x = resize_area(_planar(images), (rh, rw)).float()
        x = (x / 255.0 - 0.5) / 0.5
        m = self.net(x)[2]
        return resize_area(m, (H, W))[:, 0]


class ParsingRunner:
    def __init__(self, ckpt_path: str, n_classes: int = 19, width: float = 1.0,
                 input_size: int = 512, scales: Sequence[float] = (0.66, 0.80, 1.0),
                 device="cuda"):
        self.net = load_flax_npz(BiSeNet(n_classes=n_classes, width=width),
                                 ckpt_path).to(device)
        self.input_size = input_size
        self.scales = tuple(scales)
        perm = list(range(n_classes))
        for a, b in FLIP_PAIRS:
            if a < n_classes and b < n_classes:
                perm[a], perm[b] = b, a
        self.perm = torch.tensor(perm, device=device)
        self.mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
        self.std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]

    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.net(x)[0]
        flipped = self.net(x.flip(-1))[0].flip(-1)
        # left/right class swap under the flip (calc_masks.py:106-109)
        return 0.5 * (logits + flipped[:, self.perm])

    @torch.inference_mode()
    def class_probs(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, H, W, 3) uint8 RGB -> (N, C, H, W) ensemble logits."""
        n, H, W, _ = images.shape
        s0 = self.input_size
        base = resize_linear(_planar(images), (s0, s0)).float()
        base = (base / 255.0 - self.mean) / self.std
        fused = None
        for s in self.scales:
            side = int(s0 * s)
            x = base if side == s0 else resize_linear(base, (side, side))
            out = resize_linear(self._fwd(x), (s0, s0))
            fused = out if fused is None else fused + out
        fused = fused / len(self.scales)
        return resize_cubic(fused, (H, W))

    def parse(self, images: torch.Tensor) -> torch.Tensor:
        """-> (N, H, W) uint8 class-id map."""
        return torch.argmax(self.class_probs(images), 1).to(torch.uint8)

    def hair_mask(self, images: torch.Tensor,
                  matte: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Hair-class mask modulated by the person matte (calc_masks.py:217-224)
        -> (N, H, W) uint8 in [0, 255]."""
        hair = (self.parse(images) == HAIR_CLASS).float()
        if matte is not None:
            hair = hair * matte
        return (hair * 255.0 + 0.5).to(torch.uint8)


class LandmarkRunner:
    def __init__(self, ckpt_path: str, width: float = 1.0, num_modules: int = 4,
                 depth: int = 4, crop_size: int = 256, device="cuda"):
        self.net = load_flax_npz(FAN(num_modules=num_modules, depth=depth, width=width),
                                 ckpt_path).to(device)
        self.crop_size = crop_size
        self.device = torch.device(device)

    @torch.inference_mode()
    def heatmaps(self, images: torch.Tensor, boxes: np.ndarray) -> torch.Tensor:
        """images (N, H, W, 3) uint8 RGB; boxes (N, 4) [x0, y0, x1, y1] ->
        the last module's (N, 68, h, w) heatmaps of the square crops."""
        cs = self.crop_size
        crops = []
        for im, (x0, y0, x1, y1) in zip(images, np.asarray(boxes).astype(int)):
            side = max(x1 - x0, y1 - y0, 1)
            pad = torch.zeros((side, side, 3), dtype=im.dtype, device=im.device)
            sx0, sy0 = max(x0, 0), max(y0, 0)
            sx1, sy1 = min(x0 + side, im.shape[1]), min(y0 + side, im.shape[0])
            if sx1 > sx0 and sy1 > sy0:
                pad[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = im[sy0:sy1, sx0:sx1]
            crops.append(resize_linear(pad.permute(2, 0, 1)[None], (cs, cs))[0])
        x = torch.stack(crops).to(self.device).float() / 255.0
        return self.net(x)[-1]

    def landmarks(self, images: torch.Tensor, boxes: np.ndarray) -> np.ndarray:
        """-> (N, 68, 2) float32 landmark pixels (x, y) in the frames."""
        heat = self.heatmaps(images, boxes).permute(0, 2, 3, 1).cpu().numpy()
        pts = decode_heatmaps(heat)                        # heatmap px (x, y)
        hm = heat.shape[1]
        out = np.zeros_like(pts)
        for i, (x0, y0, x1, y1) in enumerate(np.asarray(boxes).astype(int)):
            side = max(x1 - x0, y1 - y0, 1)
            out[i] = pts[i] * (side / hm) + (x0, y0)
        return out


def face_box_from_mask(mask: np.ndarray, thresh: float = 0.5) -> np.ndarray:
    """Square crop box from a person/skin mask (the stand-in for the
    reference's SFD face detector): the mask's bbox, squared about its centre."""
    ys, xs = np.nonzero(mask > thresh)
    if len(ys) == 0:
        h, w = mask.shape
        return np.array([0, 0, w, h], np.float32)
    x0, x1, y0, y1 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
    side = max(x1 - x0, y1 - y0)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    return np.array([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], np.float32)
