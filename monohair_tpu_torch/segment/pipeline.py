"""The hair segmentation step of stage 1 (port of monohair_tpu/segment/pipeline.py).

Writes mask/ (person matte), hair_mask/ (hair class) and mask_hair/ (blend)
for every capture image:
- if hair_mask/ already holds every frame, the step does nothing
  (idempotent by directory, the reference's dataprocess contract);
- if flax checkpoints are configured (segment.modnet_flax and
  segment.parser_flax), the MODNet matte and the BiSeNet hair parse run on the
  device in chunks of CHUNK frames, which bounds the device memory (the
  ensemble's 19-class logits at the frame size), with the reference's
  ensemble protocol (runners.py);
- otherwise a classical fallback (texture and luminance statistics plus
  morphology, on the host with scipy.ndimage) writes coarse masks.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from scipy import ndimage

from ..config import Config
from ..io.image_io import imread_rgb, imwrite
from ..ops.resize import bgr_to_gray

CHUNK = 4     # frames a batch of the nets


def _gaussian_kernel_cv(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) for GaussianBlur((0, 0), sigma) on
    float images: ksize = round(sigma * 8 + 1) | 1 taps, normalised."""
    ksize = int(round(sigma * 8 + 1)) | 1
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _morph(m: np.ndarray, size: int, close: bool) -> np.ndarray:
    """cv2.morphologyEx(m, MORPH_CLOSE / MORPH_OPEN, ones((size, size))) on a
    0/255 uint8 mask; OpenCV's border is neutral for both operations."""
    fp = np.ones((size, size), bool)
    dil = lambda a: ndimage.grey_dilation(a, footprint=fp, mode="constant", cval=0)
    ero = lambda a: ndimage.grey_erosion(a, footprint=fp, mode="constant", cval=255)
    return ero(dil(m)) if close else dil(ero(m))


def _largest_component(m: np.ndarray) -> np.ndarray:
    """connectedComponentsWithStats (8-connected): keep the largest blob."""
    labels, num = ndimage.label(m > 0, structure=np.ones((3, 3), int))
    if num >= 1:
        areas = np.bincount(labels.ravel())[1:]
        largest = 1 + int(np.argmax(areas))
        m = np.where(labels == largest, 255, 0).astype(np.uint8)
    return m


def _fallback_hair_mask(rgb: np.ndarray) -> np.ndarray:
    """Coarse classical segmentation: dark, texture-rich regions, largest blob
    (pipeline.py:29-44 of the JAX package, which runs it through OpenCV)."""
    gray = bgr_to_gray(torch.from_numpy(np.ascontiguousarray(rgb[..., ::-1]))).numpy()
    # texture response: cv2.Laplacian(gray, CV_32F, ksize=3), reflect-101 border
    k3 = np.array([[2, 0, 2], [0, -8, 0], [2, 0, 2]], np.float32)
    hp = ndimage.correlate(gray.astype(np.float32), k3, mode="mirror")
    k = _gaussian_kernel_cv(5.0)
    tex = ndimage.correlate1d(ndimage.correlate1d(hp * hp, k, axis=1, mode="mirror"),
                              k, axis=0, mode="mirror").astype(np.float32)
    tex = tex / max(float(tex.max()), 1e-6)
    m = ((tex > 0.02) & (gray < 140)).astype(np.uint8) * 255
    m = _morph(m, 9, close=True)
    m = _morph(m, 5, close=False)
    return _largest_component(m)


def _fallback_person_mask(rgb: np.ndarray, hair: np.ndarray) -> np.ndarray:
    """Coarse person matte (pipeline.py:47-67 of the JAX package): pixels far
    from the border's median colour, largest blob, holes filled, joined with
    the hair mask."""
    border = np.concatenate([rgb[0], rgb[-1], rgb[:, 0], rgb[:, -1]], 0)
    bg = np.median(border.reshape(-1, 3), axis=0)
    dist = np.linalg.norm(rgb.astype(np.float32) - bg[None, None], axis=-1)
    m = (dist > 45.0).astype(np.uint8) * 255
    m = _largest_component(_morph(m, 15, close=True))
    # floodFill(inv, (0, 0), 0), 4-connected: background reachable from the
    # corner is cleared, what is left of inv is a hole inside the person
    inv = (m == 0).astype(np.uint8)
    labels, _ = ndimage.label(inv == inv[0, 0])
    ff = np.where(labels == labels[0, 0], 0, inv)
    m = np.where((m > 0) | (ff > 0), 255, 0).astype(np.uint8)
    return np.maximum(m, hair)


def _neural_masks(files: List[str], img_dir: str, cfg: Config, device):
    """Yield (file, rgb, matte, hair) per frame: MODNet matte and BiSeNet hair
    parse in chunks of CHUNK frames."""
    from .runners import MattingRunner, ParsingRunner

    seg = cfg.get("segment", {})
    matting = MattingRunner(seg["modnet_flax"], width=float(seg.get("modnet_width", 1.0)),
                            ref_size=int(seg.get("matte_size", 512)), device=device)
    parser = ParsingRunner(seg["parser_flax"], n_classes=int(seg.get("parser_classes", 19)),
                           width=float(seg.get("parser_width", 1.0)),
                           input_size=int(seg.get("parse_size", 512)), device=device)
    for beg in range(0, len(files), CHUNK):
        names = files[beg:beg + CHUNK]
        rgbs = [imread_rgb(os.path.join(img_dir, f)) for f in names]
        imgs = torch.as_tensor(np.stack(rgbs), device=device)
        matte = matting.matte(imgs)
        hair = parser.hair_mask(imgs, matte)
        for f, rgb, m, h in zip(names, rgbs, matte.cpu().numpy(), hair.cpu().numpy()):
            yield f, rgb, m, h


def calculate_masks(args: Config, device="cuda") -> List[str]:
    root = args.data.root
    img_dir = os.path.join(root, "capture_images")
    files = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []
    hair_dir = os.path.join(root, "hair_mask")
    mask_dir = os.path.join(root, "mask")
    blend_dir = os.path.join(root, "mask_hair")
    if files and os.path.isdir(hair_dir) and all(
            os.path.exists(os.path.join(hair_dir, f)) for f in files):
        print("[segment] hair_mask/ complete — skipping (idempotent)")
        return files
    for d in (hair_dir, mask_dir, blend_dir):
        os.makedirs(d, exist_ok=True)

    seg = args.get("segment", {}) or {}
    neural = (seg.get("modnet_flax") and os.path.exists(seg["modnet_flax"])
              and seg.get("parser_flax") and os.path.exists(seg["parser_flax"]))
    if neural:
        for f, rgb, matte, hair in _neural_masks(files, img_dir, args, device):
            imwrite(os.path.join(mask_dir, f),
                      np.clip(matte * 255.0, 0, 255).astype(np.uint8))
            imwrite(os.path.join(hair_dir, f), hair)
            blend = (hair[..., None].astype(np.float32) * 0.5
                     + rgb.astype(np.float32) * 0.5)
            imwrite(os.path.join(blend_dir, f), blend.astype(np.uint8))
        return files

    print("[segment] no neural checkpoints configured — classical fallback")
    for f in files:
        rgb = imread_rgb(os.path.join(img_dir, f))
        hair = _fallback_hair_mask(rgb)
        imwrite(os.path.join(hair_dir, f), hair)
        imwrite(os.path.join(mask_dir, f), _fallback_person_mask(rgb, hair))
        blend = rgb.copy()
        blend[hair > 0] = 0.5 * blend[hair > 0] + np.array([127.5, 0, 0])
        imwrite(os.path.join(blend_dir, f), blend)
    return files
