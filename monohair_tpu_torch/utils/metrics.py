"""Quality metrics (port of monohair_tpu/utils/metrics.py): occupancy
precision/recall (Utils/Utils.py:336-363 OccMetric), strand direction cosine
error, PSNR and SSIM (run.py:212-270 harness). numpy only; SSIM's box filter is
cv2.blur's, written out."""

from __future__ import annotations

from typing import Dict

import numpy as np


class OccMetric:
    """Accumulating precision/recall over boolean occupancy predictions."""

    def __init__(self):
        self.tp = 0
        self.pred_pos = 0
        self.gt_pos = 0

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        pred = np.asarray(pred) > 0
        gt = np.asarray(gt) > 0
        self.tp += int((pred & gt).sum())
        self.pred_pos += int(pred.sum())
        self.gt_pos += int(gt.sum())

    def precision(self) -> float:
        return self.tp / max(self.pred_pos, 1)

    def recall(self) -> float:
        return self.tp / max(self.gt_pos, 1)

    def summary(self) -> Dict[str, float]:
        return {"precision": self.precision(), "recall": self.recall()}


def direction_cosine_error(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean (1 - |cos|) between predicted and GT unit directions."""
    p = pred / np.maximum(np.linalg.norm(pred, axis=-1, keepdims=True), 1e-12)
    g = gt / np.maximum(np.linalg.norm(gt, axis=-1, keepdims=True), 1e-12)
    return float(np.mean(1.0 - np.abs(np.sum(p * g, -1))))


def psnr(img: np.ndarray, ref: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(img, np.float64) - np.asarray(ref, np.float64)) ** 2))
    return -10.0 * float(np.log10(max(mse, 1e-12)))


def box_blur(img: np.ndarray, win: int) -> np.ndarray:
    """cv2.blur(img, (win, win)) of a 2-D float64 image: the mean over a
    win x win window centred on each pixel, past the border OpenCV's default
    BORDER_REFLECT_101 (numpy's 'reflect': the edge pixel is not repeated)."""
    r = win // 2
    x = np.pad(img, ((r, win - 1 - r), (r, win - 1 - r)), mode="reflect")
    H, W = img.shape
    rows = sum(x[:, k:k + W] for k in range(win))
    return sum(rows[k:k + H] for k in range(win)) / float(win * win)


def ssim(img: np.ndarray, ref: np.ndarray, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2, win: int = 7) -> float:
    """Mean structural similarity over a uniform window (grayscale or mean-RGB)."""
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    if a.ndim == 3:
        a = a.mean(-1)
        b = b.mean(-1)
    mu_a = box_blur(a, win)
    mu_b = box_blur(b, win)
    var_a = box_blur(a * a, win) - mu_a ** 2
    var_b = box_blur(b * b, win) - mu_b ** 2
    cov = box_blur(a * b, win) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(s.mean())
