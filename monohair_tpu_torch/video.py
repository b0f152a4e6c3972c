"""Video frame extraction: the sharpest frame of every ``interval`` frames by
Laplacian variance (port of monohair_tpu/video.py; reference
video_preprocess/process_video.py:4-61).

The video is decoded by the port's codecs (io/video.py: mp4v, and H.264 as a
phone records it), which give cv2.VideoCapture's frames, turned by the file's
display matrix as cv2 turns them (a portrait phone video gives portrait
frames); the sharpness is computed on the device with the
same gray conversion and Laplacian as prepare_data's frame selection; the
kept frames are written through io/image_io.imwrite (PNG or JPEG by the
name's suffix).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .io.image_io import imwrite
from .io.video import read_video
from .ops.resize import bgr_to_gray, laplacian_variance


def extract_sharpest_frames(video_path: str, out_dir: str, interval: int = 5,
                            name_fmt: str = "frame_{:05d}.png", device="cuda") -> List[str]:
    """Decode the video (mp4v or H.264 in MP4/QuickTime; other codecs raise
    io.video.UnsupportedVideoError), keep the sharpest frame of every
    `interval` frames (a strict ``>``, so the first of equals wins; a
    trailing partial interval is dropped). Frames are as displayed: rotated
    by the display matrix. Returns the names written into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    kept = []
    best, best_frame, count = 0.0, None, 0
    for frame in read_video(video_path):
        bgr = torch.as_tensor(frame, device=device)
        sharp = float(laplacian_variance(bgr_to_gray(bgr)))
        if sharp > best:
            best, best_frame = sharp, frame
        count += 1
        if count == interval:
            name = name_fmt.format(len(kept))
            imwrite(os.path.join(out_dir, name), np.ascontiguousarray(best_frame[..., ::-1]))
            kept.append(name)
            best, best_frame, count = 0.0, None, 0
    return kept
