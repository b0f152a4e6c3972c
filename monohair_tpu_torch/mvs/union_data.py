"""Union training-data packing: per-view PNG stacks -> one binary file per
modality (port of monohair_tpu/mvs/union_data.py; reference
integrate_fix_view_data, Utils/Utils.py:671-751).

Training IO reads one memory-mappable .dat a modality instead of V small PNGs.
The layouts are the reference's: 'orient_union' is NCHW uint8 over the first
two RGB channels, the rest (V, H, W) uint8. The PNGs are read with the port's
codec, with cv2.imread's rules: IMREAD_GRAYSCALE turns an RGB PNG gray with
libpng's 15-bit weights (`io.image_io.imread_gray`).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from ..io.image_io import imread_gray, imread_rgb


def pack_case(case_views_dir: str, dst_case_dir: str,
              modalities=("dir", "conf", "mask", "depth"),
              model_tsfm_src: Optional[str] = None) -> List[str]:
    """Pack one case's views directory into union .dat files; returns the
    names written."""
    os.makedirs(dst_case_dir, exist_ok=True)
    views = sorted(os.listdir(case_views_dir))
    written = []
    if model_tsfm_src and os.path.exists(model_tsfm_src):
        shutil.copyfile(model_tsfm_src, os.path.join(dst_case_dir, "model_tsfm.dat"))
        written.append("model_tsfm.dat")

    def read(view, name, gray=True):
        p = os.path.join(case_views_dir, view, name)
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        return imread_gray(p) if gray else imread_rgb(p)

    def write(name, stack):
        stack.astype(np.uint8).tofile(os.path.join(dst_case_dir, name))
        written.append(name)

    if "dir" in modalities:
        orient = np.stack([read(v, "dense.png", gray=False)[..., :2] for v in views])
        write("orient_union.dat", orient.transpose(0, 3, 1, 2))
    if "conf" in modalities:
        write("conf_union.dat", np.stack([read(v, "raw_conf.png") for v in views]))
    if "mask" in modalities:
        write("mask_union.dat", np.stack([read(v, "mask.png") for v in views]))
    if "depth" in modalities:
        write("depth_union.dat", np.stack([read(v, "bust_depth.png") for v in views]))
        write("bust_hair_depth_union.dat",
              np.stack([read(v, "bust_hair_depth.png") for v in views]))
    return written


def load_union_case(case_dir: str, num_views: int, image_size) -> Dict[str, np.ndarray]:
    """Read the union .dat files back as float arrays in [0, 1]
    (BaseDataset.read_union_data): orient (V, H, W, 2), the others (V, H, W),
    and model_tsfm (4, 4) when the case has it."""
    H, W = image_size
    out = {}
    p = os.path.join(case_dir, "orient_union.dat")
    if os.path.exists(p):
        arr = np.fromfile(p, np.uint8).reshape(num_views, 2, H, W)
        out["orient"] = arr.transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    for key, fname in (("conf", "conf_union.dat"), ("mask", "mask_union.dat"),
                       ("depth", "depth_union.dat"),
                       ("hair_depth", "bust_hair_depth_union.dat")):
        p = os.path.join(case_dir, fname)
        if os.path.exists(p):
            out[key] = (np.fromfile(p, np.uint8).reshape(num_views, H, W)
                        .astype(np.float32) / 255.0)
    tsfm = os.path.join(case_dir, "model_tsfm.dat")
    if os.path.exists(tsfm):
        out["model_tsfm"] = np.fromfile(tsfm, np.float32).reshape(4, 4).T
    return out
