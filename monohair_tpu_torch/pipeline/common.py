"""Shared stage plumbing: config resolution, map/camera/bust loading
(port of monohair_tpu/pipeline/common.py)."""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, parse_arguments, save_options_file, set_options
from ..constants import BUST_TO_ORIGIN
from ..io.cameras_io import load_cam_params, subsample_views
from ..io.image_io import (load_depth_maps, load_masks,
                           load_orientation_and_confidence)
from ..io.mesh_io import load_obj
from ..pmvo.solver import PMVOMaps


def case_paths(args: Config, save_options: bool = False) -> Config:
    """The reference's path conventions (PMVO.py:767-800 config_parser):
    output_path = <root>/<case>/<output_root>/<name> (created), then data.root
    becomes <root>/<case>. With save_options, the resolved options are saved in
    the output directory first (this needs PyYAML)."""
    args["output_path"] = os.path.join(args.data.root, args.data.case,
                                       args.get("output_root", "output"),
                                       str(args.get("name", "run")))
    os.makedirs(args["output_path"], exist_ok=True)
    if save_options:
        save_options_file(args)
    args.data["root"] = os.path.join(args.data.root, args.data.case)
    return args


def resolve_config(argv: List[str], check: Optional[Callable[[Config], None]] = None
                   ) -> Config:
    """CLI -> resolved config (YAML + parents + strict dotted overrides).
    `check`, when given, sees the config before anything is written."""
    opt_cmd = parse_arguments(argv)
    # strict: a typo'd CLI key raises instead of being silently accepted
    # (the reference prompts interactively, options.py:86-93)
    args = set_options(opt_cmd, allow_new=False)
    if check is not None:
        check(args)
    return case_paths(args, save_options=True)


def split_device(argv: List[str], default: str = "cuda") -> Tuple[str, List[str]]:
    """A stage CLI's --device=<d> (the card unless it says otherwise) and the
    config arguments around it."""
    device, rest = default, []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def load_pmvo_maps(args: Config, device="cuda") -> Tuple[PMVOMaps, List[str]]:
    """Stack per-view depth/ori/conf/mask into a PMVOMaps on `device`
    (PMVO.py:823-834)."""
    root = args.data.root
    cam_path = os.path.join(root, args.image_camera_path)
    names, cams = load_cam_params(cam_path, device)
    names, cams = subsample_views(names, cams, os.path.join(root, "capture_images"))
    ori, conf = load_orientation_and_confidence(
        names, os.path.join(root, args.data.Ori2D_path),
        os.path.join(root, args.data.Conf_path))
    depth = load_depth_maps(names, os.path.join(root, args.data.depth_path))
    mask = load_masks(names, os.path.join(root, args.data.mask_path))
    maps = PMVOMaps(cams, *(torch.as_tensor(x, device=device)
                            for x in (depth, ori, conf, mask)))
    return maps, names


def load_bust_and_scalp(args: Config) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bust vertices and scalp vertices shifted to origin (PMVO.py:811-820).
    Returns (bust_vertices, scalp_vertices, bust_faces)."""
    root = args.data.root
    bust_v, bust_f = load_obj(os.path.join(root, args.data.bust_path))
    bust_v = bust_v + BUST_TO_ORIGIN
    scalp_v, _ = load_obj(os.path.join(root, "ours/scalp_tsfm.obj"))
    scalp_v = scalp_v + BUST_TO_ORIGIN
    return bust_v, scalp_v, bust_f
