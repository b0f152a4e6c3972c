"""Stage 4 — strand generation (port of monohair_tpu/pipeline/hair_grow_stage.py;
reference HairGrow.py main :876-976).

The trace, the scalp diffusion and the smoothing run on `device`; segment
connection and scalp attachment run on the host (numpy, scipy, C++), as in the
JAX package. The coordinate and dtype chain is the JAX stage's: float32 voxel
and world coordinates, float64 inside the connection passes, float32 in the
.hair files.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..constants import BUST_TO_ORIGIN, VOXEL_MIN, VOXEL_SIZE
from ..coords import voxel_to_world, world_to_voxel
from ..io.hair_io import load_hair, save_hair, strands_from_flat
from ..io.mat_io import load_occ_mat, load_ori_mat, save_occ_ori_mat
from ..io.mesh_io import load_obj, sample_mesh_surface
from ..pmvo.driver import exact_f32
from ..strands.connect import connect_all_segments, connect_to_scalp
from ..strands.scalp_diffusion import diffuse_scalp
from ..strands.smooth import smooth_strand_list
from ..strands.trace import generate_guide_and_segments

_FLIP = np.array([1, -1, -1], np.float32)


def _split_like(flat: np.ndarray, strands: List[np.ndarray]) -> List[np.ndarray]:
    return np.split(flat, np.cumsum([len(s) for s in strands])[:-1])


def voxel_strands_to_world(strands: List[np.ndarray]) -> List[np.ndarray]:
    """float32 voxel_to_world, then minus the float32 BUST_TO_ORIGIN."""
    if not strands:
        return []
    flat = np.concatenate(strands, 0)
    world = voxel_to_world(torch.from_numpy(np.asarray(flat))).numpy() - BUST_TO_ORIGIN
    return _split_like(world, strands)


def world_strands_to_voxel(strands: List[np.ndarray]) -> List[np.ndarray]:
    if not strands:
        return []
    flat = np.concatenate(strands, 0) + BUST_TO_ORIGIN
    return _split_like(world_to_voxel(torch.from_numpy(flat)).numpy(), strands)


def scalp_seeds(scalp_v: np.ndarray, scalp_f: np.ndarray, seed: int,
                num: int = 60000) -> Tuple[np.ndarray, np.ndarray]:
    """`num` scalp seeds in voxel space (HairGrow.py:880-900): points sampled
    on the scalp mesh (obj coordinates, shifted by BUST_TO_ORIGIN here) and
    their unit normals, both float32."""
    sp, sn = sample_mesh_surface(scalp_v, scalp_f, num, np.random.default_rng(seed))
    sp = sp + BUST_TO_ORIGIN
    sp_vox = world_to_voxel(torch.from_numpy(sp.astype(np.float32))).numpy()
    sn = sn / np.maximum(np.linalg.norm(sn, axis=-1, keepdims=True), 1e-12)
    return sp_vox, (sn * np.array([1, -1, -1])).astype(np.float32)


def run_hair_grow(args: Config, device="cuda") -> Dict[str, float]:
    """Scalp guides and free segments from refine/ (or full/) {Occ3D,Ori3D}.mat,
    connected and attached: writes scalp_segment.hair,
    scalp_segment_smooth.hair, num_root.npy, strands.hair and
    connected_strands.hair beside the grids, as the HairGenerate flags ask.

    Runs on `device` (the card unless the caller asks for "cpu"). Returns the
    wall seconds of each step.
    """
    exact_f32()
    t0 = time.monotonic()
    steps: Dict[str, float] = {}

    def step(name: str, t: float) -> float:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        now = time.monotonic()
        steps[name] = now - t
        print(f"[hair_grow] {name}: {steps[name]:.2f}s", flush=True)
        return now

    root = args.data.root
    save_path = os.path.join(args.output_path,
                             "full" if args.PMVO.infer_inner else "refine")
    want_diffusion = bool(args.get("scalp_diffusion"))
    have_diffusion = os.path.exists(os.path.join(save_path, "Occ3D_diffusion.mat"))
    suffix = "_diffusion" if (want_diffusion and have_diffusion) else ""
    occ = load_occ_mat(os.path.join(save_path, f"Occ3D{suffix}.mat"))
    ori_voxel = load_ori_mat(os.path.join(save_path, f"Ori3D{suffix}.mat")) * _FLIP

    scalp_v, scalp_f = load_obj(os.path.join(root, args.data.scalp_path))
    sp_vox, sn_vox = scalp_seeds(scalp_v, scalp_f, args.get("seed", 0) or 0)
    occ_d = torch.as_tensor(occ, device=device)
    ori_d = torch.as_tensor(ori_voxel, device=device)
    t = step("load", t0)

    if want_diffusion and not have_diffusion:
        # extend the field from the scalp through empty shells
        # (diffusion_scalp, PMVO_utils.py:467-593), persist like the reference
        # (HairGrow.py:859-871 reads the _diffusion suffix)
        ori_d, occ_d = diffuse_scalp(occ_d, ori_d, torch.from_numpy(sp_vox),
                                     torch.from_numpy(sn_vox))
        occ, ori_voxel = occ_d.cpu().numpy(), ori_d.cpu().numpy()
        save_occ_ori_mat(save_path, occ, ori_voxel * _FLIP, suffix="_diffusion")
        t = step("diffusion", t)

    hg = args.HairGenerate
    if hg.generate_segments:
        strands, num_root = generate_guide_and_segments(
            occ_d, ori_d, sp_vox, sn_vox, hg.grow_threshold)
        t = step("trace", t)
        world = voxel_strands_to_world(strands)
        save_hair(os.path.join(save_path, "scalp_segment.hair"), world)
        smooth = smooth_strand_list(world, 4.0, 2.0, device=device)
        save_hair(os.path.join(save_path, "scalp_segment_smooth.hair"), smooth)
        np.save(os.path.join(save_path, "num_root.npy"), np.array(num_root))
        t = step("smooth", t)
    else:
        num_root = int(np.load(os.path.join(save_path, "num_root.npy")))

    if hg.connect_segments:
        segments, points = load_hair(os.path.join(save_path, "scalp_segment.hair"))
        strands = strands_from_flat(segments, points)
        # free segments connect in bust-origin world frame (HairGrow.py:925-936)
        free = [s + BUST_TO_ORIGIN for s in strands[num_root:]]
        tc = time.monotonic()
        connected = connect_all_segments(
            free, occ, ori_voxel, hg.connect_threshold, hg.connect_dot_threshold,
            VOXEL_MIN, VOXEL_SIZE)
        tc = time.monotonic() - tc
        print(f"[hair_grow] connect_all_segments: {len(free)} free segments in {tc:.2f}s "
              f"({tc / max(len(free), 1) * 1e3:.3f} ms a segment), {len(connected)} out",
              flush=True)
        new_strands = list(strands[:num_root]) + [s - BUST_TO_ORIGIN for s in connected]
        new_strands = smooth_strand_list(new_strands, 4.0, 2.0, device=device)
        save_hair(os.path.join(save_path, "strands.hair"), new_strands)
        t = step("connect_segments", t)

    if hg.connect_scalp:
        segments, points = load_hair(os.path.join(save_path, "strands.hair"))
        strands = world_strands_to_voxel(strands_from_flat(segments, points))
        attached = connect_to_scalp(strands, num_root, occ, ori_voxel,
                                    out_ratio_threshold=hg.out_ratio)
        world = smooth_strand_list(voxel_strands_to_world(attached), 4.0, 2.0,
                                   device=device)
        save_hair(os.path.join(save_path, "connected_strands.hair"), world)
        step("connect_scalp", t)
    print(f"[hair_grow] done in {time.monotonic() - t0:.1f}s")
    return steps
