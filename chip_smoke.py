#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stages 1 (prepare_data, with and without the
coarse NeRF and the bust fit), 2 (PMVO), 3 (infer_inner) and 4 (HairGrow), the
MVS nets' training (train_mvs), the one-process pipeline (run_pipeline),
video in and out (the mp4v and H.264 codecs, the sharpest-frame extraction,
the NeRF fly-through) and the segmentation nets' training (train_hair_parser) on one
GPU and check them.

    python3 chip_smoke.py

Phases, each printing a line when it starts and when it ends:
  1. device   the card's name, count and power limit (exits non-zero without CUDA)
  2. build    nvcc of monohair_tpu_torch/csrc/patch_kernels.cu and g++ of the
              host C++ (jpeg.cpp, mp4v.cpp, h264.cpp, h264_writer.cpp,
              connect.cpp, marching.cpp), all
              started together; their seconds and the -Xptxas -v lines
  3. kernels  each CUDA kernel against its plain PyTorch version on the card at
              the full-width shapes of the stage (the gather on f32 and on
              bf16 maps, bitwise; the tap loop on random, tied and near-tie
              windows), with CUDA-event times
  4. stage    a synthetic case (128x128, 24 views, patch 3) written to a temp
              directory with the port's writers, then run_pmvo on cuda; the
              refine/{Occ3D,Ori3D}.mat grids are checked against the known wig;
              then run_hair_grow on cuda on those grids, whose five files are
              read back and refine/connected_strands.hair checked against the wig
  5. width    16 views at 1920x1080, patch 7, through filter_raw_points ->
              optimize_points -> refine_and_voxelize on cuda; the first chunk of
              pmvo_forward is held against the same call with the plain versions;
              the tap loop is held and timed on one chunk's captured inputs
  6. grow     HairGrow at full width: 8000 swirl strands voxelised into the
              256x256x192 grids, 60,000 scalp seeds; the trace and the smoothing
              timed on cuda, connect_to_scalp (host C++) on 100,000 strands; the
              first trace chunks and the smoothing held against the CPU
  7. stage 3  the four MVS maps of 16 views at 1280x720 rendered from phase 6's
              strands over a bust mesh (one view held against the CPU); the
              shipped occ/ori nets (trained/mvs/*.npz) on those maps, their
              features and heads held against the CPU; deep_mvs_eval on
              1,048,576 queries in batches of 32768 (queries/s, peak memory);
              then the PMVO, infer_inner and HairGrow CLIs on a 16-view
              synthwig case: render, MVS at the median margin of the case's
              queries, the fuse of the MVS-positive interior into full/ (its
              kernel launches counted), strands grown from full/; last the
              shipped nets at their shipped margin on a scene of their
              training family (256x256 renders), held against its labels
  8. stage 1  prepare_data's image half through its CLI on a capture case
              (32 frames at 1280x720, frame_interval 2, the shipped
              hair-parser weights): the frames kept against a float64
              sharpness, cam_params.json against the analytic ring, the depth
              maps against the head silhouette (IoU >= 0.95), hair_mask/
              against the hair labels (mean IoU >= 0.7), the nets and the
              Gabor bank on the card against the CPU on 2 frames, PMVO's
              loaders on the written maps; seconds per step, per-frame times,
              the host's PNG share and the peak memory
  9. NeRF     9a: a seeded full-width Fourier field on the card against the
              CPU (a training step's loss and gradients on given draws within
              1e-4, a 16384-ray render chunk, a 64^3 block of the density
              export) with the card's times; 9b: the prepare_data CLI with
              run_ngp on (fit_bust, process_bust and render_depth off: phase
              10 runs them on this case) on a fresh 32-frame 1280x720 capture
              case at the shipped budget (4000 steps of 4096 rays x 64
              samples, 16 views at 720x1280, a 256^3 export at iso 3.0):
              colmap/base.obj and ours/colmap_points.obj non-empty with equal
              vertex counts, the 16 fixed-view PNGs and imgs/NNN/origin.png,
              shell recall >= 0.8 against the r = 0.72 head sphere; printed:
              precision, final loss, PSNR of 2 training frames, seconds per
              part against bounds, peak memory
 10. bust fit 10a: FAN (2DFAN-4 at its published width, seeded random
              weights) on the 16 rig frames of a fresh phase-8 case, its
              heatmaps on the card against the CPU on 2 frames (1e-4 of the
              largest heat), ms a frame; the four annotation backends
              (MODNet matte, FAN landmarks, iris, BiSeNet parse) on a copy of
              the case and the formats they write. 10b: phase 9's case (the
              NeRF's mesh as its coarse mesh), a synthetic SMPL-X at the
              official sizes (10,475 vertices, 20,908 faces, 55 joints) whose
              template the known similarity carries onto the capture head,
              annotations written from truth; fit_losses and its gradients on
              the card against the CPU (terms 1e-4 relative, gradients 1e-3 of
              their norm), the steady step time and busy share; then the
              prepare_data CLI with fit_bust, process_bust and render_depth on
              (1000 iterations, fewer when they would pass FIT_BUDGET_S): the
              fitted head's similarity within 1 degree, 1% and 0.005 of the
              truth, the landmark vertices within 0.01 and 5x closer than at
              the start, model_tsfm[_semantic].dat at the root, Bust/ and
              ours/*_tsfm.obj non-empty, bust depth in every rig view;
              printed: model_tsfm.dat's own share of the rotation, seconds
              per step, ms a fit step, the loss curve, depth IoU of
              render_depth from the NeRF's mesh, peak memory
 11. train    the MVS nets' training at full width (OccAttn and OriAttn, 16
              views) on their training family (4 cases of 16 ring views
              rendered at 256x256, Occ3D/Ori3D from the wigs), batches of 4096
              points: 11a a training step and one Adam step on 1024 of them
              on the card against the CPU in float64 from the same state (loss 1e-4 relative,
              gradients 1e-3 of their norm, BatchNorm running stats 1e-4,
              parameters within 1e-6 on >= 98% of the elements); 11b the
              steady ms a step (CUDA events over 20), the busy share and top
              operations (torch.profiler on one step), peak memory; 11c the
              train_mvs CLI on the 4 cases (1000 steps, fewer when they would
              pass TRAIN_BUDGET_S), then --resume for one more evaluation:
              stats_occ.txt's 6 columns, the mean loss of the last 50 steps
              below the first 50's, occ.npz and load_net's net equal to the
              resumed run's final state, and its val F1 through deep_mvs_eval
              at least 0.7; steps/s
 12. pipeline the run_pipeline CLI on the card on a fresh 16-view synthwig
              case (phase 7d's, prepare_data's steps off) under 7d's gates
              and the synthwig strand checks on full/connected_strands.hair;
              metrics.jsonl holds stage/<name>/seconds for the four stages
 13. JPEG, bf16, mesh
              13a the JPEG codec on the host: ms a frame to encode and decode
              a 1920x1080 and a 1280x720 capture frame, quality-100 round
              trips within stated bounds, restart intervals decoding equal;
              13b PMVO.bf16_maps at phase 5's width: the line search with f32
              and with bf16 maps, median |cos| between them > 0.99, peak
              memory, points/s, the bf16 gather's launches; 13c the first two
              line-search chunks on the mesh (cuda:0, cuda:0) equal to the
              unsharded run bit for bit; 13d phase 8's scene with its frames
              written as .JPG (quality 95, the port's encoder) through
              run_pipeline (run_ngp and fit_bust off) to
              full/connected_strands.hair: best_ori/, conf/, Ori/ and
              render_depth/<view>.JPG written as JPEG, hair IoU >= 0.7, strands;
              printed: stage seconds, the PMVO candidates kept, the codec's
              share of process_imgs
 14. video    the mp4v codec (host C++) and the two functions that use it:
              14a ms a frame to encode (the port's writer: qscale 3, an I-VOP
              and 11 P-VOPs) and to decode 12 orbit frames of phase 8's scene
              at 1920x1080 and 1280x720, the round trip's PSNR (>= 30 dB),
              the file's P-VOPs and size; 14b a 30-frame 1920x1080 orbit
              video at 30 fps written by the port, one frame of every 5 sharp
              and the others box-blurred, through extract_sharpest_frames
              (interval 5) on the card: the kept frames are the sharp ones
              and each kept sharpness agrees with a float64 host Laplacian;
              seconds and frames/s; 14c render_camera_path_video at 720x1280
              on a seeded full-width Fourier field over a 3-pose path at 2
              frames a segment: the mp4 decodes to 4 frames of that size at
              >= 30 dB against the renders; seconds a frame; 14d H.264: the
              first 20 of 14b's frames, and 20 orbit frames at 1280x720
              likewise blurred, written as H.264 by the port's test-stream
              writer (CABAC, an I
              picture then a P picture, QP 24; 1080 rows coded as 1088 and
              cropped), decoded on the host: ms a frame to decode, the round
              trip's PSNR (>= 30 dB); extract_sharpest_frames on the card keeps
              the sharp frames; the 1080p file with a 90-degree display
              matrix (a portrait phone video) keeps them as 1080x1920
              portrait frames, cv2's rotation; frames/s of each; then 14b's
              frames as I/P/B (two B pictures between anchors, the middle
              one a reference, implicit weights, CABAC, QP 24, with the MP4
              composition offsets and edit list of FFmpeg's muxer): ms a
              frame to decode, PSNR (>= 30 dB), the extraction's frames/s
              and kept frames; 14e HEVC: the first 20 of 14b's frames
              written as HEVC I/P by the port's test-stream writer (CTB 64,
              QP 24, an I picture then P pictures; 1080 rows end in a
              partial CTB), decoded on the host: ms a frame to decode
              (and at 1280x720 on 10 of 14d's frames), the round trip's
              PSNR (>= 30 dB); extract_sharpest_frames on the card keeps the
              sharp frames, frames/s; then the same 20 frames as HEVC I/P/B
              in x265's default GOP shape and WPP (4 B pictures between
              anchors, a B pyramid, 3 references, open GOPs whose CRA
              pictures carry RASL pictures; a CRA every 12 frames instead
              of x265's 250; entropy_coding_sync on): the frame count, ms a
              frame to decode (at most 4x the I/P stream's), PSNR (>= 30
              dB), the extraction's frames/s and kept frames, rows synced
              under WPP; then the first 10 as I/P in 4x3 uniform tiles
              without loop filtering across their edges and slices of
              dependent slice segments (HEVC_TILES): likewise, and the
              tiles and dependent segments decoded; every entry point of
              both gives its substream's length; then the first 10 as Main
              10 (10-bit) I/P/B in the same shape (HEVC_MAIN10): ms a frame
              to decode beside the 8-bit I/P/B stream's, PSNR (>= 30 dB),
              the extraction's frames/s and kept frames, every picture at
              10 bits; then 5 frames from a numpy seed as an iPhone's HDR
              recording in the same shape (HEVC_HLG: Main 10, BT.2020
              matrix and primaries, HLG, the alternative transfer SEI,
              Dolby Vision 8.4's RPU units and dvvC box): the stream's and
              the decoded frames' SHA-256 against the recorded ones (the
              frames are cv2's, held on the CPU), the 3D LUT's against
              its own (this host's libm), ms a frame to decode beside the
              8-bit I/P/B stream's, the extraction's kept frame
 15. hair parser training
              15a BiSeNet (the hair parser) and MODNet (the matte) at width
              1.0, flax's initialisers from a seed: one training step of 2
              synthetic frames of 256x256 on the card against the CPU in
              float64 (in float64: loss within 1e-8 relative, gradients within
              1e-6 of their norm; in f32: loss within 1e-4, the gradients'
              error printed beside the CPU f32's),
              then at 512x512 and batch 4 the steady ms a step (CUDA events
              over 20), the busy share and top operations (torch.profiler on
              one step), peak memory; 15b the train_hair_parser CLI at width
              1.0 on 64+8 frames of 512x512, each net's steps cut to 5 s
              (PARSER_BUDGET_S / 2) at 15a's step time: the four files written,
              each net's mean loss over its last 25 steps below its first
              25's; printed: hair IoU and matte MAE through the runners (no
              gate at this cut), seconds of the frames and of each loop
 16. capture  the run_pipeline CLI on phases 9's and 10's case (32 frames at
              1280x720: the NeRF's mesh, the fitted bust and their depth
              maps), stage 1's steps off: PMVO over every candidate of the
              mesh, infer_inner with the shipped nets at their shipped margin,
              HairGrow from full/ through connect_all_segments; gated on both
              kernels launched, a non-empty finite full/connected_strands.hair
              and the share of PMVO's surface points on the true hair cap
              (synthetic.capture_cap_share_of_points, at least
              CAP_SHARE_GATE); printed: the candidates after each of PMVO's
              filters, each stage's seconds and peak device memory,
              connect_all_segments' free segments and ms a segment
Phase 3 also holds the tap loop at the shapes PR 7's kernel refused (S = 1 at
P = 225, the refine pass at patch 15; 1100 views), and times the gather's
library call (one advanced-index gather with its indices built beforehand).

Before the last line it prints one JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}, printed only when every phase passed.
Imports only the standard library, numpy, scipy, torch and monohair_tpu_torch.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from monohair_tpu_torch import HairGrow as grow_cli, PMVO as pmvo_cli
from monohair_tpu_torch import infer_inner as infer_cli
from monohair_tpu_torch import prepare_data as prepare_cli
from monohair_tpu_torch import run_pipeline as pipeline_cli
from monohair_tpu_torch import train_hair_parser as parser_cli
from monohair_tpu_torch import train_mvs as train_cli
from monohair_tpu_torch.bustfit import optimize as bust_optimize
from monohair_tpu_torch.bustfit import pipeline as bust_pipeline
from monohair_tpu_torch.bustfit.transforms import load_model_tsfm
from monohair_tpu_torch.camera import Cameras
from monohair_tpu_torch.config import Config
from monohair_tpu_torch.constants import BUST_TO_ORIGIN, VOXEL_MAX, VOXEL_MIN, VOXEL_SIZE
from monohair_tpu_torch.coords import nerf_to_ngp, voxel_to_world
from monohair_tpu_torch.io.cameras_io import load_cam_params, save_cam_params, subsample_views
from monohair_tpu_torch.io.hair_io import load_hair, strands_from_flat
from monohair_tpu_torch.io import h264_streams, hevc_streams
from monohair_tpu_torch.io import jpeg as jpeg_io
from monohair_tpu_torch.io import video as video_io
from monohair_tpu_torch.io.image_io import (imread_gray, load_depth_maps, load_masks,
                                            load_orientation_and_confidence, read_png,
                                            write_png)
from monohair_tpu_torch.io.mat_io import load_occ_mat, load_ori_mat, save_occ_ori_mat
from monohair_tpu_torch.io.voxels_io import load_voxels_dat
from monohair_tpu_torch.io.yaml_io import dump_yaml
from monohair_tpu_torch.models.pifu import OccAttn, OriAttn, mvs_projection, occ_decision
from monohair_tpu_torch.io.mesh_io import load_obj
from monohair_tpu_torch.mvs.eval import (colmap_guided_queries, deep_mvs_eval, eval_points,
                                        load_mvs_inputs, save_mvs_outputs)
from monohair_tpu_torch.mvs.train import create_state, loss_and_grads, train_step
from monohair_tpu_torch.nerf import marching as nerf_marching
from monohair_tpu_torch.nerf import pipeline as pipeline_ngp
from monohair_tpu_torch.nerf import train as nerf_train
from monohair_tpu_torch.nerf.fourier import FourierField
from monohair_tpu_torch.nerf.ngp import (as_background, camera_rays, grid_points, nerf_to_unit,
                                         render_rays)
from monohair_tpu_torch.nerf.pipeline import ngp_options
from monohair_tpu_torch.nerf.poses import _se3, load_base_cam, save_base_cam
from monohair_tpu_torch.nerf.train import NerfDataset, load_nerf_dataset, render_image
from monohair_tpu_torch.ops import _build
from monohair_tpu_torch.ops import patch_kernels as pk
from monohair_tpu_torch.ops.gabor import orientation_maps as gabor_maps
from monohair_tpu_torch.ops.voxelize import voxelize_directions
from monohair_tpu_torch.pipeline import hair_grow_stage, infer_inner_stage, pmvo_stage
from monohair_tpu_torch.pipeline.common import case_paths
from monohair_tpu_torch.pipeline.hair_grow_stage import (run_hair_grow, scalp_seeds,
                                                         voxel_strands_to_world)
from monohair_tpu_torch.pipeline.infer_inner_stage import load_net, occ_margin
from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
from monohair_tpu_torch.render import (render_data, render_view, strands_to_segments,
                                       upload_segments)
from monohair_tpu_torch.ops.resize import bgr_to_gray, laplacian_variance, resize_linear
from monohair_tpu_torch.utils.metrics import OccMetric, psnr
from monohair_tpu_torch.segment import frames as seg_frames
from monohair_tpu_torch.segment import train as seg_train
from monohair_tpu_torch.segment.annotations import AnnotationProcessor, default_backends
from monohair_tpu_torch.segment.bisenet import BiSeNet
from monohair_tpu_torch.segment.convert import save_flax_npz
from monohair_tpu_torch.segment.fan import FAN, decode_heatmaps
from monohair_tpu_torch.segment.modnet import MODNet
from monohair_tpu_torch.segment.runners import (IMAGENET_MEAN, IMAGENET_STD, LandmarkRunner,
                                                MattingRunner, ParsingRunner, face_box_from_mask)
from monohair_tpu_torch.segment.train import matte_loss, parser_loss
from monohair_tpu_torch.pmvo import solver
from monohair_tpu_torch.video import extract_sharpest_frames
from monohair_tpu_torch.pmvo.driver import (auto_chunk, exact_f32, filter_raw_points,
                                            optimize_points, refine_and_voxelize)
from monohair_tpu_torch.strands import connect as strand_connect
from monohair_tpu_torch.strands.smooth import smooth_strand_list
from monohair_tpu_torch.strands.trace import (generate_guide_and_segments, strands_to_list,
                                              trace_bidirectional, trace_from_scalp)
from monohair_tpu_torch.synthetic import (CAPTURE_HEAD_R_NERF, SMPLX_OFFICIAL,
                                          analytic_head_maps, cameras_numpy,
                                          capture_cap_share_of_points,
                                          curved_strand_batch, grow_bust_mesh, grow_field,
                                          grow_scalp_cap, hair_shell_points, head_camera_list,
                                          mvs_train_camera_list, mvs_train_head_mesh,
                                          mvs_train_occupancy, mvs_train_queries, mvs_train_wig,
                                          MVS_TRAIN_RENDER_SIZE, shell_points, swirl_direction,
                                          write_bust_fit_assets, write_capture_case,
                                          write_synthwig_case)

# Phase 5 point count: a quarter of big_wavy1's 2.1 M raw points.
FULL_WIDTH_POINTS = 524_288
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM data sheet

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"phase {self.name}: {status} in {time.perf_counter() - self.t:.2f}s")
        return False


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    line = smi_line()
    log(f"device: {name}, count {count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    print(line, flush=True)
    return {"platform": "gpu", "kind": name, "count": count}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

NATIVE_SOURCES = (pk.SOURCE, jpeg_io.SOURCE, video_io.SOURCE, video_io.H264_SOURCE,
                  video_io.HEVC_SOURCE, h264_streams.SOURCE, hevc_streams.SOURCE,
                  strand_connect.SOURCE, nerf_marching.SOURCE)


def phase_build() -> None:
    """nvcc of the CUDA kernels and g++ of the host C++ (the JPEG, mp4v,
    H.264 and HEVC codecs, the H.264 and HEVC test-stream writers, the scalp
    connection, marching tetrahedra), all started together."""
    from concurrent.futures import ThreadPoolExecutor
    t = time.perf_counter()
    with ThreadPoolExecutor(len(NATIVE_SOURCES)) as pool:
        list(pool.map(_build.build, NATIVE_SOURCES))
    pk._lib()
    jpeg_io._lib()
    video_io._lib()
    video_io._lib(video_io.H264_SOURCE)
    video_io._lib(video_io.HEVC_SOURCE)
    h264_streams._lib()
    hevc_streams._lib()
    log(f"built {len(NATIVE_SOURCES)} native sources in {time.perf_counter() - t:.2f}s (wall)")
    for source in NATIVE_SOURCES:
        info = _build.BUILD_INFO[source]
        log(f"{'nvcc' if source.endswith('.cu') else 'g++'} {source}: "
            f"{info['seconds']:.2f}s -> {info['path']}")
    for line in _build.BUILD_INFO[pk.SOURCE]["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas {line.strip()}", flush=True)


# the kernels the f32 paths launch; PMVO.bf16_maps's path (phase 13b)
# launches the bf16 gather in place of the f32 one
F32_PATH_KERNELS = ("patch_gather", "patch_min_loss")
BF16_PATH_KERNELS = ("patch_gather_bf16", "patch_min_loss")


def unlaunched(launches: dict, kernels) -> list:
    """The kernels of `kernels` that `launches` counts no launch of."""
    return [k for k in kernels if launches.get(k, 0) == 0]


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def gather_bound(padded: torch.Tensor, rc: torch.Tensor, patch: int):
    """(bound_ms, bound_by): unique map pixels the windows touch read once (in
    the map's dtype), centres read once, f32 windows written once, over the
    HBM rate."""
    V, Hp, Wp, C = padded.shape
    offs = torch.arange(patch, device=rc.device)
    rows = rc[..., 0:1].long() + offs.repeat_interleave(patch)
    cols = rc[..., 1:2].long() + offs.repeat(patch)
    flat = (torch.arange(V, device=rc.device)[:, None, None] * Hp + rows) * Wp + cols
    touched = int(torch.unique(flat).numel())
    out_bytes = rc.shape[0] * rc.shape[1] * patch * patch * C * 4
    nbytes = touched * C * padded.element_size() + rc.numel() * 4 + out_bytes
    return nbytes / H100_BYTES_PER_S * 1e3, "bytes"


def min_loss_bound(V: int, N: int, S: int, P: int):
    """(bound_ms, bound_by) of the tap loop: inputs read once, outputs written
    once; 9 f32 operations per (v, n, s, tap) (dot 3, |o||d| 1, max 1, abs 1,
    divide 1, 1-x 1, compare 1), 4 per (v, n, tap) for |o|, 7 per (v, n, s)
    for |d| and the three sums."""
    nbytes = 4 * (V * N * S * 2 + V * N * P * 2 + V * N * P + V * N + 3 * N * S)
    ops = 9 * V * N * S * P + 4 * V * N * P + 7 * V * N * S
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nudge_ulps(x: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """x with each element moved 1-3 ulps up or down."""
    steps = torch.randint(1, 4, x.shape, generator=g, device=x.device)
    toward = torch.where(torch.rand(x.shape, generator=g, device=x.device) > 0.5,
                         math.inf, -math.inf)
    for i in range(3):
        x = torch.where(steps > i, torch.nextafter(x, toward), x)
    return x


# the tap loop as pmvo_forward calls it and as the refine pass does
MIN_LOSS_SHAPES = [(16, 8192, 90, 49), (16, 65536, 1, 49)]
# shapes PR 7's kernel refused: the refine pass at patch 15, and 1100 views
LIFTED_LIMIT_SHAPES = [(16, 65536, 1, 225), (1100, 64, 90, 49), (1100, 256, 1, 49)]


def min_loss_inputs(g: torch.Generator, V: int, N: int, S: int, P: int,
                    near_ties: bool = True) -> tuple:
    """Random tap-loop arguments on g's device, with tied windows and, unless
    near_ties is False (the inputs the kernel table is timed on), near-tie
    windows."""
    dev = g.device
    prj = torch.randn((V, N, S, 2), generator=g, device=dev)
    ori = torch.randn((V, N, P, 2), generator=g, device=dev)
    conf = torch.rand((V, N, P), generator=g, device=dev)
    # tied taps: every 7th point repeats tap 0 across its window
    ori[:, ::7] = ori[:, ::7, :1]
    # near ties: the taps of the points 3 past those are tap 0 moved by
    # 1-3 ulps, so rounded quotients tie where the exact ones do not
    if near_ties:
        ori[:, 3::7, 1:] = nudge_ulps(ori[:, 3::7, :1].expand(-1, -1, P - 1, -1), g)
    vis = torch.where(torch.rand((V, N), generator=g, device=dev) > 0.3,
                      torch.rand((V, N), generator=g, device=dev), -1.0)
    vis[:, ::11] = -1.0                       # points seen by no view
    return prj, ori, conf, vis, 0.15


def check_min_loss(args, what: str) -> float:
    """The tap-loop kernel against its plain version on the same inputs:
    num and den within rtol 1e-5/atol 1e-6 (view sums in another order),
    counts exact. Returns the largest absolute error."""
    k = pk.patch_min_loss(*args)
    p = pk.patch_min_loss_plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("num", "den"), k, p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   msg=lambda m, name=name: f"patch_min_loss {name} ({what}): {m}")
        worst = max(worst, (a - b).abs().max().item())
    if not torch.equal(k[2], p[2]):
        raise AssertionError(f"patch_min_loss ({what}): positive counts differ")
    return worst


def phase_kernels(dev: torch.device) -> dict:
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    results = {}

    # patch_gather at the stage's full width: 16 views of 1920x1080, patch 7
    V, H, W, patch, N = 16, 1920, 1080, 7, 8192
    half = patch // 2
    padded = torch.randn((V, H + 2 * half, W + 2 * half, 8), generator=g, device=dev)
    rc = torch.stack([torch.randint(0, H, (V, N), generator=g, device=dev),
                      torch.randint(0, W, (V, N), generator=g, device=dev)], -1)
    rc[:, :4] = torch.tensor([[0, 0], [H - 1, W - 1], [0, W - 1], [H - 1, 0]],
                             device=dev)
    rc = rc.to(torch.int32).contiguous()
    out_k = pk.patch_gather(padded, rc, patch)
    out_p = pk.patch_gather_plain(padded, rc, patch)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        bad = (out_k != out_p).sum().item()
        raise AssertionError(f"patch_gather: {bad} elements differ from the plain version")
    ms = cuda_time_ms(lambda: pk.patch_gather(padded, rc, patch))
    plain_ms = cuda_time_ms(lambda: pk.patch_gather_plain(padded, rc, patch))
    # the library call: the plain version's last line, one advanced-index
    # gather, with its index tensors built beforehand
    offs = torch.arange(patch, device=dev)
    rows = rc[..., 0:1].long() + offs.repeat_interleave(patch)
    cols = rc[..., 1:2].long() + offs.repeat(patch)
    views = torch.arange(V, device=dev)[:, None, None]
    if not torch.equal(padded[views, rows, cols], out_k):
        raise AssertionError("patch_gather: the library gather differs from the kernel")
    library_ms = cuda_time_ms(lambda: padded[views, rows, cols])
    bound_ms, bound_by = gather_bound(padded, rc, patch)
    log(f"patch_gather V={V} N={N} p={patch}: bit-exact; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (padded[views, rows, cols]) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    results["patch_gather"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    del out_k, out_p
    # the bf16 gather (PMVO.bf16_maps) on the same windows of the same map in
    # bf16: f32 windows, equal to the plain version's gather-then-.float() bit
    # for bit (bf16 -> f32 is exact); the library call is that gather and cast
    padded = padded.to(torch.bfloat16)
    out_k = pk.patch_gather(padded, rc, patch)
    out_p = pk.patch_gather_plain(padded, rc, patch)
    torch.cuda.synchronize()
    if out_k.dtype != torch.float32 or not torch.equal(out_k.view(torch.int32),
                                                       out_p.view(torch.int32)):
        bad = (out_k.view(torch.int32) != out_p.view(torch.int32)).sum().item()
        raise AssertionError(f"patch_gather_bf16: {bad} elements differ from the plain version")
    if not torch.equal(padded[views, rows, cols].float(), out_k):
        raise AssertionError("patch_gather_bf16: the library gather differs from the kernel")
    ms = cuda_time_ms(lambda: pk.patch_gather(padded, rc, patch))
    plain_ms = cuda_time_ms(lambda: pk.patch_gather_plain(padded, rc, patch))
    library_ms = cuda_time_ms(lambda: padded[views, rows, cols].float())
    bound_ms, bound_by = gather_bound(padded, rc, patch)
    log(f"patch_gather_bf16 V={V} N={N} p={patch}: bit-exact; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (padded[views, rows, cols].float()) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    results["patch_gather_bf16"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by,
                                        library_ms=library_ms)
    del padded, out_k, out_p, rows, cols

    # checked on random, tied and near-tie windows; the table's time is the
    # forward's (S=90) on random and tied windows
    worst = 0.0
    for (V, N, S, P) in MIN_LOSS_SHAPES:
        args = min_loss_inputs(g, V, N, S, P)
        worst = max(worst, check_min_loss(args, f"S={S}"))
        near_ms = cuda_time_ms(lambda: pk.patch_min_loss(*args))
        log(f"patch_min_loss V={V} N={N} S={S} P={P} (random, tied, near-tie windows): "
            f"within rtol 1e-5/atol 1e-6, counts exact, max abs err {worst:.3g}; "
            f"kernel {near_ms:.4f} ms")
        del args
        if S == 90:
            args = min_loss_inputs(g, V, N, S, P, near_ties=False)
            worst = max(worst, check_min_loss(args, f"S={S}, no near ties"))
            ms = cuda_time_ms(lambda: pk.patch_min_loss(*args))
            plain_ms = cuda_time_ms(lambda: pk.patch_min_loss_plain(*args), iters=20)
            bound_ms, bound_by = min_loss_bound(V, N, S, P)
            log(f"patch_min_loss timed (random, tied windows): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            results["patch_min_loss"] = dict(ms=ms, plain_ms=plain_ms,
                                             bound_ms=bound_ms, bound_by=bound_by,
                                             library_ms=None)
            del args
    # the limits lifted in PR 8: the refine pass at patch 15 (S = 1, P = 225,
    # 57,664 bytes of windows a warp: more than the default 48 KB of shared
    # memory) and more than 1023 views (the counts' 10-bit packing)
    for (V, N, S, P) in LIFTED_LIMIT_SHAPES:
        args = min_loss_inputs(g, V, N, S, P)
        err = check_min_loss(args, f"V={V} S={S} P={P}")
        lim_ms = cuda_time_ms(lambda: pk.patch_min_loss(*args), iters=10)
        log(f"patch_min_loss V={V} N={N} S={S} P={P} (beyond PR 7's limits): within "
            f"rtol 1e-5/atol 1e-6, counts exact, max abs err {err:.3g}; kernel {lim_ms:.4f} ms")
        del args
    results["patch_min_loss"]["max_abs_err"] = worst
    log(f"shipped shapes against PR 7's run on this card model: tap loop "
        f"{results['patch_min_loss']['ms']:.4f} ms (PR 7: 0.5853 ms), gather "
        f"{results['patch_gather']['ms']:.4f} ms (PR 7: 0.1514 ms)")
    log(f"launch counts during the comparisons: {dict(pk.LAUNCHES)}")
    return results


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

WIG_DIRECTION = np.array([0.0, -1.0, 0.0])


HAIR_FILES = ("scalp_segment.hair", "scalp_segment_smooth.hair", "strands.hair",
              "connected_strands.hair")


def check_hair_outputs(refine: str) -> dict:
    """The five files of the HairGrow stage exist and read back;
    connected_strands.hair holds many strands along the wig's direction,
    exported in the bust frame (y near +1.64), as the verify notes check."""
    counts = {}
    for name in HAIR_FILES:
        segments, points = load_hair(os.path.join(refine, name))
        if len(segments) == 0 or not np.isfinite(points).all():
            raise AssertionError(f"{name}: {len(segments)} strands or non-finite points")
        counts[name] = len(segments)
    num_root = int(np.load(os.path.join(refine, "num_root.npy")))
    segments, points = load_hair(os.path.join(refine, "connected_strands.hair"))
    seg = np.concatenate([np.diff(s, axis=0) for s in strands_from_flat(segments, points)
                          if len(s) > 1])
    seg = seg / np.maximum(np.linalg.norm(seg, axis=-1, keepdims=True), 1e-12)
    med = float(np.median(np.abs(seg @ WIG_DIRECTION)))
    y_lo, y_med, y_hi = (float(v) for v in np.percentile(points[:, 1], [0, 50, 100]))
    log(f"synthwig HairGrow: strands per file {counts}, num_root {num_root}; "
        f"connected_strands: median |cos| of segments to (0,-1,0) {med:.6f}, "
        f"y from {y_lo:.4f} to {y_hi:.4f}, median {y_med:.4f}")
    if num_root <= 0 or counts["connected_strands.hair"] < 100:
        raise AssertionError(f"HairGrow: num_root {num_root}, strands {counts}")
    if med <= 0.95 or abs(y_med - 1.64) > 0.1 or y_lo < 1.4 or y_hi > 1.9:
        raise AssertionError(f"HairGrow strands off the wig: median |cos| {med}, "
                             f"y {y_lo}..{y_hi}")
    return dict(counts=counts, num_root=num_root, median_cos=med)


def phase_stage(device: str, num_views: int = 24) -> dict:
    """Write the synthwig case with the port's writers, run the stage CLIs'
    run_pmvo, then run_hair_grow, on it; check the written grids against the
    known wig direction, and the strands as check_hair_outputs does."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_case_") as tmp:
        cfg = case_paths(write_synthwig_case(tmp, num_views=num_views))
        log(f"synthwig case: {num_views} views of 128x128, patch "
            f"{cfg.PMVO.patch_size}, written to {cfg.data.root}")
        pk.reset_launch_counts()
        steps = run_pmvo(cfg, device=device)
        launches = dict(pk.LAUNCHES)
        refine = os.path.join(cfg.output_path, "refine")
        occ = load_occ_mat(os.path.join(refine, "Occ3D.mat"))
        ori = load_ori_mat(os.path.join(refine, "Ori3D.mat"))
        grow_steps = run_hair_grow(cfg, device=device)
        log(f"synthwig HairGrow steps {json.dumps({k: round(v, 4) for k, v in grow_steps.items()})}")
        hair = check_hair_outputs(refine)
    if occ.shape != (256, 256, 192) or ori.shape != (256, 256, 192, 3):
        raise AssertionError(f"grid shapes {occ.shape} {ori.shape}")
    if not (np.isfinite(occ).all() and np.isfinite(ori).all()):
        raise AssertionError("non-finite values in the written grids")
    occupied = occ > 0
    med = float(np.median(np.abs(ori[occupied] @ WIG_DIRECTION))) if occupied.any() else 0.0
    log(f"synthwig: {int(occupied.sum())} occupied voxels, median |cos| to (0,-1,0) "
        f"{med:.6f}, launches {launches}, steps {steps}")
    if occupied.sum() < 100 or med <= 0.95:
        raise AssertionError(f"synthwig grids wrong: {int(occupied.sum())} voxels, "
                             f"median |cos| {med}")
    if device != "cpu" and unlaunched(launches, F32_PATH_KERNELS):
        raise AssertionError(f"the stage did not launch every kernel: {launches}")
    return dict(occupied=int(occupied.sum()), median_cos=med, launches=launches,
                steps=steps, grow_steps=grow_steps, hair=hair)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions():
    """Route the solver through the plain PyTorch versions (a comparison on the
    card; the package itself has no such switch)."""
    saved = solver.patch_gather, solver.patch_min_loss_kernel
    solver.patch_gather = pk.patch_gather_plain
    solver.patch_min_loss_kernel = pk.patch_min_loss_plain
    try:
        yield
    finally:
        solver.patch_gather, solver.patch_min_loss_kernel = saved


@contextlib.contextmanager
def recorded_min_loss_calls():
    """Record the arguments of every tap-loop call the solver makes."""
    calls, saved = [], solver.patch_min_loss_kernel

    def record(*args):
        calls.append(args)
        return saved(*args)

    solver.patch_min_loss_kernel = record
    try:
        yield calls
    finally:
        solver.patch_min_loss_kernel = saved


PATCH, CONF_THR, VIS_THR, THRESHOLD = 7, 0.15, 1.0, 0.025   # bench.py's stage 2


def head_scene(dev: torch.device, n_points: int, H: int, W: int, views: int):
    """bench.py's stage-2 scene: (maps on dev, raw shell points)."""
    t = time.perf_counter()
    ndc, w2c = cameras_numpy(head_camera_list(views))
    maps = solver.PMVOMaps.from_numpy(ndc, w2c, *analytic_head_maps(ndc, w2c, H, W), dev)
    points = shell_points(np.random.default_rng(0), n_points)
    log(f"head scene: {views} views of {H}x{W}, {n_points} shell points, "
        f"chunk {auto_chunk(views)}; made in {time.perf_counter() - t:.2f}s")
    return maps, points


def chunk_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds of fn() between two device synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def phase_full_width(dev: torch.device, n_points: int = FULL_WIDTH_POINTS,
                     H: int = 1920, W: int = 1080, views: int = 16) -> dict:
    patch, conf_thr, vis_thr, threshold = PATCH, CONF_THR, VIS_THR, THRESHOLD
    maps, points = head_scene(dev, n_points, H, W, views)

    on_card = dev.type == "cuda"    # the CPU takes the plain versions (rehearsals)
    pk.reset_launch_counts()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    steps = {}
    t = time.perf_counter()
    surface, filt = filter_raw_points(maps, points, patch, conf_thr, vis_thr)
    steps["filter"] = time.perf_counter() - t
    t = time.perf_counter()
    pts, ori, loss, _ = optimize_points(maps, points[surface], patch, conf_thr)
    steps["optimize"] = time.perf_counter() - t
    t = time.perf_counter()
    occ, ori_grid = refine_and_voxelize(maps, pts, ori, loss, points[filt], patch,
                                        conf_thr, vis_thr, threshold)
    if on_card:
        torch.cuda.synchronize(dev)
    steps["refine"] = time.perf_counter() - t
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    total = sum(steps.values())
    n_surf = int(surface.sum())
    log(f"full width: {n_surf} surface + {int(filt.sum())} near-surface of {n_points}; "
        f"steps {json.dumps({k: round(v, 4) for k, v in steps.items()})}")
    log(f"full width: optimize {n_surf / steps['optimize']:.1f} points/s, "
        f"whole stage {n_points / total:.1f} raw points/s, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {launches}")
    if n_surf == 0 or not np.isfinite(ori).all() or not np.isfinite(loss).all():
        raise AssertionError("full width: no surface points or non-finite results")
    occupied = occ > 0
    if occupied.sum() == 0 or not np.isfinite(ori_grid).all():
        raise AssertionError("full width: empty or non-finite grids")
    swirl = float(np.median(np.abs(np.sum(ori * swirl_direction(pts), -1))))
    log(f"full width: {int(occupied.sum())} occupied voxels; median |cos| of the "
        f"optimized directions to the scene's swirl field {swirl:.4f}")
    if swirl < 0.8:
        raise AssertionError(f"full width: directions do not follow the scene ({swirl})")
    if on_card and unlaunched(launches, F32_PATH_KERNELS):
        raise AssertionError(f"the full-width path did not launch every kernel: {launches}")

    # the first 2048 surface points through pmvo_forward, kernels vs plain
    first = torch.as_tensor(pts[:2048], device=dev)
    k_out = solver.pmvo_forward(maps, first, patch, conf_thr)
    with plain_versions():
        p_out = solver.pmvo_forward(maps, first, patch, conf_thr)
    cos = torch.abs(torch.sum(k_out[1] * p_out[1], -1))
    agree = cos > 0.999
    share = agree.float().mean().item()
    loss_err = (k_out[2] - p_out[2]).abs()[agree].max().item() if agree.any() else math.inf
    log(f"full width: pmvo_forward kernels vs plain on {first.shape[0]} points: "
        f"{share * 100:.3f}% with |cos| > 0.999, max |min_loss diff| {loss_err:.3g} there")
    if share < 0.99 or loss_err > 1e-5:
        raise AssertionError("full width: kernels and plain versions disagree")
    result = dict(steps=steps, launches=launches, peak_bytes=peak, surface=n_surf)
    if on_card:
        # one line-search chunk end to end, kernels and plain versions in turns
        chunk = torch.as_tensor(pts[:auto_chunk(views)], device=dev)

        def forward():
            solver.pmvo_forward(maps, chunk, patch, conf_thr)

        def forward_plain():
            with plain_versions():
                forward()

        forward(), forward_plain()
        k1, p1, p2, k2 = (chunk_ms(f) for f in (forward, forward_plain, forward_plain,
                                                 forward))
        log(f"full width: pmvo_forward on {chunk.shape[0]} points: kernels "
            f"{k1:.3f} / {k2:.3f} ms, plain versions {p1:.3f} / {p2:.3f} ms "
            f"(host clock between synchronisations, 3 calls each)")

        # the tap loop on the scene's own inputs: the kernel's work depends on
        # the data (taps skipped, exact paths taken), so time it there too
        with recorded_min_loss_calls() as calls:
            forward()
        err = max(check_min_loss(args, "head scene") for args in calls)
        scene_ms = cuda_time_ms(lambda: [pk.patch_min_loss(*args) for args in calls],
                                iters=10) / len(calls)
        shape = tuple(calls[0][0].shape[:3]) + (calls[0][1].shape[2],)
        log(f"full width: patch_min_loss on the {len(calls)} calls of one "
            f"{chunk.shape[0]}-point chunk (V, N, S, P = {shape}): within rtol 1e-5/"
            f"atol 1e-6, counts exact, max abs err {err:.3g}; kernel {scene_ms:.4f} ms "
            f"per call")
        result["scene_ms"] = scene_ms
    return result


def device_profile(fn, what: str, top: int = 15) -> float:
    """Run fn() once under torch.profiler: log its wall time, the device's busy
    time and share, and the `top` device operations by time. Returns the busy
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    log(f"profile of {what}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"over {sum(e.count for e in events)} device operations, busy share "
        f"{busy / wall_us:.4f}, idle share {1 - busy / wall_us:.4f}")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms {e.count:6d} calls  {e.key[:90]}", flush=True)
    return busy / wall_us


def profile_line_search(dev: torch.device, chunks: int = 4) -> None:
    """Trace `chunks` full-width line-search chunks: device time by kernel and
    the device's idle share of the wall time."""
    maps, points = head_scene(dev, FULL_WIDTH_POINTS // 4, 1920, 1080, 16)
    surface, _ = filter_raw_points(maps, points, PATCH, CONF_THR, VIS_THR)
    n = auto_chunk(16)
    pts = points[surface][:chunks * n]
    optimize_points(maps, pts[:n], PATCH, CONF_THR)          # warm-up
    device_profile(lambda: optimize_points(maps, pts, PATCH, CONF_THR),
                   f"{len(pts)} line-search points in {chunks} chunks")


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

GROW_THRESHOLD = 0.8            # bench.py's stage-4 trace threshold (base.yaml's grow_threshold)
TRACE_CHUNK = 16384             # the JAX package's chunk, part of the result


def compare_strands(a, b, atol: float = 1e-4):
    """(equal counts, share of strands with equal length and points within atol)."""
    if len(a) != len(b):
        return False, 0.0
    ok = [x.shape == y.shape and np.allclose(x, y, rtol=0, atol=atol) for x, y in zip(a, b)]
    return True, float(np.mean(ok)) if ok else 1.0


def trace_device_share(occ_d, ori_d, seeds, noise) -> float:
    """The device's busy share of one trace chunk's wall time (torch.profiler)."""
    return device_profile(
        lambda: strands_to_list(trace_bidirectional(occ_d, ori_d, seeds, noise,
                                                    GROW_THRESHOLD), 5),
        f"one {len(seeds)}-seed trace chunk", top=0)


def phase_grow_full_width(dev: torch.device) -> dict:
    """HairGrow's device and host steps at the full 256x256x192 output grid."""
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    occ, ori = grow_field(rng)
    cap_v, cap_f = grow_scalp_cap()
    sp, sn = scalp_seeds(cap_v, cap_f, 0)
    log(f"grow field: {occ.shape}, {int(occ.sum())} occupied voxels, {len(sp)} scalp "
        f"seeds; made in {time.perf_counter() - t:.2f}s")
    occ_d = torch.as_tensor(occ, device=dev)
    ori_d = torch.as_tensor(ori, device=dev)
    steps = {}

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    strands, num_root = generate_guide_and_segments(occ_d, ori_d, sp, sn, GROW_THRESHOLD,
                                                    chunk=TRACE_CHUNK)
    torch.cuda.synchronize(dev)
    steps["trace"] = time.perf_counter() - t
    world = voxel_strands_to_world(strands)
    t = time.perf_counter()
    smooth = smooth_strand_list(world, 4.0, 2.0, device=dev)
    torch.cuda.synchronize(dev)
    steps["smooth"] = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    points = sum(len(s) for s in strands)
    log(f"grow: {len(strands)} strands ({num_root} scalp-rooted, {points} points); "
        f"trace {steps['trace']:.4f} s ({len(strands) / steps['trace']:.1f} strands/s), "
        f"smooth {steps['smooth']:.4f} s, peak device memory {peak / 2**30:.3f} GiB")
    if num_root == 0 or len(strands) <= num_root:
        raise AssertionError(f"grow: {num_root} guides of {len(strands)} strands")
    if not all(np.isfinite(s).all() for s in smooth):
        raise AssertionError("grow: non-finite smoothed strands")

    # connect_to_scalp (host C++) on bench.py's 100,000 curved strands, 1/5 rooted
    arcs = curved_strand_batch(rng, 100_000, 25, occ.shape)
    t = time.perf_counter()
    attached = strand_connect.connect_to_scalp(list(arcs), 20_000, occ, ori)
    steps["connect_to_scalp"] = time.perf_counter() - t
    info = _build.BUILD_INFO[strand_connect.SOURCE]
    log(f"grow: connect_to_scalp on 100000 strands: {len(attached)} attached in "
        f"{steps['connect_to_scalp']:.4f} s ({os.cpu_count()} host cores; g++ build "
        f"{info['seconds']:.2f} s)")
    if len(attached) <= 20_000:
        raise AssertionError(f"grow: connect_to_scalp attached {len(attached)}")

    # connect_all_segments (host Python) on the first 2000 free segments, to
    # project the whole stage's time at this width
    free = [s + BUST_TO_ORIGIN for s in world[num_root:num_root + 2000]]
    t = time.perf_counter()
    strand_connect.connect_all_segments(free, occ, ori, 0.005, 0.7, VOXEL_MIN, VOXEL_SIZE)
    per_segment = (time.perf_counter() - t) / max(len(free), 1)
    log(f"grow: connect_all_segments {per_segment * 1e3:.3f} ms a segment on "
        f"{len(free)} segments; {len(world) - num_root} free segments would take "
        f"~{per_segment * (len(world) - num_root):.1f} s")

    # the card against the CPU on the first chunks, same seeds and noise
    seeds = torch.nonzero(occ_d > 0)[:TRACE_CHUNK]
    noise = torch.from_numpy(np.random.default_rng(0).random((len(seeds), 3)).astype(np.float32))
    occ_c, ori_c = torch.from_numpy(occ), torch.from_numpy(ori)
    t = time.perf_counter()
    card = strands_to_list(trace_bidirectional(occ_d, ori_d, seeds, noise, GROW_THRESHOLD), 5)
    chunk_s = time.perf_counter() - t
    host = strands_to_list(trace_bidirectional(occ_c, ori_c, seeds.cpu(), noise,
                                               GROW_THRESHOLD), 5)
    count_ok, share = compare_strands(card, host)
    g_card = strands_to_list(trace_from_scalp(occ_d, ori_d, torch.from_numpy(sp[:TRACE_CHUNK]),
                                              torch.from_numpy(sn[:TRACE_CHUNK]),
                                              GROW_THRESHOLD), 2)
    g_host = strands_to_list(trace_from_scalp(occ_c, ori_c, torch.from_numpy(sp[:TRACE_CHUNK]),
                                              torch.from_numpy(sn[:TRACE_CHUNK]),
                                              GROW_THRESHOLD), 2)
    g_ok, g_share = compare_strands(g_card, g_host)
    sm_card = smooth_strand_list(world[:2000], 4.0, 2.0, device=dev)
    sm_host = smooth_strand_list(world[:2000], 4.0, 2.0, device="cpu")
    sm_err = max(float(np.abs(a - b).max()) for a, b in zip(sm_card, sm_host))
    log(f"grow: card vs CPU, first {len(seeds)}-seed chunk: {len(card)} / {len(host)} strands, "
        f"{share * 100:.3f}% equal within 1e-4 voxels ({chunk_s:.4f} s on the card); "
        f"first {min(TRACE_CHUNK, len(sp))} scalp seeds: {len(g_card)} / {len(g_host)} guides, "
        f"{g_share * 100:.3f}% equal; smoothing of 2000 strands max abs diff {sm_err:.3g}")
    if not (count_ok and share >= 0.99 and g_ok and g_share >= 0.99) or sm_err > 1e-5:
        raise AssertionError("grow: the card and the CPU disagree")

    busy = trace_device_share(occ_d, ori_d, seeds, noise)
    return dict(steps=steps, strands=len(strands), num_root=num_root, peak_bytes=peak,
                busy_share=busy, voxel_strands=strands)


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

RENDER_SIZE = (1280, 720)          # base.yaml's infer_inner.render_size, (H, W)
MVS_VIEWS = 16                     # the shipped nets' position table holds 16 views
MVS_QUERIES = 1_048_576
MVS_BATCH = 32768                  # base.yaml's mvs.eval_batch
EVAL_VSIZE = 0.005                 # base.yaml's mvs.eval_vsize
NET_CHECK_QUERIES = 4096
TRAIN_SCENE_QUERIES = 524_288
TRAINED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trained", "mvs")
MVS_WEIGHTS = {kind: os.path.join(TRAINED, kind + ".npz") for kind in ("occ", "ori")}
# the stage's own weight and margin lookups read the shipped nets from this
MVS_CFG = Config({"mvs": {f"{kind}_model_path": path for kind, path in MVS_WEIGHTS.items()}})


def max_err(card: torch.Tensor, host: torch.Tensor, what: str, rtol: float, atol: float) -> float:
    """The largest absolute difference of a card result from the CPU's; fails
    outside rtol/atol."""
    card = card.detach().cpu()
    torch.testing.assert_close(card, host, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}, card vs CPU: {m}")
    return (card - host).abs().max().item()


def phase_render(dev: torch.device, voxel_strands, case_dir: str) -> dict:
    """The four MVS maps of 16 views at 1280x720 from phase 6's strands over a
    bust mesh, written as the stage writes them; one view of a quarter of the
    strands held against the CPU."""
    strands = [voxel_to_world(torch.from_numpy(s)).numpy() for s in voxel_strands]
    bust_v, bust_f = grow_bust_mesh()
    cam_list = head_camera_list(MVS_VIEWS)
    ndc, w2c = cameras_numpy(cam_list)
    names = [c["file"] for c in cam_list]
    save_cam_params(os.path.join(case_dir, "cam_params.json"), names, ndc, np.linalg.inv(w2c))
    cams = Cameras.from_json_list(cam_list, dev)
    seg = upload_segments(strands_to_segments(strands), dev)
    log(f"render: {len(strands)} strands, {len(seg[0])} segments, bust {len(bust_f)} faces, "
        f"{MVS_VIEWS} views of {RENDER_SIZE[0]}x{RENDER_SIZE[1]}")

    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    render_view(cams[0], seg, bust_v, bust_f, RENDER_SIZE)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    imgs = render_data(cams, names, strands, bust_v, bust_f, RENDER_SIZE,
                       os.path.join(case_dir, "imgs"))
    total_s = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(2):
        render_view(cams[1], seg, bust_v, bust_f, RENDER_SIZE)
    torch.cuda.synchronize(dev)
    view_s = (time.perf_counter() - t) / 2
    peak = torch.cuda.max_memory_allocated(dev)
    hair = float(np.mean([imgs[n]["mask"].mean() for n in names]))
    bust = float(np.mean([(imgs[n]["bust_depth"] < 1).mean() for n in names]))
    log(f"render: {total_s:.3f} s for {MVS_VIEWS} views with their PNGs; one view on the card "
        f"{view_s:.4f} s ({first_s:.3f} s for the first, with warm-up); hair covers "
        f"{hair:.4f} and the bust {bust:.4f} of the pixels; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    if not 0.01 < hair < 0.9 or bust <= 0:
        raise AssertionError(f"render: hair {hair}, bust {bust}")

    # one view on the card and on the CPU, every 4th strand (a full view on
    # the CPU would take minutes)
    sub = strands_to_segments(strands[::4])
    card = render_view(cams[2], upload_segments(sub, dev), bust_v, bust_f, RENDER_SIZE)
    host = render_view(Cameras(cams.ndc[2:3].cpu(), cams.w2c[2:3].cpu()),
                       upload_segments(sub, "cpu"), bust_v, bust_f, RENDER_SIZE)
    cov_c, cov_h = card["mask"].cpu() > 0, host["mask"] > 0
    same_cov = (cov_c == cov_h).float().mean().item()
    both = cov_c & cov_h
    d_err = (card["hair_depth"].cpu() - host["hair_depth"]).abs()[both]
    c_err = (card["undirectional_map"].cpu() - host["undirectional_map"]).abs().amax(-1)[both]
    bust_err = (card["bust_depth"].cpu() - host["bust_depth"]).abs()
    depth_ok = (d_err <= 1e-5).float().mean().item()
    color_ok = (c_err <= 1e-3).float().mean().item()
    bust_ok = (bust_err <= 1e-5).float().mean().item()
    log(f"render, card vs CPU (view 2, {len(sub[0])} segments): hair coverage equal on "
        f"{same_cov * 100:.4f}% of pixels; hair depth within 1e-5 on {depth_ok * 100:.4f}% "
        f"and colour within 1e-3 on {color_ok * 100:.4f}% of the pixels both cover; bust "
        f"depth within 1e-5 on {bust_ok * 100:.4f}% (largest {bust_err.max().item():.3g})")
    if min(same_cov, depth_ok, color_ok, bust_ok) < 0.999:
        raise AssertionError("render: the card and the CPU disagree")
    return dict(seconds=total_s, view_seconds=view_s, segments=len(seg[0]), peak_bytes=peak,
                hair=hair)


@torch.no_grad()
def phase_nets(dev: torch.device, inputs, queries: np.ndarray, margin: float) -> dict:
    """The trained nets on the card against the same nets on the CPU: UNet
    features of one view, and both heads on NET_CHECK_QUERIES queries (from
    the card's 16-view features)."""
    pts = torch.from_numpy(queries[:NET_CHECK_QUERIES])
    host_coord, host_cam = mvs_projection(inputs.w2c.cpu(), inputs.ndc.cpu(), pts)
    coord, cam = mvs_projection(inputs.w2c, inputs.ndc, pts.to(dev))
    out, host_out, feat_s, errs = {}, {}, {}, {}
    for kind in ("occ", "ori"):
        net, host_net = load_net(MVS_CFG, kind, MVS_VIEWS, dev), load_net(MVS_CFG, kind, MVS_VIEWS, "cpu")
        net.get_feat(inputs.imgs[:1])                      # warm-up (cuDNN's choice)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        feats = net.get_feat(inputs.imgs)
        torch.cuda.synchronize(dev)
        feat_s[kind] = time.perf_counter() - t
        host_feats0 = host_net.get_feat(inputs.imgs[:1].cpu())
        errs[f"{kind} features"] = max(max_err(f[:1], h, f"{kind} features of view 0", 1e-3, 1e-4)
                                       for f, h in zip(feats, host_feats0))
        out[kind] = net.forward_with_feat(feats, pts.to(dev), cam, coord)
        host_out[kind] = host_net.forward_with_feat([f.cpu() for f in feats], pts, host_cam,
                                                    host_coord)
        errs[f"{kind} head"] = max_err(out[kind], host_out[kind], f"{kind} head", 1e-3, 1e-4)
        del feats, net
    # the shipped margin, and the median of the CPU's logit differences, at
    # which half the queries are occupied and the decision is tested hardest
    median = float(torch.median(host_out["occ"][:, 1] - host_out["occ"][:, 0]))
    shares = {}
    for name, m in (("shipped", margin), ("median", median)):
        host = occ_decision(host_out["occ"], m)
        agree = (occ_decision(out["occ"], m).cpu() == host).float().mean().item()
        shares[name] = (agree, host.float().mean().item())
        if agree < 0.999:
            raise AssertionError(f"nets: occupancy at the {name} margin {m} differs on "
                                 f"{(1 - agree) * 100:.3f}% of the queries")
    log(f"nets: features of 16 views in {feat_s['occ']:.4f} s (occ) / {feat_s['ori']:.4f} s "
        f"(ori); card vs CPU max abs err {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
        f"occupancy equal on {shares['shipped'][0] * 100:.3f}% of {NET_CHECK_QUERIES} queries "
        f"at the shipped margin {margin:.6f} ({shares['shipped'][1] * 100:.2f}% occupied) and on "
        f"{shares['median'][0] * 100:.3f}% at the median margin {median:.6f}")
    return dict(feature_seconds=feat_s, max_abs_err=errs, median_margin=median,
                host_occ=occ_decision(host_out["occ"], median).numpy(),
                host_ori=host_out["ori"].numpy())


def phase_mvs(dev: torch.device, inputs, queries: np.ndarray, margin: float, nets: dict,
              case_dir: str) -> dict:
    """deep_mvs_eval on MVS_QUERIES queries in batches of MVS_BATCH: queries/s
    and peak memory; the first NET_CHECK_QUERIES results against the CPU's.
    The margin is phase_nets' median one: the shipped nets were trained on
    256x256 renders of smaller heads, and at their shipped margin this scene
    is all but empty, which would leave the occupancy comparison idle."""
    occ_net, ori_net = load_net(MVS_CFG, "occ", MVS_VIEWS, dev), load_net(MVS_CFG, "ori", MVS_VIEWS, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    pts, orients, occ = deep_mvs_eval(inputs, occ_net, ori_net, query_points=queries,
                                      batch=MVS_BATCH, occ_margin=margin)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    feats = sum(nets["feature_seconds"].values())
    log(f"mvs: {len(queries)} queries in batches of {MVS_BATCH} at margin {margin:.6f}: "
        f"{seconds:.3f} s "
        f"({len(queries) / seconds:.1f} queries/s; {len(queries) / (seconds - feats):.1f} "
        f"queries/s without the {feats:.3f} s of features), peak device memory "
        f"{peak / 2**30:.3f} GiB, {occ.mean() * 100:.2f}% occupied")
    n = NET_CHECK_QUERIES
    agree = float((occ[:n] == nets["host_occ"]).mean())
    host = nets["host_ori"] / np.linalg.norm(nets["host_ori"], axis=-1, keepdims=True)
    cos = np.abs(np.sum(orients[:n] * host, -1))
    log(f"mvs, card vs CPU on the first {n} queries of the first batch: occupancy equal on "
        f"{agree * 100:.3f}%, |cos| of the orientations min {cos.min():.7f}, median "
        f"{np.median(cos):.7f}")
    if agree < 0.999 or cos.min() < 0.9999 or not np.isfinite(orients).all():
        raise AssertionError("mvs: the card and the CPU disagree")
    t = time.perf_counter()
    save_mvs_outputs(os.path.join(case_dir, "ours"), inputs.model_tsfm, pts, orients, occ,
                     0.005, VOXEL_MIN, VOXEL_MAX)
    log(f"mvs: voxels.dat, raw.npy and Voxel_hair/*.mat written in {time.perf_counter() - t:.3f} s")
    return dict(seconds=seconds, queries_per_s=len(queries) / seconds, peak_bytes=peak,
                occupied=float(occ.mean()), agree=agree)


def precision_recall(pred: np.ndarray, truth: np.ndarray) -> tuple:
    """(precision, recall, F1) of boolean predictions against labels."""
    metric = OccMetric()
    metric.update(pred, truth)
    p, r = metric.precision(), metric.recall()
    return p, r, 2 * p * r / max(p + r, 1e-12)


def phase_training_scene(dev: torch.device, margin: float, case_dir: str) -> dict:
    """The shipped nets on a scene of their own training family
    (tools/make_mvs_cases.py: a 2000-strand wig on a 0.095-radius head, 16
    ring views at NDC focal 2.6 rendered at 256x256): at the shipped margin,
    the occupancy of TRAIN_SCENE_QUERIES queries drawn as the margin was tuned
    (tools/tune_occ_threshold.py) against the scene's label grid, and the
    first NET_CHECK_QUERIES of them against the CPU."""
    rng = np.random.default_rng(0)
    strands = mvs_train_wig(rng)
    head_v, head_f = mvs_train_head_mesh()
    cam_list = mvs_train_camera_list(MVS_VIEWS)
    ndc, w2c = cameras_numpy(cam_list)
    names = [c["file"] for c in cam_list]
    cam_path = os.path.join(case_dir, "cam_params.json")
    save_cam_params(cam_path, names, ndc, np.linalg.inv(w2c))
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    render_data(Cameras.from_json_list(cam_list, dev), names, strands, head_v, head_f,
                MVS_TRAIN_RENDER_SIZE, os.path.join(case_dir, "imgs"))
    render_s = time.perf_counter() - t
    labels_grid = mvs_train_occupancy(strands)
    queries, labels = mvs_train_queries(labels_grid, rng)
    pick = rng.permutation(len(queries))[:TRAIN_SCENE_QUERIES]
    queries, truth = queries[pick], labels[pick] > 0
    inputs, _ = load_mvs_inputs(case_dir, cam_path, device=dev)
    occ_net, ori_net = load_net(MVS_CFG, "occ", MVS_VIEWS, dev), load_net(MVS_CFG, "ori",
                                                                          MVS_VIEWS, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    _, orients, occ = deep_mvs_eval(inputs, occ_net, ori_net, query_points=queries,
                                    batch=MVS_BATCH, occ_margin=margin)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    p, r, f1 = precision_recall(occ > 0.5, truth)
    log(f"training scene: {len(strands)} strands, {int(labels_grid.sum())} labelled voxels, "
        f"{MVS_VIEWS} views of {MVS_TRAIN_RENDER_SIZE[0]}x{MVS_TRAIN_RENDER_SIZE[1]} rendered "
        f"in {render_s:.3f} s; {len(queries)} of {len(labels)} queries ({truth.mean() * 100:.2f}% "
        f"labelled occupied) in {seconds:.3f} s ({len(queries) / seconds:.1f} queries/s), peak "
        f"device memory {peak / 2**30:.3f} GiB; at the shipped margin {margin:.6f}: "
        f"{occ.mean() * 100:.2f}% occupied, precision {p:.4f}, recall {r:.4f}, F1 {f1:.4f}")
    n = NET_CHECK_QUERIES
    host_inputs, _ = load_mvs_inputs(case_dir, cam_path, device="cpu")
    _, host_ori, host_occ = deep_mvs_eval(
        host_inputs, load_net(MVS_CFG, "occ", MVS_VIEWS, "cpu"),
        load_net(MVS_CFG, "ori", MVS_VIEWS, "cpu"), query_points=queries[:n], batch=n,
        occ_margin=margin)
    agree = float((occ[:n] == host_occ).mean())
    cos = np.abs(np.sum(orients[:n] * host_ori, -1))
    log(f"training scene, card vs CPU on the first {n} queries: occupancy equal on "
        f"{agree * 100:.3f}%, |cos| of the orientations min {cos.min():.7f}")
    if agree < 0.999 or cos.min() < 0.9999 or not np.isfinite(orients).all():
        raise AssertionError("training scene: the card and the CPU disagree")
    if not 0.05 < occ.mean() < 0.95 or min(p, r) < 0.6 or f1 < 0.7:
        raise AssertionError(f"training scene: the shipped nets at the shipped margin give "
                             f"{occ.mean() * 100:.2f}% occupied, precision {p:.4f}, recall "
                             f"{r:.4f}, F1 {f1:.4f}")
    return dict(render_seconds=render_s, seconds=seconds, queries_per_s=len(queries) / seconds,
                peak_bytes=peak, occupied=float(occ.mean()), precision=p, recall=r, f1=f1,
                agree=agree)


def median_occ_margin(cfg: Config, case: str, device, sample: int = MVS_BATCH) -> float:
    """The median occ logit difference of the stage's colmap-guided queries
    on the case's rendered maps (every k-th query, `sample` of them): the
    margin at which half the queries are occupied."""
    inputs, _ = load_mvs_inputs(case, cfg.camera_path, device=device)
    net = load_net(cfg, "occ", inputs.imgs.shape[0], device)
    pts = colmap_guided_queries(os.path.join(case, "ours", "colmap_points.obj"),
                                vsize=cfg.mvs.eval_vsize)
    pts = torch.as_tensor(pts[::max(len(pts) // sample, 1)][:sample], device=device)
    coord, cam = mvs_projection(inputs.w2c, inputs.ndc, pts)
    with torch.no_grad():
        logits = net(inputs.imgs, pts, cam, coord)
    return float(torch.median(logits[:, 1] - logits[:, 0]))


def phase_infer_inner(case_root: str, device: str, render_size, eval_vsize: float) -> dict:
    """The CLIs on a 16-view synthwig case with PMVO.infer_inner on and the
    trained nets: PMVO, then stage 3 (render, MVS, fuse into full/), then
    HairGrow on full/. Returns the stage's steps and the fuse's launches.

    The trained nets call every query of this scene empty at the shipped
    margin (it is not their training scene, see phase 7e), and the case's
    flat depth maps (capture depth 1.80) put every query in front of every
    camera, so the fuse would ingest nothing. So the MVS step runs at the
    median margin of this case's own queries, and the depth maps move to
    camera depth 1.08, behind which the wig's far half is hidden: then the
    fuse takes the MVS-positive queries seen by fewer than 3 views."""
    cfg = write_synthwig_case(case_root, num_views=MVS_VIEWS)
    cfg.PMVO["infer_inner"] = True
    cfg.mvs.update(occ_model_path=MVS_WEIGHTS["occ"], ori_model_path=MVS_WEIGHTS["ori"],
                   eval_vsize=eval_vsize)
    cfg.infer_inner["render_size"] = list(render_size)
    with open(os.path.join(case_root, "case.yaml"), "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    argv = ["--yaml=" + os.path.join(case_root, "case"), f"--device={device}"]
    pmvo_cli.main(argv)
    steps = infer_cli.main(argv + ["--infer_inner.run_mvs!"])
    case = os.path.join(case_root, "synthwig")
    t = time.perf_counter()
    margin = median_occ_margin(case_paths(cfg), case, device)
    depth_dir = os.path.join(case, "render_depth")
    for name in os.listdir(depth_dir):
        shape = np.load(os.path.join(depth_dir, name)).shape
        np.save(os.path.join(depth_dir, name), np.full(shape, 1.08 / 2 * 255, np.float32))
    log(f"stage 3 on synthwig: median occ margin {margin:.6f} of this case's queries "
        f"({time.perf_counter() - t:.3f} s); depth maps moved to camera depth 1.08")
    pk.reset_launch_counts()
    steps.update(infer_cli.main(argv + ["--infer_inner.render_data!",
                                        f"--mvs.occ_logit_margin={margin!r}"]))
    launches = dict(pk.LAUNCHES)
    checked = check_fused_case(case, device, launches, steps)
    grow_cli.main(argv)
    checked["hair"] = check_hair_outputs(os.path.join(case, "output", "verify", "full"))
    return dict(steps=steps, launches=launches, margin=margin, **checked)


def check_fused_case(case: str, device: str, launches: dict, steps: dict) -> dict:
    """Phase 7d's gates on a synthwig case after stage 3: the 4 maps of every
    view, raw.npy and voxels.dat consistent, full/ grids of the full shape,
    an interior fused (MVS-positive queries, coarse.npy, more voxels in full/
    than in refine/), and every kernel launched on the card."""
    full = os.path.join(case, "output", "verify", "full")
    views = sorted(os.listdir(os.path.join(case, "imgs")))
    pngs = sum(os.path.exists(os.path.join(case, "imgs", v, f"{m}.png"))
               for v in views for m in ("bust_depth", "undirectional_map", "mask", "hair_depth"))
    raw = np.load(os.path.join(case, "ours", "raw.npy"))
    count = len(load_voxels_dat(os.path.join(case, "ours", "voxels.dat"))[0])
    coarse = np.load(os.path.join(full, "coarse.npy"))
    occ = load_occ_mat(os.path.join(full, "Occ3D.mat"))
    ori = load_ori_mat(os.path.join(full, "Ori3D.mat"))
    refine = load_occ_mat(os.path.join(case, "output", "verify", "refine", "Occ3D.mat"))
    full_n, refine_n = int((occ > 0).sum()), int((refine > 0).sum())
    log(f"stage 3 on synthwig: {len(views)} views, {pngs} maps; {len(raw)} queries, "
        f"{count} MVS-positive, {len(coarse)} of them fused as interior; full/ {full_n} "
        f"occupied voxels (refine/ {refine_n}); steps "
        f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}; launches {launches}")
    if (pngs != 4 * MVS_VIEWS or count != int(raw[:, 6].sum()) or not np.isfinite(raw).all()
            or occ.shape != (256, 256, 192) or not np.isfinite(ori).all()):
        raise AssertionError("stage 3: missing or wrong outputs")
    if count == 0 or len(coarse) == 0 or full_n <= refine_n:
        raise AssertionError(f"stage 3: the fuse took no interior: {count} MVS-positive, "
                             f"{len(coarse)} fused, full/ {full_n} voxels, refine/ {refine_n}")
    if device != "cpu" and unlaunched(launches, F32_PATH_KERNELS):
        raise AssertionError(f"not every kernel was launched: {launches}")
    return dict(mvs_positive=count, fused=len(coarse), full_voxels=full_n,
                refine_voxels=refine_n)


def profile_stage3(dev: torch.device, inputs, queries: np.ndarray, margin: float,
                   voxel_strands) -> None:
    """Device time by kernel and idle share of one full-width view's render
    and of one MVS batch through both nets."""
    seg = upload_segments(strands_to_segments(
        [voxel_to_world(torch.from_numpy(s)).numpy() for s in voxel_strands]), dev)
    cam = Cameras.from_json_list(head_camera_list(MVS_VIEWS)[:1], dev)
    bust_v, bust_f = grow_bust_mesh()
    device_profile(lambda: render_view(cam, seg, bust_v, bust_f, RENDER_SIZE),
                   f"one {RENDER_SIZE[0]}x{RENDER_SIZE[1]} view's render")
    occ_net, ori_net = load_net(MVS_CFG, "occ", MVS_VIEWS, dev), load_net(MVS_CFG, "ori", MVS_VIEWS, dev)
    with torch.no_grad():
        feats = occ_net.get_feat(inputs.imgs), ori_net.get_feat(inputs.imgs)
        pts = torch.as_tensor(queries[:MVS_BATCH], device=dev)
        eval_points(occ_net, ori_net, *feats, inputs.w2c, inputs.ndc, pts, margin)
        device_profile(lambda: eval_points(occ_net, ori_net, *feats, inputs.w2c, inputs.ndc,
                                           pts, margin),
                       f"one MVS batch of {MVS_BATCH} queries through both nets")
        device_profile(lambda: occ_net.get_feat(inputs.imgs),
                       f"one net's features of {MVS_VIEWS} views", top=8)


def phase_stage3(dev: torch.device, voxel_strands, profile: bool = False) -> dict:
    """Phase 7: stage 3 at full width (render, nets, MVS), then its CLI, then
    the shipped nets on a scene of their training family."""
    exact_f32()
    torch.cuda.empty_cache()
    missing = [p for p in MVS_WEIGHTS.values() if not os.path.exists(p)]
    if missing:   # the stage would take random weights, with a warning
        raise FileNotFoundError(f"the shipped nets are missing: {missing}")
    margin = occ_margin(MVS_CFG)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mvs_") as tmp:
        with Phase("7b render"):
            render = phase_render(dev, voxel_strands, tmp)
        t = time.perf_counter()
        inputs, _ = load_mvs_inputs(tmp, os.path.join(tmp, "cam_params.json"), device=dev)
        log(f"mvs inputs: {tuple(inputs.imgs.shape)} read in {time.perf_counter() - t:.3f} s")
        queries = hair_shell_points(np.random.default_rng(0), MVS_QUERIES)
        with Phase("7a nets"):
            nets = phase_nets(dev, inputs, queries, margin)
        with Phase("7c mvs"):
            mvs = phase_mvs(dev, inputs, queries, nets["median_margin"], nets, tmp)
        if profile:
            with Phase("profile stage 3"):
                profile_stage3(dev, inputs, queries, margin, voxel_strands)
        del inputs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stage3_") as tmp:
        with Phase("7d stage"):
            stage = phase_infer_inner(tmp, dev.type, RENDER_SIZE, EVAL_VSIZE)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_scene_") as tmp:
        with Phase("7e training scene"):
            scene = phase_training_scene(dev, margin, tmp)
    nets.pop("host_occ"), nets.pop("host_ori")
    return dict(render=render, nets=nets, mvs=mvs, scene=scene, stage=stage)


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

CAPTURE_FRAMES = 32                # tools/make_capture_case.py's orbit
CAPTURE_SIZE = (720, 1280)         # (H, W)
CAPTURE_INTERVAL = 2
HAIR_PARSER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trained",
                           "hair_parser")
SEGMENT_WEIGHTS = {k: os.path.join(HAIR_PARSER, k + ".npz") for k in ("modnet", "bisenet")}
CHECK_FRAMES = 2                   # frames held card against CPU


def sharpness_f64(path: str) -> float:
    """cv2.Laplacian(cvtColor(imread(path), BGR2GRAY), CV_64F).var() in numpy
    float64, written here apart from the port's ops/resize.py."""
    return sharpness_rgb_f64(read_png(path))


def sharpness_rgb_f64(rgb: np.ndarray) -> float:
    """sharpness_f64 of (H, W, 3) uint8 RGB pixels."""
    rgb = rgb.astype(np.int64)
    gray = ((rgb[..., 2] * 3735 + rgb[..., 1] * 19235 + rgb[..., 0] * 9798 + (1 << 14))
            >> 15).astype(np.float64)
    p = np.pad(gray, 1, mode="reflect")
    lap = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * p[1:-1, 1:-1]
    return float(lap.var())


def iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def paeth_png(path: str, rgb: np.ndarray) -> None:
    """Write `rgb` as a PNG whose every row uses filter 4 (Paeth), as many
    writers other than the port's choose it."""
    import struct
    import zlib
    H, W, _ = rgb.shape
    x = rgb.reshape(H, W * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((H, 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], 1)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def check_capture_outputs(case: str, mvs_poses: dict) -> dict:
    """8b on the files the CLI wrote: frames, cameras, depth coverage, hair
    masks, and PMVO's loaders reading them back."""
    frames = sorted(os.listdir(os.path.join(case, "colmap", "images")),
                    key=lambda x: int(x.split(".")[0].split("_")[-1]))
    sharp = [sharpness_f64(os.path.join(case, "colmap", "images", f)) for f in frames]
    want = sorted(frames[i + int(np.argmax(sharp[i:i + CAPTURE_INTERVAL]))]
                  for i in range(0, len(frames), CAPTURE_INTERVAL))
    kept = sorted(os.listdir(os.path.join(case, "capture_images")))
    if kept != want:
        raise AssertionError(f"select_images kept {kept}, float64 sharpness says {want}")
    with open(os.path.join(case, "ours", "cam_params.json")) as f:
        cams = json.load(f)["cam_list"]
    pose_err = max(float(np.abs(np.array(c["pose"]) - mvs_poses[c["file"]]).max()) for c in cams)
    if sorted(c["file"] for c in cams) != [k[:-4] for k in kept] or pose_err > 1e-6:
        raise AssertionError(f"cam_params.json: views {[c['file'] for c in cams]}, "
                             f"pose error {pose_err}")
    names = [k[:-4] for k in kept]
    depth_iou, hair_iou = [], []
    for n in names:
        hit = read_png(os.path.join(case, "labels", "hit", n + ".png")) > 127
        label = read_png(os.path.join(case, "labels", "hair", n + ".png")) > 127
        depth = np.load(os.path.join(case, "render_depth", n + ".npy"))
        depth_iou.append(iou(depth[..., 0] < 255.0, hit))
        hair_iou.append(iou(read_png(os.path.join(case, "hair_mask", n + ".png")) > 127, label))
    # PMVO's loaders on the written maps, in cam_params.json's view order
    _, cameras = load_cam_params(os.path.join(case, "ours", "cam_params.json"), "cpu")
    views, _ = subsample_views([c["file"] for c in cams], cameras,
                               os.path.join(case, "capture_images"))
    ori, conf = load_orientation_and_confidence(views, os.path.join(case, "best_ori"),
                                                os.path.join(case, "conf"))
    depth = load_depth_maps(views, os.path.join(case, "render_depth"))
    mask = load_masks(views, os.path.join(case, "hair_mask"))
    H, W = CAPTURE_SIZE
    V = len(views)
    shapes = dict(ori=ori.shape, conf=conf.shape, depth=depth.shape, mask=mask.shape)
    log(f"stage 1 outputs: kept {len(kept)} frames (float64 sharpness agrees), pose error "
        f"{pose_err:.3g}; depth IoU with the head silhouette min {min(depth_iou):.6f} mean "
        f"{np.mean(depth_iou):.6f}; hair IoU with the labels min {min(hair_iou):.6f} mean "
        f"{np.mean(hair_iou):.6f}; PMVO's loaders read {shapes}")
    if shapes != dict(ori=(V, H, W, 2), conf=(V, H, W), depth=(V, H, W), mask=(V, H, W)) \
            or V != len(kept):
        raise AssertionError(f"PMVO's loaders read {shapes} for {V} views")
    if not all(np.isfinite(x).all() for x in (ori, conf, depth, mask)):
        raise AssertionError("PMVO's loaders read non-finite maps")
    if min(depth_iou) < 0.95:
        raise AssertionError(f"render_depth covers the head silhouette at IoU {min(depth_iou)}")
    if np.mean(hair_iou) < 0.7:
        raise AssertionError(f"hair_mask/ against the labels: mean IoU {np.mean(hair_iou)}")
    return dict(pose_err=pose_err, depth_iou_min=min(depth_iou),
                hair_iou_mean=float(np.mean(hair_iou)), views=V)


def card_against_cpu(case: str, dev: torch.device) -> dict:
    """8b: the port's card path against its own CPU path on CHECK_FRAMES
    capture frames: class maps, Gabor bins and conf, and 8c's per-frame
    times of the nets and the Gabor bank."""
    files = sorted(os.listdir(os.path.join(case, "capture_images")))[:CHECK_FRAMES]
    rgb = np.stack([read_png(os.path.join(case, "capture_images", f)) for f in files])
    out = {}
    for device in ("cpu", dev):
        matting = MattingRunner(SEGMENT_WEIGHTS["modnet"], device=device)
        parser = ParsingRunner(SEGMENT_WEIGHTS["bisenet"], device=device)
        x = torch.as_tensor(rgb, device=device)
        grays = [torch.as_tensor(imread_gray(os.path.join(case, "capture_images", f)),
                                 device=device).float() / 255.0 for f in files]
        res = dict(matte=matting.matte(x).cpu(), classes=parser.parse(x).cpu(),
                   gabor=[tuple(t.cpu() for t in gabor_maps(g)[1:]) for g in grays])
        if device != "cpu":
            one = x[:1]
            res["modnet_ms"] = cuda_time_ms(lambda: matting.matte(one), iters=5, warmup=1)
            res["bisenet_ms"] = cuda_time_ms(lambda: parser.parse(one), iters=5, warmup=1)
            res["gabor_ms"] = cuda_time_ms(lambda: gabor_maps(grays[0]), iters=5, warmup=1)
            g1080 = torch.rand((1080, 1920), generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev)
            res["gabor_1080p_ms"] = cuda_time_ms(lambda: gabor_maps(g1080), iters=5, warmup=1)
        out[str(device)] = res
    cpu, card = out["cpu"], out[str(dev)]
    same_cls = float((cpu["classes"] == card["classes"]).float().mean())
    matte_err = float((cpu["matte"] - card["matte"]).abs().max())
    bins_eq, bins_all, bin_max, conf_err, conf_err_all = [], [], 0, 0.0, 0.0
    for (a_cpu, c_cpu), (a_card, c_card) in zip(cpu["gabor"], card["gabor"]):
        k_cpu = torch.round(a_cpu * 180 / math.pi).long()
        k_card = torch.round(a_card * 180 / math.pi).long()
        d = (k_cpu - k_card).abs()
        d = torch.minimum(d, 180 - d)
        seen = (c_cpu * 255).to(torch.uint8) > 0      # pixels with a written confidence
        bins_eq.append(float((d[seen] == 0).float().mean()))
        bins_all.append(float((d == 0).float().mean()))
        bin_max = max(bin_max, int(d[seen].max()))
        # a flipped argmax moves its pixel's variance too: conf is held where
        # the bins agree
        conf_err = max(conf_err, float((c_cpu - c_card).abs()[d == 0].max()))
        conf_err_all = max(conf_err_all, float((c_cpu - c_card).abs().max()))
    log(f"card vs CPU on {len(files)} frames: class maps equal on {same_cls:.6f} of pixels, "
        f"matte max abs err {matte_err:.3g}; Gabor bins equal on {min(bins_eq):.6f} of the "
        f"pixels with nonzero conf (on {min(bins_all):.6f} of all pixels), at most "
        f"{bin_max} bin apart there, conf max abs err {conf_err:.3g} where the bins agree "
        f"({conf_err_all:.3g} over all pixels)")
    if same_cls < 0.995 or min(bins_eq) < 0.99 or bin_max > 1 or conf_err > 1e-4:
        raise AssertionError("stage 1 on the card disagrees with its CPU path")
    return dict(same_classes=same_cls, bins_equal=min(bins_eq), bins_equal_all=min(bins_all),
                conf_err=conf_err, **{k: card[k] for k in
                                      ("modnet_ms", "bisenet_ms", "gabor_ms", "gabor_1080p_ms")})


def host_png_seconds(case: str) -> dict:
    """8c: the host's PNG work of process_imgs, timed here again on this case's
    files: decoding each capture image twice (once a step) and encoding the six
    maps a frame; and decoding a Paeth-filtered 1920x1080 frame."""
    files = sorted(os.listdir(os.path.join(case, "capture_images")))
    t = time.perf_counter()
    for f in files:
        read_png(os.path.join(case, "capture_images", f))
        imread_gray(os.path.join(case, "capture_images", f))
    decode = time.perf_counter() - t
    maps = [read_png(os.path.join(case, sub, f)) for f in files
            for sub in ("hair_mask", "mask", "mask_hair", "best_ori", "conf", "Ori")]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_png_") as tmp:
        t = time.perf_counter()
        for i, img in enumerate(maps):
            write_png(os.path.join(tmp, f"{i}.png"), img)
        encode = time.perf_counter() - t
        frame = read_png(os.path.join(case, "capture_images", files[0]))
        big = np.ascontiguousarray(np.resize(frame, (1080, 1920, 3)))
        paeth_png(os.path.join(tmp, "paeth.png"), big)
        t = time.perf_counter()
        back = read_png(os.path.join(tmp, "paeth.png"))
        paeth = time.perf_counter() - t
    if not np.array_equal(back, big):
        raise AssertionError("the PNG reader misread a Paeth-filtered frame")
    return dict(decode_s=decode, encode_s=encode, paeth_1080p_s=paeth)


def phase_prepare_data(dev: torch.device) -> dict:
    """Phase 8: stage 1's image half on the card, through its CLI, on a capture
    case of 32 frames at 1280x720 with the shipped hair-parser weights; then
    8b's checks and 8c's numbers."""
    exact_f32()
    torch.cuda.empty_cache()
    missing = [p for p in SEGMENT_WEIGHTS.values() if not os.path.exists(p)]
    if missing:   # the stage would take the classical fallback
        raise FileNotFoundError(f"the shipped hair-parser weights are missing: {missing}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as tmp:
        t = time.perf_counter()
        written = write_capture_case(tmp, "capture", CAPTURE_FRAMES, *CAPTURE_SIZE,
                                     frame_interval=CAPTURE_INTERVAL,
                                     modnet=SEGMENT_WEIGHTS["modnet"],
                                     parser=SEGMENT_WEIGHTS["bisenet"])
        log(f"capture case: {CAPTURE_FRAMES} frames at {CAPTURE_SIZE[1]}x{CAPTURE_SIZE[0]}, "
            f"frame_interval {CAPTURE_INTERVAL}, written in {time.perf_counter() - t:.2f} s")
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(written["config"].to_dict()))
        torch.cuda.reset_peak_memory_stats(dev)
        pk.reset_launch_counts()
        t = time.perf_counter()
        steps = prepare_cli.main(["--yaml=" + os.path.join(tmp, "case"),
                                  "--prepare_data.run_ngp=", "--prepare_data.fit_bust="])
        wall = time.perf_counter() - t
        launches = dict(pk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        case = os.path.join(tmp, "capture")
        outputs = check_capture_outputs(case, written["mvs_poses"])
        versus = card_against_cpu(case, dev)
        png = host_png_seconds(case)
    imgs_s = steps["calculate_masks"] + steps["process_images"]
    host_share = (png["decode_s"] + png["encode_s"]) / imgs_s
    frames = outputs["views"]
    log(f"stage 1 on cuda: {wall:.3f} s through the CLI; seconds per step "
        f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}; peak device memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches} (stage 1 has no CUDA kernel)")
    log(f"stage 1 per frame: Gabor {versus['gabor_ms']:.3f} ms at 1280x720, "
        f"{versus['gabor_1080p_ms']:.3f} ms at 1920x1080; MODNet {versus['modnet_ms']:.3f} ms, "
        f"BiSeNet (3 scales x flip) {versus['bisenet_ms']:.3f} ms; masks "
        f"{frames / steps['calculate_masks']:.3f} frames/s through calculate_masks")
    log(f"process_imgs host PNG work: decode {png['decode_s']:.3f} s, encode "
        f"{png['encode_s']:.3f} s of {imgs_s:.3f} s (host share {host_share:.3f}); a "
        f"Paeth-filtered 1920x1080 frame decodes in {png['paeth_1080p_s']:.3f} s")
    print(smi_line(), flush=True)
    return dict(steps=steps, launches=launches, peak_bytes=peak, host_share=host_share,
                png=png, **outputs, **versus)


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

NGP_RAYS, NGP_SAMPLES = pipeline_ngp.DEFAULT_RAYS_PER_BATCH, 64   # train_nerf's uniform path
NGP_RENDER_SAMPLES = 192                                          # render_image's
NGP_CHUNK = 16384                                                 # render_image's pixels a chunk
NGP_BLOCK = 64                                                    # 9a's density block, per axis
NGP_BG = [0.92, 0.92, 0.92]                                       # capture_config's ngp.background


def rel_norm_err(card: torch.Tensor, host: torch.Tensor) -> float:
    return float((card.cpu() - host).norm() / host.norm().clamp_min(1e-30))


def ngp_batch(ds: NerfDataset, g: torch.Generator):
    """One full-width batch of the capture frames with draws from `g` (on the
    CPU): (ray-batch function of a device, the draws)."""
    F, H, W = ds.images.shape[:3]
    draws = nerf_train.draw_step(g, F, H * W, NGP_RAYS, NGP_SAMPLES, True)
    imgs = np.clip(np.rint(ds.images.reshape(F, H * W, 3) * 255.0), 0, 255).astype(np.uint8)

    def batch(device):
        dr = nerf_train.StepDraws(*[None if t is None else t.to(device) for t in draws])
        o, d, target = nerf_train.ray_batch(torch.as_tensor(imgs, device=device),
                                            torch.as_tensor(ds.c2w, device=device),
                                            dr.frames, dr.pixels, W, ds.fx, ds.fy, ds.cx, ds.cy)
        return dr, o, d, target
    return batch


def nerf_card_against_cpu(dev: torch.device, ds: NerfDataset) -> dict:
    """9a: a seeded full-width Fourier field on both devices: one training
    step's loss and gradients on one batch of given draws, one render chunk,
    one 64^3 block of the density export; and the card's times of each."""
    g = torch.Generator().manual_seed(0)
    host = FourierField(generator=g)
    card = copy.deepcopy(host).to(dev)
    batch = ngp_batch(ds, g)
    out = {}
    losses, grads = {}, {}
    host64 = copy.deepcopy(host).double()
    for name, field in (("cpu", host), ("card", card), ("cpu64", host64)):
        device = next(field.parameters()).device
        dtype = next(field.parameters()).dtype
        dr, o, d, target = batch(device)
        dr = nerf_train.StepDraws(*[t.to(dtype) if t is not None and t.is_floating_point()
                                    else t for t in dr])
        loss = nerf_train.nerf_loss(field, o.to(dtype), d.to(dtype), target.to(dtype), dr,
                                    NGP_SAMPLES, as_background(NGP_BG, device).to(dtype))
        losses[name] = float(loss.detach())
        grads[name] = torch.autograd.grad(loss, list(field.parameters()))
    loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    # The gradients of the layers fed by the sin/cos features (trunk.0, skip)
    # cancel over the batch's 262,144 samples, so an ulp of a feature angle
    # (up to ~300 rad) moves them by ~1e-3 relative: the CPU's own f32
    # gradient is that far from float64. Each device's f32 gradient is held
    # against the CPU's float64 one, within 1e-4 or twice the CPU f32's error.
    names = [n for n, _ in host.named_parameters()]
    err = {dev_name: [rel_norm_err(a, b.float()) for a, b in zip(grads[dev_name], grads["cpu64"])]
           for dev_name in ("cpu", "card")}
    grad_err = max(rel_norm_err(a, b) for a, b in zip(grads["card"], grads["cpu"]))
    grad_fail = [n for n, c, h in zip(names, err["card"], err["cpu"]) if c > max(1e-4, 2 * h)]
    log("9a gradient rel norm err per parameter, card vs CPU f32 / card vs CPU f64 / "
        "CPU f32 vs CPU f64: " + "; ".join(
            f"{n} {rel_norm_err(a, b):.2e} / {c:.2e} / {h:.2e}"
            for n, a, b, c, h in zip(names, grads["card"], grads["cpu"], err["card"], err["cpu"])))

    # one render chunk: the first 16384 pixels of training frame 0, 192 samples
    H, W = ds.images.shape[1:3]
    pix = torch.stack(torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij"), -1
                      ).reshape(-1, 2)[:NGP_CHUNK].float()
    rendered = {}
    with torch.no_grad():
        for name, field in (("cpu", host), ("card", card)):
            device = next(field.parameters()).device
            o, d = camera_rays(torch.as_tensor(ds.c2w[0], device=device), ds.fx, ds.fy,
                               ds.cx, ds.cy, pix.to(device))
            rendered[name] = render_rays(field, o, d, NGP_RENDER_SAMPLES,
                                         background=as_background(NGP_BG, device))[:2]
        rgb_err = float((rendered["card"][0].cpu() - rendered["cpu"][0]).abs().max())
        depth_err = float(((rendered["card"][1].cpu() - rendered["cpu"][1]).abs()
                           / rendered["cpu"][1].abs().clamp_min(1.0)).max())
        # the central 64^3 block of the 256^3 export grid (the head)
        res = pipeline_ngp.DEFAULT_MESH_RES
        lo = (res - NGP_BLOCK) // 2
        block = grid_points(res, pipeline_ngp.DEFAULT_MESH_BOUND).reshape(res, res, res, 3)[
            lo:lo + NGP_BLOCK, lo:lo + NGP_BLOCK, lo:lo + NGP_BLOCK]
        pts = torch.as_tensor(block.reshape(-1, 3).copy())
        sig_cpu = host.density(nerf_to_unit(pts))[0]
        sig_card = card.density(nerf_to_unit(pts.to(dev)))[0].cpu()
        sig_err = float(((sig_card - sig_cpu).abs() / sig_cpu.abs().clamp_min(1e-6)).max())

        # card times: a render chunk and the density block (CUDA events)
        o, d = camera_rays(torch.as_tensor(ds.c2w[0], device=dev), ds.fx, ds.fy, ds.cx,
                           ds.cy, pix.to(dev))
        bg = as_background(NGP_BG, dev)
        out["chunk_ms"] = cuda_time_ms(lambda: render_rays(card, o, d, NGP_RENDER_SAMPLES,
                                                           background=bg), iters=5, warmup=1)
        pts_d = nerf_to_unit(pts.to(dev))
        out["density_block_ms"] = cuda_time_ms(lambda: card.density(pts_d), iters=10)

    # a whole training step on the card: draws, batch, loss, backward, optimiser
    F = len(ds.images)
    imgs = torch.as_tensor(np.clip(np.rint(ds.images.reshape(F, H * W, 3) * 255.0), 0, 255)
                           .astype(np.uint8), device=dev)
    c2w = torch.as_tensor(ds.c2w, device=dev)
    params = list(card.parameters())
    opt = nerf_train.OptaxAdam(params, 1e-3, pipeline_ngp.DEFAULT_TRAIN_STEPS)
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        dr = nerf_train.draw_step(gen, F, H * W, NGP_RAYS, NGP_SAMPLES, True)
        o, d, target = nerf_train.ray_batch(imgs, c2w, dr.frames, dr.pixels, W, ds.fx, ds.fy,
                                            ds.cx, ds.cy)
        loss = nerf_train.nerf_loss(card, o, d, target, dr, NGP_SAMPLES, bg)
        opt.step(torch.autograd.grad(loss, params))

    out["step_ms"] = cuda_time_ms(step, iters=20, warmup=3)
    out["step_busy"] = device_profile(step, "one full-width NeRF training step", top=12)
    fps = card.flops_per_sample()
    out["step_bound_ms"] = 3 * fps * (NGP_RAYS * NGP_SAMPLES + nerf_train.SPARSITY_POINTS) \
        / H100_F32_FLOPS * 1e3
    out["chunk_bound_ms"] = fps * NGP_CHUNK * NGP_RENDER_SAMPLES / H100_F32_FLOPS * 1e3
    log(f"9a card vs CPU, seeded full-width Fourier field: train-step loss rel err "
        f"{loss_err:.3g}, worst parameter gradient rel norm err {grad_err:.3g} (against the "
        f"CPU's float64: card {max(err['card']):.3g}, CPU f32 {max(err['cpu']):.3g}); render chunk "
        f"({NGP_CHUNK} rays x {NGP_RENDER_SAMPLES}) rgb max abs err {rgb_err:.3g}, depth max "
        f"rel err {depth_err:.3g}; {NGP_BLOCK}^3 density block max rel err {sig_err:.3g}")
    log(f"9a card times: training step {out['step_ms']:.3f} ms (bound "
        f"{out['step_bound_ms']:.3f} ms at 67 TFLOP/s f32), render chunk "
        f"{out['chunk_ms']:.3f} ms (bound {out['chunk_bound_ms']:.3f} ms), density block "
        f"{out['density_block_ms']:.3f} ms")
    if loss_err > 1e-4 or grad_fail or rgb_err > 1e-4 or depth_err > 1e-4 or sig_err > 1e-4:
        raise AssertionError(f"the NeRF on the card disagrees with its CPU path "
                             f"(gradients of {grad_fail})")
    return dict(out, loss_err=loss_err, grad_err=grad_err, rgb_err=rgb_err,
                depth_err=depth_err, density_err=sig_err,
                grad_err64=max(err["card"]), cpu_grad_err64=max(err["cpu"]))


def shell_recall_precision(verts: np.ndarray, res: int, bound: float, radius: float):
    """tests/test_ngp_stage.py's recall at the export resolution (the share of
    the voxels within 1.5 voxels of the sphere covered by a vertex's voxel
    dilated by one), and the share of vertices within 2 voxels of the sphere."""
    vox = 2 * bound / res
    ax = np.linspace(-bound, bound, res)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    shell = np.abs(np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - radius) < 1.5 * vox
    vi = np.clip(np.round((verts + bound) / (2 * bound) * (res - 1)), 0, res - 1).astype(int)
    pred = np.zeros((res,) * 3, bool)
    pred[vi[:, 0], vi[:, 1], vi[:, 2]] = True
    for axis in range(3):
        pred |= np.roll(pred, 1, axis) | np.roll(pred, -1, axis)
    recall = float((pred & shell).sum() / shell.sum())
    precision = float(np.mean(np.abs(np.linalg.norm(verts, axis=1) - radius) < 2 * vox))
    return recall, precision


def obj_records(path: str) -> tuple:
    """An OBJ written by save_obj (its `v` records, then its `f` records):
    the count of `v` records and the bytes of the `f` records."""
    with open(path, "rb") as f:
        data = b"\n" + f.read()
    faces = data.find(b"\nf ")
    faces = len(data) if faces < 0 else faces
    return data.count(b"\nv ", 0, faces), data[faces:]


def phase_ngp(dev: torch.device, tmp: str) -> dict:
    """Phase 9: stage 1 with the NeRF on, through its CLI, on a fresh capture
    case (32 frames at 1280x720) written into `tmp` at the shipped budget
    (process_bust and render_depth off: phase 10 runs them on this case with
    the fitted bust); 9a before it. Returns the numbers with the case's
    "config" and "mvs_poses"."""
    exact_f32()
    torch.cuda.empty_cache()
    written = write_capture_case(tmp, "capture", CAPTURE_FRAMES, *CAPTURE_SIZE,
                                 frame_interval=CAPTURE_INTERVAL,
                                 modnet=SEGMENT_WEIGHTS["modnet"],
                                 parser=SEGMENT_WEIGHTS["bisenet"])
    cfg = written["config"]
    with open(os.path.join(tmp, "case.yaml"), "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    case = os.path.join(tmp, "capture")
    colmap = os.path.join(case, "colmap")
    ds = load_nerf_dataset(os.path.join(colmap, "transforms.json"),
                           os.path.join(colmap, "images"))
    with Phase("9a NeRF card vs CPU"):
        versus = nerf_card_against_cpu(dev, ds)
    torch.cuda.empty_cache()
    with open(os.path.join(case, "ours", "colmap_points.obj"), "rb") as f:
        analytic = f.read()
    kept = {}
    real_train, real_stage = pipeline_ngp.train_ngp, pipeline_ngp.run_ngp_stage

    def train_kept(args, device="cuda"):
        kept["train"] = real_train(args, device)
        return kept["train"]

    def stage_kept(args, device="cuda"):
        kept["seconds"] = real_stage(args, device)
        return kept["seconds"]

    pipeline_ngp.train_ngp, pipeline_ngp.run_ngp_stage = train_kept, stage_kept
    torch.cuda.reset_peak_memory_stats(dev)
    pk.reset_launch_counts()
    t = time.perf_counter()
    try:
        steps = prepare_cli.main(["--yaml=" + os.path.join(tmp, "case"),
                                  "--prepare_data.run_ngp", "--prepare_data.fit_bust=",
                                  "--prepare_data.process_bust=",
                                  "--prepare_data.render_depth="])
    finally:
        pipeline_ngp.train_ngp, pipeline_ngp.run_ngp_stage = real_train, real_stage
    wall = time.perf_counter() - t
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    field, losses, _ = kept["train"]
    sub = kept["seconds"]

    # 9b's gates on the files
    t = time.perf_counter()
    nerf_v, nerf_f = load_obj(os.path.join(colmap, "base.obj"))
    # the MVS-frame copy: as many vertices and the same face records
    nerf_nv, nerf_faces = obj_records(os.path.join(colmap, "base.obj"))
    mvs_nv, mvs_faces = obj_records(os.path.join(case, "ours", "colmap_points.obj"))
    with open(os.path.join(case, "ours", "colmap_points.obj"), "rb") as f:
        replaced = f.read() != analytic
    views = len(load_base_cam(os.path.join(colmap, "base_cam.json"))[0])
    shots = [os.path.join(case, "trainning_images", "capture_images", "%03d.png" % i)
             for i in range(views)]
    origins = [os.path.join(case, "imgs", "%03d" % i, "origin.png") for i in range(views)]
    H, W = cfg.infer_inner["render_size"]
    missing = [p for p in shots + origins if not os.path.exists(p)]
    shapes = {read_png(p).shape for p in shots + origins if os.path.exists(p)}
    recall, precision = shell_recall_precision(nerf_v, pipeline_ngp.DEFAULT_MESH_RES,
                                               pipeline_ngp.DEFAULT_MESH_BOUND,
                                               CAPTURE_HEAD_R_NERF)
    # printed, not gated: the fit on two training frames
    bg = NGP_BG
    psnrs = []
    for i in (0, 1):
        rgb, _ = render_image(field, ds.c2w[i], *ds.images.shape[1:3], ds.fx, ds.fy,
                              ds.cx, ds.cy, background=bg)
        psnrs.append(psnr(rgb, ds.images[i]))
    checks_s = time.perf_counter() - t
    steps_n = int(ngp_options(cfg).get("train_steps", pipeline_ngp.DEFAULT_TRAIN_STEPS))
    fps = field.flops_per_sample()
    view_bound = fps * H * W * NGP_RENDER_SAMPLES / H100_F32_FLOPS
    out = dict(steps=steps, sub=sub, wall=wall, launches=launches, peak_bytes=peak,
               recall=recall, precision=precision, final_loss=losses[-1], psnr=psnrs,
               train_ms_per_step=sub["train"] / steps_n * 1e3,
               view_s=sub["render"] / views, view_bound_s=view_bound,
               triangles=len(nerf_f), checks_s=checks_s, config=cfg,
               mvs_poses=written["mvs_poses"], **versus)
    log(f"stage 1 with the NeRF on cuda: {wall:.3f} s through the CLI; seconds per step "
        f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}; run_ngp's parts "
        f"{json.dumps({k: round(v, 4) for k, v in sub.items()})}; peak device memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches} (the NeRF has no CUDA kernel); "
        f"this script's checks of the files {checks_s:.3f} s")
    log(f"run_ngp: {steps_n} steps in {sub['train']:.3f} s = {out['train_ms_per_step']:.3f} "
        f"ms a step (9a's steady step {versus['step_ms']:.3f} ms, bound "
        f"{versus['step_bound_ms']:.3f} ms); {views} views at {W}x{H} in {sub['render']:.3f} s "
        f"= {out['view_s']:.4f} s a view (bound {view_bound:.4f} s); density "
        f"{sub['density']:.3f} s; marching (host C++) {sub['marching']:.3f} s; meshes saved "
        f"in {sub['save_meshes']:.3f} s")
    log(f"run_ngp mesh: {len(nerf_f)} triangles, shell recall {recall:.4f}, precision (vertices "
        f"within 2 voxels of the r={CAPTURE_HEAD_R_NERF} shell) {precision:.4f}; final loss "
        f"{losses[-1]:.6f} (curve {[round(x, 6) for x in losses]}); PSNR of frames 0 and 1 "
        f"{psnrs[0]:.3f} / {psnrs[1]:.3f} dB (phase 10 renders the depth maps from this mesh)")
    print(smi_line(), flush=True)
    if not (len(nerf_f) and mvs_nv == nerf_nv == len(nerf_v) and mvs_faces == nerf_faces
            and replaced):
        raise AssertionError(f"run_ngp's meshes: base.obj {len(nerf_v)} vertices, "
                             f"colmap_points.obj {mvs_nv}, replaced {replaced}")
    if missing or shapes != {(H, W, 3)} or views != 16:
        raise AssertionError(f"run_ngp's {views} fixed views: shapes {shapes}, "
                             f"missing {missing}")
    if recall < 0.8:
        raise AssertionError(f"run_ngp's mesh misses the head: shell recall {recall:.4f}")
    return out


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

FIT_ITERS = 1000                 # half run_bust_fit's default 2000 (optimize.iter): room for phase 14
FIT_BUDGET_S = 25.0              # the fit's share of the smoke run's time limit
FIT_TIMED_STEPS = 20             # steady steps timed with CUDA events
FAN_CHECK_FRAMES = 2             # frames whose heatmaps are held card against CPU


def fan_checkpoint(path: str) -> None:
    """2DFAN-4 at its published width (4 modules of depth 4, 256 features)
    with seeded random weights and running statistics, as a flax tree."""
    torch.manual_seed(0)
    net = FAN(num_modules=4, depth=4, width=1.0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    save_flax_npz(net, path)


def write_fit_case(tmp: str, cfg: Config, mvs_poses: dict):
    """The bust fit's synthetic assets and annotations at the official SMPL-X
    sizes, written into phase 9's case in `tmp` (32 frames at 1280x720, the
    shipped hair-parser weights, stage 1 run with the NeRF). Returns (config,
    case dir, truth)."""
    case = os.path.join(tmp, "capture")
    truth = write_bust_fit_assets(case, cfg, mvs_poses, *CAPTURE_SIZE,
                                  sizes=SMPLX_OFFICIAL, iters=FIT_ITERS)
    return cfg, case, truth


def stage_args(cfg: Config, case: str) -> Config:
    """The stage's resolved config for a written case (data.root = the case)."""
    args = Config(json.loads(json.dumps(cfg.to_dict())))
    args.data["root"] = case
    return args


def phase_fan(dev: torch.device, case: str, cfg: Config, tmp: str) -> dict:
    """10a: FAN at its published width with seeded random weights on the case's
    16 rig frames: heatmaps on the card against the CPU on 2 frames, ms a
    frame; then the four annotation backends on a copy of the case and the
    formats of what they write."""
    ckpt = os.path.join(tmp, "fan.npz")
    fan_checkpoint(ckpt)
    files = sorted(os.listdir(os.path.join(case, "capture_images")))
    rgb = np.stack([read_png(os.path.join(case, "capture_images", f)) for f in files])
    boxes = np.stack([face_box_from_mask(read_png(os.path.join(case, "labels", "hit", f)) / 255.0)
                      for f in files])
    heat = {}
    for device in ("cpu", dev):
        runner = LandmarkRunner(ckpt, device=device)
        heat[str(device)] = runner.heatmaps(torch.as_tensor(rgb[:FAN_CHECK_FRAMES], device=device),
                                            boxes[:FAN_CHECK_FRAMES]).cpu()
    cpu_heat = heat["cpu"]
    heat_err = float((heat[str(dev)] - cpu_heat).abs().max() / cpu_heat.abs().max())
    same_argmax = float((decode_heatmaps(heat[str(dev)].permute(0, 2, 3, 1).numpy())
                         == decode_heatmaps(cpu_heat.permute(0, 2, 3, 1).numpy())).mean())
    frames = torch.as_tensor(rgb, device=dev)
    with torch.inference_mode():
        crops = torch.stack([resize_linear(f.permute(2, 0, 1)[None], (256, 256))[0]
                             for f in frames]).float() / 255.0
        fan_ms = cuda_time_ms(lambda: runner.net(crops), iters=5, warmup=1) / len(files)
    lmk = runner.landmarks(frames, boxes)
    log(f"10a FAN (2DFAN-4, random weights) card vs CPU on {FAN_CHECK_FRAMES} frames: heatmap "
        f"max abs err {heat_err:.3g} of the largest heat, decoded landmarks equal on "
        f"{same_argmax:.4f}; {fan_ms:.3f} ms a frame at a batch of {len(files)} "
        f"(CUDA events); landmarks {lmk.shape}")
    print(smi_line(), flush=True)
    if heat_err > 1e-4 or not np.isfinite(lmk).all():
        raise AssertionError(f"FAN on the card disagrees with its CPU path ({heat_err})")

    # the four annotation backends on a copy of the case
    copy_dir = os.path.join(tmp, "annotate")
    shutil.copytree(os.path.join(case, "capture_images"), os.path.join(copy_dir, "capture_images"))
    acfg = stage_args(cfg, copy_dir)
    acfg.segment.update(fan_flax=ckpt, fan_modules=4, fan_depth=4, fan_width=1.0)
    t = time.perf_counter()
    status = AnnotationProcessor(copy_dir, backends=default_backends(acfg, dev)).run()
    annotate_s = time.perf_counter() - t
    opt = os.path.join(copy_dir, "optimize")
    bad = []
    for f in files:
        stem = f[:-4]
        rgba = read_png(os.path.join(opt, "matting", f))
        if rgba.shape != (*CAPTURE_SIZE, 4) or not np.array_equal(rgba[..., :3], read_png(
                os.path.join(case, "capture_images", f))):
            bad.append(("matting", f, rgba.shape))
        if np.loadtxt(os.path.join(opt, "landmark2d", stem + ".txt")).shape != (68, 2):
            bad.append(("landmark2d", f))
        iris = np.loadtxt(os.path.join(opt, "iris", stem + ".txt"))
        if iris.shape != (2, 3) or not (iris[:, 2] == 1).all():
            bad.append(("iris", f, iris.shape))
        cls = read_png(os.path.join(opt, "face_parsing", f))
        if cls.shape != CAPTURE_SIZE or cls.dtype != np.uint8 or cls.max() > 18:
            bad.append(("face_parsing", f, cls.shape))
    log(f"10a annotation backends on {len(files)} frames in {annotate_s:.3f} s: {status}; "
        f"formats: RGBA matte, (68, 2) landmarks, (2, 3) iris, uint8 classes "
        f"({'all as expected' if not bad else bad[:4]})")
    if bad or set(status.values()) != {"computed"}:
        raise AssertionError(f"annotation backends: {status}, {bad[:4]}")
    return dict(heat_err=heat_err, fan_ms=fan_ms, annotate_s=annotate_s)


def similarity_of(src: np.ndarray, dst: np.ndarray):
    """Umeyama: (s, R, t) with dst ~ s R src + t, least squares."""
    ms, md = src.mean(0), dst.mean(0)
    a, b = src - ms, dst - md
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / (a ** 2).sum(1).mean())
    return s, R, md - s * R @ ms


def rotation_deg(R: np.ndarray) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))))


def fit_card_against_cpu(args: Config, dev: torch.device) -> dict:
    """10b: fit_losses and its gradients at one seeded state on the card and on
    the CPU; then the card's steady step time and busy share."""
    rng = np.random.default_rng(0)
    problems = {str(d): bust_pipeline.load_fit_problem(args, d) for d in ("cpu", dev)}
    prob = problems["cpu"]
    model = prob.model
    n_tex = prob.tex_model.n_tex
    leaves = [rng.normal(size=model.num_betas) * 0.1, rng.normal(size=model.num_expr) * 0.1,
              rng.normal(size=n_tex) * 0.1, rng.normal(size=(prob.frames, 9, 3)) * 0.1,
              rng.normal(size=(model.num_joints, 3)) * 0.01, rng.normal(size=3) * 0.02,
              rng.normal(size=3) * 0.005, np.float32(0.02)]
    terms, grads = {}, {}
    for name, p in problems.items():
        params, _, _ = bust_optimize.fit_setup(
            p.model, p.cameras, p.image_size, p.targets, p.lmk_ids, p.iris_ids, p.tex_model,
            FIT_ITERS, sil_scale=p.sil_scale,
            start=bust_optimize.fit_params_from_numpy(leaves, name))
        for x in params:
            x.requires_grad_(True)
        m = p.model._replace(faces=torch.as_tensor(p.model.faces, device=p.model.device))
        dvc = p.model.device
        t = bust_optimize.fit_losses(
            m, params, p.cameras, p.image_size, p.targets, p.lmk_ids, p.iris_ids,
            torch.as_tensor(bust_optimize.default_init_pose(model.num_joints), device=dvc),
            torch.as_tensor(bust_optimize.free_joint_mask(model.num_joints, True), device=dvc),
            p.tex_model, bust_optimize.DEFAULT_WEIGHTS, sil_scale=p.sil_scale)
        terms[name] = {k: float(v.detach()) for k, v in t.items()}
        g = torch.autograd.grad(bust_optimize.total_loss(t), list(params), allow_unused=True)
        grads[name] = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(params, g)]
    card = str(dev)
    term_err = max(abs(terms[card][k] - v) / max(abs(v), 1e-12) for k, v in terms["cpu"].items())
    grad_err = {f: rel_norm_err(a, b) for f, a, b in
                zip(bust_optimize.FitParams._fields, grads[card], grads["cpu"])
                if float(b.norm()) > 0}
    log(f"10b fit_losses card vs CPU at a seeded state ({prob.frames} views, "
        f"{len(model.faces)} faces): terms max rel err {term_err:.3g} "
        f"({json.dumps({k: round(v, 6) for k, v in terms[card].items()})}); gradient rel norm "
        f"err per leaf {json.dumps({k: float(f'{v:.3g}') for k, v in grad_err.items()})}")

    p = problems[card]
    params, opt, loss_fn = bust_optimize.fit_setup(
        p.model, p.cameras, p.image_size, p.targets, p.lmk_ids, p.iris_ids, p.tex_model,
        FIT_ITERS, sil_scale=p.sil_scale)
    step_ms = cuda_time_ms(lambda: bust_optimize.fit_step(params, opt, loss_fn),
                           iters=FIT_TIMED_STEPS, warmup=3)
    busy = device_profile(lambda: bust_optimize.fit_step(params, opt, loss_fn),
                          "one bust-fit step (16 views, 20,908 faces)", top=12)
    if term_err > 1e-4 or max(grad_err.values()) > 1e-3:
        raise AssertionError(f"the bust fit on the card disagrees with its CPU path: terms "
                             f"{term_err}, gradients {grad_err}")
    return dict(term_err=term_err, grad_err=max(grad_err.values()), step_ms=step_ms,
                busy=busy)


def phase_bust_fit(dev: torch.device, tmp: str, cfg: Config, mvs_poses: dict) -> dict:
    """Phase 10: the FAN checks (10a), then the prepare_data CLI with fit_bust,
    process_bust and render_depth on (10b) on phase 9's capture case in `tmp`
    with the synthetic SMPL-X at the official sizes and annotations from
    truth: the depth maps come from the NeRF's mesh and the fitted bust."""
    exact_f32()
    torch.cuda.empty_cache()
    cfg, case, truth = write_fit_case(tmp, cfg, mvs_poses)
    with Phase("10a FAN and the annotation backends"):
        fan = phase_fan(dev, case, cfg, tmp)
    torch.cuda.empty_cache()
    args = stage_args(cfg, case)
    versus = fit_card_against_cpu(args, dev)
    iters = min(FIT_ITERS, int(FIT_BUDGET_S * 1e3 / versus["step_ms"]))
    if iters < FIT_ITERS:
        log(f"10b: the fit runs {iters} of its {FIT_ITERS} iterations (at "
            f"{versus['step_ms']:.3f} ms a step, {FIT_ITERS} would take "
            f"{FIT_ITERS * versus['step_ms'] / 1e3:.1f} s)")
    cfg.optimize["iter"] = iters
    with open(os.path.join(tmp, "case.yaml"), "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    kept = {}
    real = bust_pipeline.run_bust_fit

    def fit_kept(a, device="cuda"):
        kept["fit"] = real(a, device)
        return kept["fit"]

    bust_pipeline.run_bust_fit = fit_kept
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pk.reset_launch_counts()
    t = time.perf_counter()
    try:
        steps = prepare_cli.main(["--yaml=" + os.path.join(tmp, "case"),
                                  "--prepare_data.select_images=",
                                  "--prepare_data.process_camera=",
                                  "--prepare_data.run_ngp=", "--prepare_data.fit_bust",
                                  "--prepare_data.process_bust",
                                  "--prepare_data.render_depth",
                                  "--prepare_data.process_imgs="])
    finally:
        bust_pipeline.run_bust_fit = real
    wall = time.perf_counter() - t
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    fit = kept["fit"]

    # 10b's gates on the files
    opt = os.path.join(case, "optimize")
    tsfm = load_model_tsfm(os.path.join(opt, "model_tsfm.dat"))
    sem = np.fromfile(os.path.join(opt, "model_tsfm_semantic.dat"), np.float32)
    verts, _ = load_obj(os.path.join(opt, "final_template.obj"))
    verts = verts + BUST_TO_ORIGIN
    Vh = truth["head_count"]
    s, R, tr = similarity_of(truth["template"][:Vh].astype(np.float64), verts[:Vh])
    S = truth["similarity"]
    s_true = float(np.cbrt(np.linalg.det(S[:3, :3])))
    rot_err = rotation_deg(R @ (S[:3, :3] / s_true).T)
    scale_err = abs(s / s_true - 1)
    transl_err = float(np.abs(tr - S[:3, 3]).max())
    m_s = float(np.cbrt(np.linalg.det(tsfm[:3, :3])))
    tsfm_rot_deg = rotation_deg(tsfm[:3, :3] / m_s)
    true_rot_deg = rotation_deg(S[:3, :3] / s_true)
    lmk_ids = truth["lmk_ids"]
    err = np.linalg.norm(verts[lmk_ids] - truth["landmark_truth"], axis=1)
    err0 = np.linalg.norm(truth["template"][lmk_ids] - truth["landmark_truth"], axis=1)
    files = {name: os.path.getsize(os.path.join(case, name)) if os.path.exists(
        os.path.join(case, name)) else -1 for name in (
        "model_tsfm.dat", "model_tsfm_semantic.dat", "optimize/final_template.obj",
        "optimize/fit_losses.txt", "Bust/bust_long.obj", "Bust/flame_bust.obj",
        "Bust/scalp.obj", "ours/bust_long_tsfm.obj", "ours/scalp_tsfm.obj",
        "ours/flame_bust_tsfm.obj")}
    kept_frames = sorted(f[:-4] for f in os.listdir(os.path.join(case, "capture_images")))
    depth_iou = [iou(np.load(os.path.join(case, "render_depth", n + ".npy"))[..., 0] < 255.0,
                     read_png(os.path.join(case, "labels", "hit", n + ".png")) > 127)
                 for n in kept_frames]
    with open(cfg.camera_path) as f:
        rig_views = len(json.load(f)["cam_list"])
    bust_depth = [os.path.exists(os.path.join(case, "imgs", "%03d" % i, "bust_hair_depth.png"))
                  for i in range(rig_views)]
    ms_per_step = fit["fit_s"] / fit["iters"] * 1e3
    log(f"stage 1 with the bust fit on cuda: {wall:.3f} s through the CLI; seconds per step "
        f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}; peak device memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches} (the bust fit has no CUDA kernel)")
    log(f"10b fit: {fit['iters']} iterations over {fit['frames']} frames in {fit['fit_s']:.3f} s "
        f"= {ms_per_step:.3f} ms a step in the stage; steady {versus['step_ms']:.3f} ms a step "
        f"(CUDA events over {FIT_TIMED_STEPS}), {FIT_ITERS} steps projected "
        f"{FIT_ITERS * versus['step_ms'] / 1e3:.1f} s; device busy share of a step "
        f"{versus['busy']:.4f}; loss curve {[round(x, 5) for x in fit['losses']]}")
    log(f"10b result: fitted head similarity vs truth: rotation {rot_err:.4f} deg, scale "
        f"{scale_err:.5f}, translation {transl_err:.5f}; model_tsfm.dat {tsfm.tolist()} holds "
        f"{tsfm_rot_deg:.3f} of the {true_rot_deg:.3f} deg rotation (the rest is in the root "
        f"and neck joints), scale {m_s:.5f} (true {s_true:.5f}), semantic {sem.tolist()}; "
        f"landmark vertices max err {err.max():.6f} mean {err.mean():.6f} (start max "
        f"{err0.max():.6f}, {err0.max() / max(err.max(), 1e-12):.1f}x closer); files {files}; "
        f"depth IoU of render_depth with the head silhouettes min {min(depth_iou):.6f} "
        f"mean {np.mean(depth_iou):.6f}; bust_hair_depth.png in {sum(bust_depth)} of {rig_views} "
        f"rig views")
    print(smi_line(), flush=True)
    if not np.isfinite(tsfm).all() or rot_err > 1.0 or scale_err > 0.01 or transl_err > 0.005:
        raise AssertionError(f"the fitted similarity misses the truth: rotation {rot_err} deg, "
                             f"scale {scale_err}, translation {transl_err}")
    if err.max() > 0.01 or err.max() * 5 > err0.max():
        raise AssertionError(f"landmark vertices {err.max()} from the truth (start {err0.max()})")
    if min(files.values()) <= 0 or not all(bust_depth):
        raise AssertionError(f"the bust fit's files: {files}, bust depth {bust_depth}")
    return dict(steps=steps, wall=wall, launches=launches, peak_bytes=peak, fit=fit,
                ms_per_step=ms_per_step, rot_err=rot_err, scale_err=scale_err,
                transl_err=transl_err, lmk_err=float(err.max()), **versus, **fan)


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

TRAIN_CASES = 4                  # cases of the nets' training family the CLI trains on
TRAIN_BATCH = 4096               # train_mvs's --batch
TRAIN_CHECK_BATCH = 1024         # 11a's points: the CPU's float64 step grows with them
TRAIN_LR = 1e-4                  # train_mvs's --lr
TRAIN_STEPS = 1000               # the CLI's steps, fewer when they would pass TRAIN_BUDGET_S
TRAIN_BUDGET_S = 20.0            # the CLI's share of the smoke run's time limit
TRAIN_EVAL_EVERY = 100           # the CLI's --eval_every
TRAIN_TIMED_STEPS = 20           # steady steps timed with CUDA events
TRAIN_MIN_F1 = 0.7               # 11c's val F1 floor: an all-occupied guess scores ~0.51
TRAIN_NETS = {"occ": OccAttn, "ori": OriAttn}


def write_train_cases(root: str, dev: torch.device) -> str:
    """TRAIN_CASES cases of the shipped nets' training family
    (tools/make_mvs_cases.py): the wigs of seeds 1000.., the four maps of 16
    ring views rendered at 256x256 by the port's renderer into
    <root>/data/caseNNN/imgs, ours/Occ3D.mat the closed wig volume and
    ours/Ori3D.mat its voxelised strand tangents. Returns the cam_params.json
    that serves every case."""
    cam_list = mvs_train_camera_list(MVS_VIEWS)
    ndc, w2c = cameras_numpy(cam_list)
    names = [c["file"] for c in cam_list]
    calib = os.path.join(root, "cam_params.json")
    save_cam_params(calib, names, ndc, np.linalg.inv(w2c))
    cams = Cameras.from_json_list(cam_list, dev)
    head_v, head_f = mvs_train_head_mesh()
    for c in range(TRAIN_CASES):
        strands = mvs_train_wig(np.random.default_rng(1000 + c))
        case = os.path.join(root, "data", f"case{c:03d}")
        render_data(cams, names, strands, head_v, head_f, MVS_TRAIN_RENDER_SIZE,
                    os.path.join(case, "imgs"))
        pts = torch.from_numpy(np.concatenate([s[:-1] for s in strands]))
        tangents = torch.from_numpy(np.concatenate([s[1:] - s[:-1] for s in strands]))
        _, ori = voxelize_directions(pts, tangents)
        save_occ_ori_mat(os.path.join(case, "ours"), mvs_train_occupancy(strands), ori.numpy())
    return calib


def train_card_against_cpu(kind: str, entry: dict, dev: torch.device) -> dict:
    """11a and 11b for one net: both states drawn by flax_init from one seed
    (the same weights), one batch of TRAIN_BATCH training points of a case;
    loss_and_grads and one Adam step on the card in f32 held against the same
    on the CPU in float64 (the CPU's own f32 gradients of the ori net sit
    further from float64 than the card's: tools/mvs_train_precision.py), on
    TRAIN_CHECK_BATCH of those points, evenly strided; then the card's steady step
    time, its profile and its peak memory on all of them."""
    rng = np.random.default_rng(1)
    pts, targets = entry["train_dev"]
    sel = (train_cli.balanced_batch(entry, rng, TRAIN_BATCH) if kind == "occ"
           else rng.integers(0, len(pts), TRAIN_BATCH))
    idx = torch.as_tensor(sel, device=dev)
    timed = (entry["inputs"].imgs, entry["inputs"].w2c, entry["inputs"].ndc, pts[idx],
             targets[idx])
    every = TRAIN_BATCH // TRAIN_CHECK_BATCH          # a balanced batch stays balanced
    batch = {"cuda": timed[:3] + (timed[3][::every], timed[4][::every])}
    batch["cpu"] = tuple(t.to("cpu", torch.float64) if t.is_floating_point() else t.cpu()
                         for t in batch["cuda"])
    states, out = {}, {}
    for where, device, dtype in (("cuda", dev, torch.float32),
                                 ("cpu", torch.device("cpu"), torch.float64)):
        model = TRAIN_NETS[kind](num_views=MVS_VIEWS).to(device, dtype)
        states[where] = create_state(model, torch.Generator().manual_seed(0), TRAIN_LR,
                                     TRAIN_STEPS)
        t = time.perf_counter()
        loss, grads = loss_and_grads(states[where], *batch[where])
        states[where].opt.step(grads)
        if where == "cuda":
            torch.cuda.synchronize(dev)
        out[where] = dict(loss=float(loss), grads=[g.double().cpu() for g in grads],
                          seconds=time.perf_counter() - t,
                          state={k: v.double().cpu() for k, v in
                                 states[where].model.state_dict().items()})
    card, host = out["cuda"], out["cpu"]
    loss_err = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    g_card, g_host = (torch.cat([g.flatten() for g in o["grads"]]) for o in (card, host))
    grad_err = float(torch.linalg.norm(g_card - g_host) / torch.linalg.norm(g_host))
    stats_err = max(float((card["state"][k] - host["state"][k]).abs().max())
                    for k in host["state"] if k.endswith(("running_mean", "running_var")))
    names = set(states["cpu"].param_names())
    close = total = 0
    for k in names:
        d = (card["state"][k] - host["state"][k]).abs()
        close += int((d <= 1e-6).sum())
        total += d.numel()
    log(f"11a {kind}: a training step of {TRAIN_CHECK_BATCH} points on {MVS_VIEWS} views of "
        f"{MVS_TRAIN_RENDER_SIZE[0]}x{MVS_TRAIN_RENDER_SIZE[1]}, card against CPU from the "
        f"same state (the CPU in float64): loss {card['loss']:.7f} vs {host['loss']:.7f} "
        f"(rel err {loss_err:.3g}), "
        f"gradients within {grad_err:.3g} of their norm, BatchNorm running stats within "
        f"{stats_err:.3g}, parameters after one Adam step within 1e-6 on "
        f"{close / total * 100:.4f}% of {total} elements (CPU float64 step "
        f"{host['seconds']:.2f} s)")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3 and stats_err <= 1e-4
            and close >= 0.98 * total):
        raise AssertionError(f"11a {kind}: the card's training step disagrees with the CPU's")

    state = states["cuda"]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_time_ms(lambda: train_step(state, *timed), iters=TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    busy = device_profile(lambda: train_step(state, *timed),
                          f"one {kind} training step", top=12)
    log(f"11b {kind}: {ms:.3f} ms a steady step (CUDA events over {TRAIN_TIMED_STEPS}), "
        f"busy share {busy:.4f}, peak device memory {peak / 2**30:.3f} GiB")
    return dict(loss_err=loss_err, grad_err=grad_err, stats_err=stats_err,
                params_close=close / total, ms=ms, busy=busy, peak_bytes=peak)


def phase_train(dev: torch.device) -> dict:
    """Phase 11: the MVS nets' training at full width (OccAttn and OriAttn,
    16 views) on their training family: 11a/11b per net, then 11c the
    train_mvs CLI on TRAIN_CASES cases, --resume, and its occ.npz through
    infer_inner's load_net and deep_mvs_eval."""
    exact_f32()
    torch.cuda.empty_cache()
    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t = time.perf_counter()
        calib = write_train_cases(tmp, dev)
        log(f"11: {TRAIN_CASES} training cases written in {time.perf_counter() - t:.2f} s")
        data = os.path.join(tmp, "data")
        for kind in TRAIN_NETS:
            store = train_cli.CaseStore(data, calib, kind, 0.1, device=dev)
            entry = store.get(store.cases[0])
            with Phase(f"11a/11b {kind}"):
                result[kind] = train_card_against_cpu(kind, entry, dev)
            del store, entry
        torch.cuda.empty_cache()
        with Phase("11c train_mvs CLI"):
            pk.reset_launch_counts()
            result["cli"] = train_cli_run(tmp, calib, dev, result["occ"]["ms"])
            result["launches"] = dict(pk.LAUNCHES)
    return result


def train_cli_run(tmp: str, calib: str, dev: torch.device, step_ms: float) -> dict:
    """11c: python -m monohair_tpu_torch.train_mvs's main on the cases, for
    TRAIN_STEPS steps or the multiple of TRAIN_EVAL_EVERY that fits
    TRAIN_BUDGET_S at 11b's step time (at least two evaluations); then
    --resume for one evaluation more. Gates: stats_occ.txt's 6 finite columns
    and its rows, the mean loss of the last 50 steps below the first 50's, the
    written occ.npz and load_net's net equal to the resumed run's final state,
    and that net's F1 on 4096 val points through deep_mvs_eval at least
    TRAIN_MIN_F1."""
    steps = min(TRAIN_STEPS, int(TRAIN_BUDGET_S * 1e3 / step_ms))
    steps = max(steps // TRAIN_EVAL_EVERY, 2) * TRAIN_EVAL_EVERY
    out = os.path.join(tmp, "ckpt")
    argv = [f"--data_root={os.path.join(tmp, 'data')}", f"--calib={calib}", "--kind=occ",
            f"--batch={TRAIN_BATCH}", f"--lr={TRAIN_LR}", f"--eval_every={TRAIN_EVAL_EVERY}",
            f"--out={out}", f"--max_cached_cases={TRAIN_CASES}", f"--device={dev.type}"]
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    run = train_cli.main(argv + [f"--steps={steps}"])
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    losses = np.asarray(run["losses"])
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    stats = np.loadtxt(os.path.join(out, "stats_occ.txt"), ndmin=2)
    rows = len(stats)
    resumed = train_cli.main(argv + [f"--steps={steps + TRAIN_EVAL_EVERY}", "--resume"])
    stats = np.loadtxt(os.path.join(out, "stats_occ.txt"), ndmin=2)
    log(f"11c: train_mvs on {TRAIN_CASES} cases: {steps} steps of {TRAIN_BATCH} points in "
        f"{run['seconds']:.2f} s of training loop ({len(losses) / run['seconds']:.3f} steps/s; "
        f"{wall:.2f} s with the case loads), peak device memory {peak / 2**30:.3f} GiB; "
        f"mean loss of the first 50 steps {first:.5f}, of the last 50 {last:.5f}; "
        f"--resume from step {resumed['start']} for {len(resumed['losses'])} steps; "
        f"stats_occ.txt rows {rows} -> {len(stats)}, the last "
        f"{' '.join(f'{x:.4f}' for x in stats[-1])}")
    if (stats.shape[1] != 6 or not np.isfinite(stats).all() or rows != steps // TRAIN_EVAL_EVERY
            or len(stats) != rows + 1 or resumed["start"] != steps):
        raise AssertionError(f"11c: stats_occ.txt {stats.shape}, rows {rows}, resumed at "
                             f"{resumed['start']}")
    if not last < first:
        raise AssertionError(f"11c: the loss did not fall: {first} -> {last}")
    net = load_net(Config({"mvs": {"occ_model_path": os.path.join(out, "occ.npz")}}), "occ",
                   MVS_VIEWS, dev)
    trained = resumed["state"].model.state_dict()
    loaded = net.state_dict()
    with np.load(os.path.join(out, "occ.npz")) as saved:
        stale = [k for k in trained
                 if not (k in saved and k in loaded
                         and np.array_equal(saved[k], trained[k].cpu().numpy())
                         and torch.equal(loaded[k].cpu(), trained[k].cpu()))]
        extra = set(saved.files) ^ set(trained)
    if stale or extra or set(loaded) != set(trained):
        raise AssertionError(f"11c: occ.npz or load_net's net is not the resumed run's final "
                             f"state: {len(stale)} tensors differ ({stale[:4]}), keys "
                             f"{sorted(extra)[:4]}")
    entry = train_cli.CaseStore(os.path.join(tmp, "data"), calib, "occ", 0.1,
                                device=dev).get("case000")
    pts, labels = entry["val"]
    pts, labels = pts[:TRAIN_BATCH], labels[:TRAIN_BATCH]
    _, orients, occ = deep_mvs_eval(entry["inputs"], net, load_net(MVS_CFG, "ori", MVS_VIEWS, dev),
                                    query_points=pts, batch=TRAIN_BATCH)
    p, r, f1 = precision_recall(occ > 0.5, labels > 0)
    log(f"11c: the written occ.npz equals the resumed run's final state in all "
        f"{len(trained)} tensors, and load_net's net holds it; through deep_mvs_eval on "
        f"{len(pts)} val points of case000: {occ.mean() * 100:.2f}% occupied, precision "
        f"{p:.4f}, recall {r:.4f}, F1 {f1:.4f} (labels {(labels > 0).mean() * 100:.2f}% "
        f"occupied; floor {TRAIN_MIN_F1})")
    if occ.shape != (len(pts),) or not np.isfinite(orients).all():
        raise AssertionError("11c: the trained net's outputs are wrong")
    if not f1 >= TRAIN_MIN_F1:
        raise AssertionError(f"11c: the trained net's val F1 {f1:.4f} < {TRAIN_MIN_F1}")
    return dict(steps=steps, seconds=run["seconds"], steps_per_s=len(losses) / run["seconds"],
                wall=wall, peak_bytes=peak, loss_first=first, loss_last=last,
                last_row=stats[-1].tolist(), precision=p, recall=r, f1=f1)


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

PIPELINE_STAGES = ("prepare_data", "pmvo", "infer_inner", "hair_grow")
PREPARE_STEPS = ("select_images", "process_camera", "run_ngp", "fit_bust", "process_bust",
                 "render_depth", "process_imgs")


def check_stage_metrics(output_path: str) -> dict:
    """metrics.jsonl holds stage/<name>/seconds for the four stages, in order."""
    with open(os.path.join(output_path, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    names = [line["name"] for line in lines]
    if names != [f"stage/{s}/seconds" for s in PIPELINE_STAGES]:
        raise AssertionError(f"metrics.jsonl holds {names}")
    return {line["name"].split("/")[1]: line["value"] for line in lines}


def phase_pipeline(dev: torch.device, margin: float) -> dict:
    """Phase 12: python -m monohair_tpu_torch.run_pipeline's main on the card
    on a fresh 16-view synthwig case (phase 7d's: the shipped nets at 7d's
    median margin, the depth maps at camera depth 1.08 from the start, here
    for PMVO too), prepare_data's steps off, under phase 7d's gates and the
    synthwig strand checks on full/connected_strands.hair; it must launch
    every kernel. (The capture case runs whole in phase 16, and through
    prepare_data in 13d.)"""
    exact_f32()
    torch.cuda.empty_cache()
    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as tmp:
        cfg = write_synthwig_case(tmp, num_views=MVS_VIEWS)
        cfg["prepare_data"] = dict.fromkeys(PREPARE_STEPS, False)
        cfg.PMVO["infer_inner"] = True
        cfg.mvs.update(occ_model_path=MVS_WEIGHTS["occ"], ori_model_path=MVS_WEIGHTS["ori"],
                       eval_vsize=EVAL_VSIZE, occ_logit_margin=margin)
        cfg.infer_inner["render_size"] = list(RENDER_SIZE)
        case = os.path.join(tmp, "synthwig")
        depth_dir = os.path.join(case, "render_depth")
        for name in os.listdir(depth_dir):
            shape = np.load(os.path.join(depth_dir, name)).shape
            np.save(os.path.join(depth_dir, name), np.full(shape, 1.08 / 2 * 255, np.float32))
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        pk.reset_launch_counts()
        t = time.perf_counter()
        steps = pipeline_cli.main(["--yaml=" + os.path.join(tmp, "case"),
                                   f"--device={dev.type}"])
        wall = time.perf_counter() - t
        launches = dict(pk.LAUNCHES)
        seconds = check_stage_metrics(os.path.join(case, "output", "verify"))
        flat = {k: v for stage in steps.values() for k, v in stage.items()}
        checked = check_fused_case(case, dev.type, launches, flat)
        checked["hair"] = check_hair_outputs(os.path.join(case, "output", "verify", "full"))
        log(f"12a run_pipeline on synthwig: {wall:.2f} s, stage seconds {seconds}")
        result["synthwig"] = dict(wall=wall, seconds=seconds, steps=steps, **checked)
    result["launches"] = dict(pk.LAUNCHES)
    return result


# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------

CODEC_SIZES = ((1080, 1920), (720, 1280))     # (H, W): a 1080p and a 720p frame
# quality-100 round trips of the capture frames: a gray map (best_ori/ is one)
# within 2 levels (each DCT coefficient moves by at most half its divisor of
# 8); the RGB frame at cv2's 4:2:0 within 0.5 on average, its colour edges
# within 32 (the chroma is stored at half resolution)
CODEC_GRAY_MAX_ERR, CODEC_RGB_MEAN_ERR, CODEC_RGB_MAX_ERR = 2, 0.5, 32
BF16_MIN_COS = 0.99                            # tests/test_pmvo.py:141-148's bound
JPEG_QUALITY_MAPS = {"best_ori": 100, "Ori": 100, "conf": 95}   # prepare_data_stage.py


def phase_codec() -> dict:
    """13a: the JPEG codec on the host, on capture frames of the analytic head
    at 1920x1080 and 1280x720: ms a frame to encode (quality 95, 4:2:0) and to
    decode (RGB and gray), the quality-100 round trips, and restart intervals
    (a file with an RSTn marker every 8 MCUs decodes to the file without)."""
    from monohair_tpu_torch.synthetic import CAPTURE_FOV_Y, capture_orbit_pose, capture_render_view
    out = {}
    for H, W in CODEC_SIZES:
        f_pix = (H / 2) / math.tan(math.radians(CAPTURE_FOV_Y) / 2)
        img, _, _ = capture_render_view(capture_orbit_pose(0.3, elev=0.12), f_pix, H, W)
        rgb = (img * 255).astype(np.uint8)
        gray = rgb.mean(-1).astype(np.uint8)
        data = jpeg_io.encode_jpeg(rgb, 95)

        def per_frame(fn, reps=5):
            fn()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) / reps * 1e3

        enc_ms = per_frame(lambda: jpeg_io.encode_jpeg(rgb, 95))
        dec_ms = per_frame(lambda: jpeg_io.decode_jpeg(data))
        dec_gray_ms = per_frame(lambda: jpeg_io.decode_jpeg(data, gray=True))
        rgb_err = np.abs(jpeg_io.decode_jpeg(jpeg_io.encode_jpeg(rgb, 100)).astype(int) - rgb)
        gray_err = np.abs(jpeg_io.decode_jpeg(jpeg_io.encode_jpeg(gray, 100), gray=True)
                          .astype(int) - gray)
        rst = jpeg_io.encode_jpeg(rgb, 95, restart_interval=8)
        rst_equal = b"\xff\xdd" in rst and np.array_equal(jpeg_io.decode_jpeg(rst),
                                                           jpeg_io.decode_jpeg(data))
        res = dict(encode_ms=enc_ms, decode_ms=dec_ms, decode_gray_ms=dec_gray_ms,
                   bytes_q95=len(data), q100_gray_max=int(gray_err.max()),
                   q100_rgb_mean=float(rgb_err.mean()), q100_rgb_max=int(rgb_err.max()),
                   restart_equal=bool(rst_equal))
        log(f"13a JPEG codec at {W}x{H}: encode (q95, 4:2:0) {enc_ms:.3f} ms, decode "
            f"{dec_ms:.3f} ms (gray {dec_gray_ms:.3f} ms) a frame, {len(data)} bytes; q100 "
            f"round trip gray max err {res['q100_gray_max']}, RGB mean err "
            f"{res['q100_rgb_mean']:.4f} max {res['q100_rgb_max']}; RST every 8 MCUs "
            f"decodes equal: {rst_equal}")
        if (res["q100_gray_max"] > CODEC_GRAY_MAX_ERR or res["q100_rgb_mean"] > CODEC_RGB_MEAN_ERR
                or res["q100_rgb_max"] > CODEC_RGB_MAX_ERR or not rst_equal):
            raise AssertionError(f"13a: the JPEG codec at {W}x{H} is out of bounds: {res}")
        out[f"{W}x{H}"] = res
    return out


def line_search(maps, points: np.ndarray, dev: torch.device,
                surface: Optional[np.ndarray] = None) -> dict:
    """filter_raw_points + optimize_points on `maps`, the line search over
    `surface` (this filter's surface points when None): seconds, points/s,
    peak memory, launches."""
    pk.reset_launch_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    surf, _ = filter_raw_points(maps, points, PATCH, CONF_THR, VIS_THR)
    filter_s = time.perf_counter() - t
    surface = surf if surface is None else surface
    t = time.perf_counter()
    pts, ori, loss, _ = optimize_points(maps, points[surface], PATCH, CONF_THR)
    torch.cuda.synchronize(dev)
    optimize_s = time.perf_counter() - t
    return dict(surface=surf, ori=ori, loss=loss, filter_s=filter_s, optimize_s=optimize_s,
                points_per_s=int(surface.sum()) / optimize_s,
                peak_bytes=torch.cuda.max_memory_allocated(dev), launches=dict(pk.LAUNCHES))


def phase_bf16_and_mesh(dev: torch.device) -> dict:
    """13b: PMVO.bf16_maps at phase 5's width (16 views of 1920x1080, patch 7,
    the same shell points): the line search with f32 maps, then with the same
    maps in bf16 (the f32 maps freed first), on the f32 run's surface points;
    median |cos| between the two runs' orientations (> BF16_MIN_COS), peak
    memory, points/s, the bf16 gather's launches. 13c: the first two chunks of
    the f32 line search on the mesh (cuda:0, cuda:0) against the unsharded
    run, bit for bit."""
    exact_f32()
    torch.cuda.empty_cache()
    maps, points = head_scene(dev, FULL_WIDTH_POINTS, 1920, 1080, 16)
    f32 = line_search(maps, points, dev)
    surface = f32["surface"]
    # 13c on the f32 maps
    first = points[surface][:2 * auto_chunk(16)]
    one = optimize_points(maps, first, PATCH, CONF_THR)
    pk.reset_launch_counts()
    two = optimize_points(maps, first, PATCH, CONF_THR, mesh=(dev, dev))
    mesh_launches = dict(pk.LAUNCHES)
    mesh_equal = all(np.array_equal(a, b) for a, b in zip(one, two))
    log(f"13c the first two chunks ({len(first)} points) on the mesh ({dev}, {dev}): "
        f"equal to the unsharded run bit for bit: {mesh_equal}; launches {mesh_launches}")
    if not mesh_equal:
        diff = [int((a != b).sum()) for a, b in zip(one, two)]
        raise AssertionError(f"13c: the sharded line search differs: {diff} elements")
    maps16 = maps.astype(torch.bfloat16)
    del maps
    torch.cuda.empty_cache()
    bf16 = line_search(maps16, points, dev, surface)
    del maps16
    torch.cuda.empty_cache()
    cos = np.abs(np.sum(f32["ori"] * bf16["ori"], -1))
    median_cos = float(np.median(cos))
    same_surface = float((bf16["surface"] == surface).mean())
    for name, r in (("f32", f32), ("bf16", bf16)):
        log(f"13b {name} maps: filter {r['filter_s']:.3f} s, line search {r['optimize_s']:.3f} s "
            f"on {int(surface.sum())} points ({r['points_per_s']:.1f} points/s), peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB, launches {r['launches']}")
    log(f"13b bf16 against f32: median |cos| {median_cos:.6f} (gate > {BF16_MIN_COS}), "
        f"|cos| > 0.999 on {float((cos > 0.999).mean()):.4f}; the filter keeps the same "
        f"class on {same_surface:.6f} of the raw points")
    if median_cos <= BF16_MIN_COS or not np.isfinite(bf16["loss"]).all():
        raise AssertionError(f"13b: bf16 maps moved the orientations: median |cos| {median_cos}")
    if unlaunched(bf16["launches"], BF16_PATH_KERNELS) or bf16["launches"]["patch_gather"]:
        raise AssertionError(f"13b: the bf16 path's launches {bf16['launches']}")
    strip = ("surface", "ori", "loss")
    return dict(f32={k: v for k, v in f32.items() if k not in strip},
                bf16={k: v for k, v in bf16.items() if k not in strip},
                median_cos=median_cos, same_surface=same_surface, mesh_equal=mesh_equal,
                launches=bf16["launches"])


def is_jpeg_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\xff\xd8"


def host_jpeg_seconds(case: str) -> dict:
    """13d: the host's JPEG work of process_imgs, timed again on this case's
    files: decoding each capture frame twice (RGB and gray, once a step) and
    encoding the six maps a frame at the stage's qualities."""
    files = sorted(os.listdir(os.path.join(case, "capture_images")))
    t = time.perf_counter()
    for f in files:
        jpeg_io.read_jpeg(os.path.join(case, "capture_images", f))
        jpeg_io.read_jpeg(os.path.join(case, "capture_images", f), gray=True)
    decode = time.perf_counter() - t
    maps = [(jpeg_io.read_jpeg(os.path.join(case, sub, f), gray=sub != "Ori"
                               and sub != "mask_hair"), JPEG_QUALITY_MAPS.get(sub, 95))
            for f in files for sub in ("hair_mask", "mask", "mask_hair", "best_ori", "conf", "Ori")]
    t = time.perf_counter()
    for img, q in maps:
        jpeg_io.encode_jpeg(img, q)
    return dict(decode_s=decode, encode_s=time.perf_counter() - t)


def phase_jpeg_capture(dev: torch.device) -> dict:
    """13d: phase 8's scene (32 frames at 1280x720, frame_interval 2) with its
    frames written as .JPG at quality 95 by the port's encoder, through
    run_pipeline (run_ngp and fit_bust off, the case's head sphere as the
    coarse mesh) to full/connected_strands.hair; gated on
    best_ori/, conf/, Ori/ and render_depth/<view>.JPG written as JPEG, the
    hair masks against the labels (mean IoU >= 0.7, phase 8's gate) and a
    non-empty strand file."""
    exact_f32()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_") as tmp:
        written = write_capture_case(tmp, "cap", CAPTURE_FRAMES, *CAPTURE_SIZE,
                                     frame_interval=CAPTURE_INTERVAL, ext=".JPG",
                                     modnet=SEGMENT_WEIGHTS["modnet"],
                                     parser=SEGMENT_WEIGHTS["bisenet"])
        cfg = written["config"]
        cfg.PMVO["infer_inner"] = True
        cfg.infer_inner["render_size"] = [96, 64]
        cfg.mvs["eval_vsize"] = 0.02
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        flags = ["--yaml=" + os.path.join(tmp, "case"), f"--device={dev.type}",
                 "--prepare_data.run_ngp=", "--prepare_data.fit_bust="]
        case = os.path.join(tmp, "cap")
        out = os.path.join(case, "output", "capture")
        t = time.perf_counter()
        steps = pipeline_cli.main(flags)
        wall = time.perf_counter() - t
        seconds = check_stage_metrics(out)
        kept = sorted(os.listdir(os.path.join(case, "capture_images")))
        names = [k[:-4] for k in kept]
        written_as_jpeg = all(
            k.endswith(".JPG") and is_jpeg_file(os.path.join(case, sub, k))
            for k in kept for sub in ("capture_images", "best_ori", "conf", "Ori")) and all(
            is_jpeg_file(os.path.join(case, "render_depth", n + ".JPG")) for n in names)
        hair_iou = [iou(imread_gray(os.path.join(case, "hair_mask", k)) > 127,
                        read_png(os.path.join(case, "labels", "hair", n + ".png")) > 127)
                    for k, n in zip(kept, names)]
        segments, points = load_hair(os.path.join(out, "full", "connected_strands.hair"))
        surface = np.load(os.path.join(out, "optimize", "surface.npy"))
        codec = host_jpeg_seconds(case)
    imgs_s = steps["prepare_data"]["calculate_masks"] + steps["prepare_data"]["process_images"]
    share = (codec["decode_s"] + codec["encode_s"]) / imgs_s
    log(f"13d run_pipeline on the JPEG capture case ({len(kept)} frames kept of "
        f"{CAPTURE_FRAMES} at {CAPTURE_SIZE[1]}x{CAPTURE_SIZE[0]}): {wall:.2f} s, stage "
        f"seconds {seconds}; prepare_data steps "
        f"{json.dumps({k: round(v, 4) for k, v in steps['prepare_data'].items()})}; "
        f"written as JPEG: {written_as_jpeg}; hair IoU with the labels mean "
        f"{np.mean(hair_iou):.6f}; PMVO kept {len(surface)} surface points; "
        f"{len(segments)} strands, {len(points)} points")
    log(f"13d host JPEG work of process_imgs: decode {codec['decode_s']:.3f} s, encode "
        f"{codec['encode_s']:.3f} s of {imgs_s:.3f} s (share {share:.3f})")
    if not written_as_jpeg:
        raise AssertionError("13d: best_ori/, conf/, Ori/ or render_depth/ not JPEG")
    if np.mean(hair_iou) < 0.7:
        raise AssertionError(f"13d: hair_mask/ against the labels: IoU {np.mean(hair_iou)}")
    if len(segments) == 0 or not np.isfinite(points).all():
        raise AssertionError("13d: the JPEG capture case grew no strands")
    return dict(wall=wall, seconds=seconds, steps=steps, surface=len(surface),
                strands=len(segments), hair_iou=float(np.mean(hair_iou)), codec=codec,
                codec_share=share)


# ---------------------------------------------------------------------------
# phase 14: video
# ---------------------------------------------------------------------------

VIDEO_CODEC_FRAMES = 12          # 14a: an I-VOP and 11 P-VOPs at the writer's GOP of 12
VIDEO_FRAMES = 30                # 14b: 1 s at 30 fps
VIDEO_FPS = 30
VIDEO_INTERVAL = 5               # extract_sharpest_frames's default
VIDEO_BLUR = 9                   # the box blur of the frames that are not sharp
VIDEO_MIN_PSNR = 30.0            # the codec's round trip on the scene at qscale 3
H264_QP = 24                     # 14d: the H.264 test-stream writer's fixed quantiser
H264_FRAMES = 20                 # 14d: the first 20 of 14b's frames (one sharp in 5)
H264_B = dict(bframes=2, pyramid=1, bipred_idc=2, refs=3, gop=12)  # 14d's I/P/B stream
HEVC_QP = 24                     # 14e: the HEVC test-stream writer's fixed quantiser
HEVC_CTB = 64                    # 14e: CTBs of 64 (1080 rows end in a partial one)
HEVC_FRAMES = 20                 # 14e: the first 20 of 14b's frames at 1920x1080
HEVC_FRAMES_720 = 10             # 14e: 14d's first 10 at 1280x720, for the decode time
# 14e's I/P/B stream: x265's default GOP shape (bframes 4, b-pyramid, ref 3,
# open GOP), keyint cut from 250 to 12 so that 20 frames hold a CRA picture
HEVC_B = dict(bframes=4, pyramid=1, refs=3, gop=12, cra=1, wpp=1)
HEVC_B_SLOWDOWN = 4.0            # 14e: the I/P/B decode's ms a frame over the I/P one's, at most
# 14e's tiles stream: I/P in 4x3 uniform tiles (8 or 7 CTBs of 64 wide, 5 or
# 6 high) without loop filtering across their edges, in about 24 slice
# segments a picture, half of them dependent, on the first 10 of 14b's frames
HEVC_TILES = dict(tiles=1, tile_cols=4, tile_rows=3, uniform=1, lf_across_tiles=0, slices=24,
                  dependent=0.5)
HEVC_TILES_FRAMES = 10
# 14e's Main 10 stream: HEVC_B's shape at 10 bits (the writer scales the
# frames up, with detail in the lowest bit), on the first 10 of 14b's frames
HEVC_MAIN10 = dict(HEVC_B, bit_depth=10)
HEVC_MAIN10_FRAMES = 10
# 14e's HDR stream, an iPhone's default recording: Main 10 in HEVC_B's shape
# with the BT.2020 matrix and primaries and HLG (9/9/18), the alternative
# transfer characteristics SEI naming HLG, and Dolby Vision 8.4's RPU units
# and dvvC box; 5 frames of 1920x1080 made from a numpy seed (hlg_frames)
HEVC_HLG = dict(HEVC_B, bit_depth=10, matrix=9, primaries=9, transfer=18, atc_sei=18, dv_rpu=1,
                dvcc=8)
HLG_FRAMES = 5
HLG_SEED = 2022
# SHA-256 of the HDR stream's bytes (the writer) and of its decoded frames
# (the decoder: the frames cv2 returns, held to cv2 on the CPU at the size
# they were taken), and of the 3D LUT the decoder converts it through
# (video_io.colour_lut(True, True), BT.2020 and HLG: each node held to
# swscale's when taken; built with every libm function the LUTs call)
HLG_STREAM_SHA256 = "0a6a77acbbb96f7ddb5a4659b2d15b0b82c1d4b61a28a4fdadb3111b080dda53"
HLG_DECODED_SHA256 = "2db4912c56531fbb15bf6178808e94d2a16939c606cbde5cf4a304a6b836b8a6"
HLG_LUT_SHA256 = "be9edc8cf25d2e306551795d217346948dc2f0bd328e40c99b0fb6f003b3aa6a"
FLY_SIZE = (720, 1280)           # render_camera_path_video's default (H, W)
FLY_POSES = 3
FLY_FRAMES_PER_SEG = 2
SHARPNESS_RTOL = 1e-9            # the card's float64 Laplacian against numpy's


def orbit_frames(H: int, W: int, n: int, span: float = 0.6) -> list:
    """n BGR uint8 frames of phase 8's scene along an orbit arc of `span`
    radians, rendered on the host's cores."""
    from concurrent.futures import ThreadPoolExecutor
    from monohair_tpu_torch.synthetic import CAPTURE_FOV_Y, capture_orbit_pose, capture_render_view
    f_pix = (H / 2) / math.tan(math.radians(CAPTURE_FOV_Y) / 2)

    def render(k):
        img, _, _ = capture_render_view(capture_orbit_pose(0.3 + span * k / n, elev=0.12),
                                        f_pix, H, W)
        return np.ascontiguousarray((img[..., ::-1] * 255).astype(np.uint8))

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        return list(pool.map(render, range(n)))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def video_psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10.0 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def write_video(path: str, frames: list, fps: float) -> float:
    """Seconds to write `frames` with the port's writer (default settings)."""
    t = time.perf_counter()
    with video_io.VideoWriter(path, fps, (frames[0].shape[1], frames[0].shape[0])) as w:
        for f in frames:
            w.write(f)
    return time.perf_counter() - t


def phase_video_codec(tmp: str) -> dict:
    """14a: encode and decode ms a frame, the round trip's PSNR, the P-VOPs."""
    out = {}
    for H, W in CODEC_SIZES:
        frames = orbit_frames(H, W, VIDEO_CODEC_FRAMES, span=0.1)
        path = os.path.join(tmp, f"codec_{W}x{H}.mp4")
        enc_s = write_video(path, frames, VIDEO_FPS)
        t = time.perf_counter()
        with video_io.VideoReader(path) as reader:
            decoded = list(reader)
            stats = reader.stats
        dec_s = time.perf_counter() - t
        info = video_io.video_info(path)
        psnrs = [video_psnr(a, b) for a, b in zip(decoded, frames)]
        res = dict(encode_ms=enc_s / len(frames) * 1e3, decode_ms=dec_s / len(frames) * 1e3,
                   min_psnr=min(psnrs), bytes=os.path.getsize(path), i_vops=stats["i_vops"],
                   p_vops=stats["p_vops"], half_pel_vectors=stats["half_pel_vectors"])
        log(f"14a mp4v at {W}x{H}: encode {res['encode_ms']:.3f} ms, decode "
            f"{res['decode_ms']:.3f} ms a frame ({len(frames)} frames: {res['i_vops']} I-VOP, "
            f"{res['p_vops']} P-VOPs, {res['half_pel_vectors']} half-pel vector components); "
            f"{res['bytes']} bytes; round trip PSNR min {res['min_psnr']:.2f} dB")
        if info != (len(frames), float(VIDEO_FPS), W, H) or len(decoded) != len(frames):
            raise AssertionError(f"14a: {path} reads back as {info}, {len(decoded)} frames")
        if res["min_psnr"] < VIDEO_MIN_PSNR or res["p_vops"] == 0:
            raise AssertionError(f"14a: the mp4v round trip at {W}x{H}: {res}")
        out[f"{W}x{H}"] = res
    return out


def phase_video_extract(dev: torch.device, tmp: str) -> dict:
    """14b: a 1920x1080 orbit video, one sharp frame in every VIDEO_INTERVAL,
    through extract_sharpest_frames on the card."""
    H, W = CODEC_SIZES[0]
    frames, sharp = sharp_orbit_frames(dev, H, W)
    video = os.path.join(tmp, "orbit.mp4")
    enc_s = write_video(video, frames, VIDEO_FPS)
    out_dir = os.path.join(tmp, "frames")
    sync(dev)
    t = time.perf_counter()
    kept = extract_sharpest_frames(video, out_dir, interval=VIDEO_INTERVAL, device=dev)
    sync(dev)
    seconds = time.perf_counter() - t
    decoded = list(video_io.read_video(video))
    host = [sharpness_rgb_f64(f[..., ::-1]) for f in decoded]
    worst = 0.0
    for k, name in enumerate(kept):
        window = host[k * VIDEO_INTERVAL:(k + 1) * VIDEO_INTERVAL]
        want = k * VIDEO_INTERVAL + int(np.argmax(window))
        if want != sharp[k]:
            raise AssertionError(f"14b: window {k}: the sharpest decoded frame is {want}, "
                                 f"the sharp one {sharp[k]} (host sharpness {window})")
        rgb = read_png(os.path.join(out_dir, name))
        if not np.array_equal(rgb, decoded[sharp[k]][..., ::-1]):
            raise AssertionError(f"14b: {name} is not frame {sharp[k]}")
        card = float(laplacian_variance(bgr_to_gray(torch.as_tensor(decoded[sharp[k]],
                                                                    device=dev))))
        worst = max(worst, abs(card - host[sharp[k]]) / host[sharp[k]])
    if len(kept) != len(sharp) or worst > SHARPNESS_RTOL:
        raise AssertionError(f"14b: kept {len(kept)} of {len(sharp)} frames, the card's "
                             f"sharpness within {worst:.3e} of the host's")
    blurred = [host[i] for i in range(VIDEO_FRAMES) if i not in sharp]
    res = dict(seconds=seconds, frames_per_s=VIDEO_FRAMES / seconds, encode_s=enc_s,
               bytes=os.path.getsize(video), kept=len(kept), sharpness_rel_err=worst,
               sharp_min=min(host[i] for i in sharp), blurred_max=max(blurred), frames=frames)
    log(f"14b extract_sharpest_frames on a {VIDEO_FRAMES}-frame {W}x{H} video "
        f"({res['bytes']} bytes, written in {enc_s:.3f} s): {seconds:.3f} s, "
        f"{res['frames_per_s']:.2f} frames/s; kept {len(kept)}, all the sharp ones; "
        f"card vs float64 host sharpness {worst:.3e}; sharpness sharp >= "
        f"{res['sharp_min']:.2f}, blurred <= {res['blurred_max']:.2f}")
    return res


def sharp_orbit_frames(dev: torch.device, H: int, W: int, n: int = VIDEO_FRAMES) -> tuple:
    """n orbit frames at H x W, all but one in every VIDEO_INTERVAL
    box-blurred on the card, and the sharp ones' indices."""
    frames = orbit_frames(H, W, n)
    sharp = sharp_indices(n)
    pool = torch.nn.AvgPool2d(VIDEO_BLUR, stride=1, padding=VIDEO_BLUR // 2,
                              count_include_pad=False)
    for i in range(n):
        if i not in sharp:
            x = torch.as_tensor(frames[i], device=dev).permute(2, 0, 1).float()
            frames[i] = pool(x[None])[0].round().byte().permute(1, 2, 0).cpu().numpy()
    return frames, sharp


def sharp_indices(n: int) -> list:
    """The sharp frame of each whole VIDEO_INTERVAL window of n frames."""
    return [k * VIDEO_INTERVAL + k % VIDEO_INTERVAL for k in range(n // VIDEO_INTERVAL)]


def rotate_display_matrix(src: str, dst: str) -> None:
    """A copy of src whose track matrix turns it 90 degrees clockwise, as a
    phone held upright writes it (cv2 then hands over portrait frames)."""
    data = bytearray(open(src, "rb").read())
    tkhd = data.index(b"tkhd") + 4
    off = tkhd + (52 if data[tkhd] == 1 else 40)
    data[off:off + 36] = b"".join(v.to_bytes(4, "big", signed=True)
                                  for v in [0, 65536, 0, -65536, 0, 0, 0, 0, 1 << 30])
    with open(dst, "wb") as f:
        f.write(bytes(data))


def check_kept(decoded: list, out_dir: str, kept: list, sharp: list, turn: bool,
               what: str) -> None:
    """The kept frames of extract_sharpest_frames are the sharp ones: each
    window's sharpest decoded frame (float64 host Laplacian) is the sharp
    frame, and each kept PNG holds it, turned 90 degrees clockwise (cv2's
    rotation) when the file's display matrix says so. `decoded` are the
    frames as coded (unturned)."""
    host = [sharpness_rgb_f64(f[..., ::-1]) for f in decoded]
    if len(kept) != len(sharp):
        raise AssertionError(f"{what}: kept {len(kept)} of {len(sharp)} frames")
    for k, name in enumerate(kept):
        want = k * VIDEO_INTERVAL + int(np.argmax(host[k * VIDEO_INTERVAL:(k + 1) * VIDEO_INTERVAL]))
        if want != sharp[k]:
            raise AssertionError(f"{what}: window {k}: the sharpest decoded frame is {want}, "
                                 f"the sharp one {sharp[k]}")
        frame = decoded[sharp[k]][..., ::-1]
        if turn:
            frame = np.rot90(frame, -1)
        if not np.array_equal(read_png(os.path.join(out_dir, name)), frame):
            raise AssertionError(f"{what}: {name} is not decoded frame {sharp[k]}"
                                 f"{' turned clockwise' if turn else ''}")


def phase_video_h264(dev: torch.device, tmp: str, frames_first: list) -> dict:
    """14d: H.264 at CODEC_SIZES (the first H264_FRAMES of 14b's frames at the
    first) through the port's decoder, the extraction on the card, and a
    portrait copy of the first. Leaves the other size's frames in
    out["frames"] for 14e."""
    sharp = sharp_indices(H264_FRAMES)
    out = {}
    for H, W in CODEC_SIZES:
        first = (H, W) == CODEC_SIZES[0]
        frames = frames_first[:H264_FRAMES] if first else sharp_orbit_frames(dev, H, W,
                                                                             H264_FRAMES)[0]
        if not first:
            out["frames"] = frames
        path = os.path.join(tmp, f"h264_{W}x{H}.mp4")
        t = time.perf_counter()
        h264_streams.write_frames(path, frames, fps=VIDEO_FPS, qp=H264_QP, gop=2, cabac=True)
        enc_s = time.perf_counter() - t
        t = time.perf_counter()
        with video_io.VideoReader(path) as reader:
            decoded = list(reader)
            stats = reader.stats
        dec_s = time.perf_counter() - t
        info = video_io.video_info(path)
        psnrs = [video_psnr(a, b) for a, b in zip(decoded, frames)]
        out_dir = os.path.join(tmp, f"h264_frames_{W}x{H}")
        sync(dev)
        t = time.perf_counter()
        kept = extract_sharpest_frames(path, out_dir, interval=VIDEO_INTERVAL, device=dev)
        sync(dev)
        ext_s = time.perf_counter() - t
        res = dict(encode_s=enc_s, decode_ms=dec_s / len(frames) * 1e3, min_psnr=min(psnrs),
                   bytes=os.path.getsize(path), p_slices=stats["p_slices"],
                   skip_mbs=stats["skip_mbs"], extract_s=ext_s,
                   frames_per_s=len(frames) / ext_s, kept=len(kept))
        coded = f"{-(-W // 16) * 16}x{-(-H // 16) * 16}"
        log(f"14d H.264 at {W}x{H} (coded {coded}{', cropped' if H % 16 or W % 16 else ''}): "
            f"{len(frames)} frames written in {enc_s:.3f} s ({res['bytes']} bytes, "
            f"{stats['i_slices']} I and {stats['p_slices']} P slices, CABAC, "
            f"{stats['skip_mbs']} skipped macroblocks); decode {res['decode_ms']:.3f} ms a frame "
            f"on the host; round trip PSNR min {res['min_psnr']:.2f} dB; "
            f"extract_sharpest_frames {ext_s:.3f} s, {res['frames_per_s']:.2f} frames/s, "
            f"kept {len(kept)}")
        if (info != (len(frames), float(VIDEO_FPS), W, H) or len(decoded) != len(frames)
                or res["min_psnr"] < VIDEO_MIN_PSNR or stats["p_slices"] == 0
                or stats["cabac_slices"] == 0):
            raise AssertionError(f"14d: the H.264 round trip at {W}x{H}: {info}, {res}")
        check_kept(decoded, out_dir, kept, sharp, False, f"14d {W}x{H}")
        out[f"{W}x{H}"] = res
        if first:
            portrait = os.path.join(tmp, "h264_portrait.mp4")
            rotate_display_matrix(path, portrait)
            pdir = os.path.join(tmp, "h264_frames_portrait")
            sync(dev)
            t = time.perf_counter()
            pkept = extract_sharpest_frames(portrait, pdir, interval=VIDEO_INTERVAL, device=dev)
            sync(dev)
            p_s = time.perf_counter() - t
            pinfo = video_io.video_info(portrait)
            shape = read_png(os.path.join(pdir, pkept[0])).shape
            log(f"14d portrait copy (90-degree display matrix): video_info {pinfo}; "
                f"extract_sharpest_frames {p_s:.3f} s, {len(frames) / p_s:.2f} frames/s, "
                f"kept {len(pkept)} frames of {shape[1]}x{shape[0]}")
            if pinfo != (len(frames), float(VIDEO_FPS), H, W) or shape != (W, H, 3):
                raise AssertionError(f"14d portrait: {pinfo}, kept frames {shape}")
            check_kept(decoded, pdir, pkept, sharp, True, "14d portrait")
            out["portrait"] = dict(seconds=p_s, frames_per_s=len(frames) / p_s, kept=len(pkept),
                                   shape=list(shape))
    out["b_frames"] = phase_video_h264_b(dev, tmp, frames_first[:H264_FRAMES], sharp)
    return out


def phase_video_h264_b(dev: torch.device, tmp: str, frames: list, sharp: list) -> dict:
    """14d, I/P/B: 14b's 1920x1080 frames with B pictures as x264 writes them
    by default (B references, implicit weights), decoded on the host and
    through the extraction on the card."""
    H, W = CODEC_SIZES[0]
    path = os.path.join(tmp, "h264_b.mp4")
    t = time.perf_counter()
    h264_streams.write_frames(path, frames, fps=VIDEO_FPS, qp=H264_QP, cabac=True, **H264_B)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    with video_io.VideoReader(path) as reader:
        decoded = list(reader)
        stats = reader.stats
    dec_s = time.perf_counter() - t
    info = video_io.video_info(path)
    psnrs = [video_psnr(a, b) for a, b in zip(decoded, frames)]
    out_dir = os.path.join(tmp, "h264_b_frames")
    sync(dev)
    t = time.perf_counter()
    kept = extract_sharpest_frames(path, out_dir, interval=VIDEO_INTERVAL, device=dev)
    sync(dev)
    ext_s = time.perf_counter() - t
    res = dict(encode_s=enc_s, decode_ms=dec_s / len(frames) * 1e3, min_psnr=min(psnrs),
               bytes=os.path.getsize(path), extract_s=ext_s, frames_per_s=len(frames) / ext_s,
               kept=len(kept), **{k: stats[k] for k in (
                   "i_slices", "p_slices", "b_slices", "b_skip_mbs", "direct_mbs",
                   "bipred_partitions", "implicit_weighted_slices", "b_reference_pictures",
                   "dropped_pictures")})
    log(f"14d H.264 I/P/B at {W}x{H} ({H264_B}): {len(frames)} frames written in "
        f"{enc_s:.3f} s ({res['bytes']} bytes, {stats['i_slices']} I, {stats['p_slices']} P and "
        f"{stats['b_slices']} B slices, {stats['b_reference_pictures']} B references, "
        f"{stats['b_skip_mbs']} B_Skip and {stats['direct_mbs']} direct macroblocks, "
        f"{stats['bipred_partitions']} bi-predicted partitions); decode {res['decode_ms']:.3f} ms "
        f"a frame on the host; round trip PSNR min {res['min_psnr']:.2f} dB; "
        f"extract_sharpest_frames {ext_s:.3f} s, {res['frames_per_s']:.2f} frames/s, "
        f"kept {len(kept)}")
    if (info != (len(frames), float(VIDEO_FPS), W, H) or len(decoded) != len(frames)
            or res["min_psnr"] < VIDEO_MIN_PSNR or not stats["b_slices"]
            or not stats["implicit_weighted_slices"] or not stats["b_reference_pictures"]
            or stats["dropped_pictures"] or not stats["cabac_slices"]):
        raise AssertionError(f"14d: the H.264 I/P/B round trip: {info}, {res}")
    check_kept(decoded, out_dir, kept, sharp, False, "14d I/P/B")
    return res


def phase_video_hevc(dev: torch.device, tmp: str, frames_1080: list, frames_720: list) -> dict:
    """14e: HEVC I/P (CTB 64, QP 24, the test-stream writer's frames mode)
    of the first HEVC_FRAMES of 14b's 1920x1080 frames: ms a frame to decode
    on the host, the round trip's PSNR (>= 30 dB), extract_sharpest_frames
    on the card keeping the sharp frames, frames/s; and the decode's ms a
    frame at 1280x720 on HEVC_FRAMES_720 of 14d's frames."""
    out = {}
    for frames in (frames_1080[:HEVC_FRAMES], frames_720[:HEVC_FRAMES_720]):
        H, W = frames[0].shape[:2]
        path = os.path.join(tmp, f"hevc_{W}x{H}.mp4")
        t = time.perf_counter()
        hevc_streams.write_frames(path, frames, fps=VIDEO_FPS, qp=HEVC_QP, ctb=HEVC_CTB)
        enc_s = time.perf_counter() - t
        t = time.perf_counter()
        with video_io.VideoReader(path) as reader:
            decoded = list(reader)
            stats = reader.stats
        dec_s = time.perf_counter() - t
        info = video_io.video_info(path)
        psnrs = [video_psnr(a, b) for a, b in zip(decoded, frames)]
        res = dict(encode_s=enc_s, decode_ms=dec_s / len(frames) * 1e3, min_psnr=min(psnrs),
                   bytes=os.path.getsize(path), **{k: stats[k] for k in (
                       "i_slices", "p_slices", "skip_cus", "merge_pus", "amvp_pus", "intra_cus",
                       "partial_ctbs", "ctb64_pictures")})
        msg = (f"14e HEVC I/P at {W}x{H} (CTB {HEVC_CTB}, QP {HEVC_QP}): {len(frames)} frames "
               f"written in {enc_s:.3f} s ({res['bytes']} bytes, {stats['i_slices']} I and "
               f"{stats['p_slices']} P slices, {stats['skip_cus']} skipped and "
               f"{stats['intra_cus']} intra coding units, {stats['partial_ctbs']} partial CTBs); "
               f"decode {res['decode_ms']:.3f} ms a frame on the host; round trip PSNR min "
               f"{res['min_psnr']:.2f} dB")
        if (info != (len(frames), float(VIDEO_FPS), W, H) or len(decoded) != len(frames)
                or res["min_psnr"] < VIDEO_MIN_PSNR or not stats["p_slices"]
                or stats["ctb64_pictures"] != len(frames) or stats["entry_point_mismatches"]):
            log(msg)
            raise AssertionError(f"14e: the HEVC round trip at {W}x{H}: {info}, {res}")
        if (H, W) == CODEC_SIZES[0]:
            sharp = sharp_indices(len(frames))
            out_dir = os.path.join(tmp, "hevc_frames")
            sync(dev)
            t = time.perf_counter()
            kept = extract_sharpest_frames(path, out_dir, interval=VIDEO_INTERVAL, device=dev)
            sync(dev)
            ext_s = time.perf_counter() - t
            res.update(extract_s=ext_s, frames_per_s=len(frames) / ext_s, kept=len(kept))
            msg += (f"; extract_sharpest_frames {ext_s:.3f} s, {res['frames_per_s']:.2f} frames/s, "
                    f"kept {len(kept)}")
            check_kept(decoded, out_dir, kept, sharp, False, f"14e {W}x{H}")
        log(msg)
        out[f"{W}x{H}"] = res
    H, W = CODEC_SIZES[0]
    out["b_frames"] = phase_video_hevc_b(dev, tmp, frames_1080[:HEVC_FRAMES],
                                         out[f"{W}x{H}"]["decode_ms"])
    out["tiles"] = phase_video_hevc_tiles(dev, tmp, frames_1080[:HEVC_TILES_FRAMES])
    out["main10"] = phase_video_hevc_main10(dev, tmp, frames_1080[:HEVC_MAIN10_FRAMES],
                                            out["b_frames"]["decode_ms"])
    out["hlg"] = phase_video_hevc_hlg(dev, tmp, out["b_frames"]["decode_ms"])
    return out


def phase_video_hevc_b(dev: torch.device, tmp: str, frames: list, ip_decode_ms: float) -> dict:
    """14e, I/P/B: 14b's 1920x1080 frames in x265's default GOP shape and WPP
    (HEVC_B: B pyramids, open GOPs with RASL pictures), decoded on the host
    and through the extraction on the card."""
    H, W = frames[0].shape[:2]
    path = os.path.join(tmp, "hevc_b.mp4")
    t = time.perf_counter()
    hevc_streams.write_frames(path, frames, fps=VIDEO_FPS, qp=HEVC_QP, ctb=HEVC_CTB, **HEVC_B)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    with video_io.VideoReader(path) as reader:
        decoded = list(reader)
        stats = reader.stats
    dec_s = time.perf_counter() - t
    info = video_io.video_info(path)
    psnrs = [video_psnr(a, b) for a, b in zip(decoded, frames)]
    out_dir = os.path.join(tmp, "hevc_b_frames")
    sync(dev)
    t = time.perf_counter()
    kept = extract_sharpest_frames(path, out_dir, interval=VIDEO_INTERVAL, device=dev)
    sync(dev)
    ext_s = time.perf_counter() - t
    res = dict(encode_s=enc_s, decode_ms=dec_s / len(frames) * 1e3, min_psnr=min(psnrs),
               bytes=os.path.getsize(path), extract_s=ext_s, frames_per_s=len(frames) / ext_s,
               kept=len(kept), **{k: stats[k] for k in (
                   "i_slices", "p_slices", "b_slices", "bipred_pus", "l1_pus", "skip_cus",
                   "merge_pus", "amvp_pus", "cra_pictures", "rasl_pictures",
                   "skipped_rasl_pictures", "ctb64_pictures", "wpp_pictures", "wpp_synced_rows",
                   "entry_points", "entry_point_mismatches")})
    res["decode_vs_ip"] = res["decode_ms"] / ip_decode_ms
    log(f"14e HEVC I/P/B at {W}x{H} ({HEVC_B}, CTB {HEVC_CTB}, QP {HEVC_QP}): {len(frames)} "
        f"frames written in {enc_s:.3f} s ({res['bytes']} bytes, {stats['i_slices']} I, "
        f"{stats['p_slices']} P and {stats['b_slices']} B slices, {stats['cra_pictures']} CRA "
        f"and {stats['rasl_pictures']} RASL pictures, {stats['bipred_pus']} bi-predicted and "
        f"{stats['l1_pus']} list-1 prediction units, {stats['skip_cus']} skipped coding units, "
        f"{stats['wpp_synced_rows']} CTB rows synced under WPP, {stats['entry_points']} entry "
        f"points, {stats['entry_point_mismatches']} wrong); "
        f"decode {res['decode_ms']:.3f} ms a frame on the host ({res['decode_vs_ip']:.3f}x the "
        f"I/P stream's); round trip PSNR min {res['min_psnr']:.2f} dB; extract_sharpest_frames "
        f"{ext_s:.3f} s, {res['frames_per_s']:.2f} frames/s, kept {len(kept)}")
    if (info != (len(frames), float(VIDEO_FPS), W, H) or len(decoded) != len(frames)
            or res["min_psnr"] < VIDEO_MIN_PSNR or not stats["b_slices"]
            or not stats["bipred_pus"] or not stats["cra_pictures"] or not stats["rasl_pictures"]
            or stats["skipped_rasl_pictures"] or stats["ctb64_pictures"] != len(frames)
            or stats["wpp_pictures"] != len(frames) or not stats["wpp_synced_rows"]
            or not stats["entry_points"] or stats["entry_point_mismatches"]
            or not res["decode_vs_ip"] <= HEVC_B_SLOWDOWN):
        raise AssertionError(f"14e: the HEVC I/P/B round trip: {info}, {res}")
    check_kept(decoded, out_dir, kept, sharp_indices(len(frames)), False, "14e I/P/B")
    return res


def phase_video_hevc_tiles(dev: torch.device, tmp: str, frames: list) -> dict:
    """14e, tiles: 14b's first HEVC_TILES_FRAMES 1920x1080 frames as I/P in
    4x3 uniform tiles with dependent slice segments (HEVC_TILES), decoded on
    the host and through the extraction on the card."""
    H, W = frames[0].shape[:2]
    path = os.path.join(tmp, "hevc_tiles.mp4")
    t = time.perf_counter()
    hevc_streams.write_frames(path, frames, fps=VIDEO_FPS, qp=HEVC_QP, ctb=HEVC_CTB, **HEVC_TILES)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    with video_io.VideoReader(path) as reader:
        decoded = list(reader)
        stats = reader.stats
    dec_s = time.perf_counter() - t
    info = video_io.video_info(path)
    psnrs = [video_psnr(a, b) for a, b in zip(decoded, frames)]
    out_dir = os.path.join(tmp, "hevc_tiles_frames")
    sync(dev)
    t = time.perf_counter()
    kept = extract_sharpest_frames(path, out_dir, interval=VIDEO_INTERVAL, device=dev)
    sync(dev)
    ext_s = time.perf_counter() - t
    res = dict(encode_s=enc_s, decode_ms=dec_s / len(frames) * 1e3, min_psnr=min(psnrs),
               bytes=os.path.getsize(path), extract_s=ext_s, frames_per_s=len(frames) / ext_s,
               kept=len(kept), **{k: stats[k] for k in (
                   "i_slices", "p_slices", "multi_slice_pictures", "tile_pictures", "tiles",
                   "tile_edges_unfiltered", "dependent_slice_segments", "dependent_restores",
                   "entry_points", "entry_point_mismatches", "ctb64_pictures")})
    log(f"14e HEVC tiles at {W}x{H} ({HEVC_TILES}, CTB {HEVC_CTB}, QP {HEVC_QP}): {len(frames)} "
        f"frames written in {enc_s:.3f} s ({res['bytes']} bytes, {stats['i_slices']} I and "
        f"{stats['p_slices']} P slices, {stats['dependent_slice_segments']} dependent slice "
        f"segments ({stats['dependent_restores']} restoring the contexts of the one before), "
        f"{stats['tiles']} tiles, {stats['tile_edges_unfiltered']} CTB edges on tile edges "
        f"unfiltered, {stats['entry_points']} entry points, {stats['entry_point_mismatches']} "
        f"wrong); decode {res['decode_ms']:.3f} ms a frame on the host; round trip PSNR min "
        f"{res['min_psnr']:.2f} dB; extract_sharpest_frames {ext_s:.3f} s, "
        f"{res['frames_per_s']:.2f} frames/s, kept {len(kept)}")
    n = len(frames)
    if (info != (n, float(VIDEO_FPS), W, H) or len(decoded) != n
            or res["min_psnr"] < VIDEO_MIN_PSNR or not stats["p_slices"]
            or stats["tile_pictures"] != n or stats["ctb64_pictures"] != n
            or stats["tiles"] != n * HEVC_TILES["tile_cols"] * HEVC_TILES["tile_rows"]
            or not stats["tile_edges_unfiltered"] or not stats["dependent_slice_segments"]
            or not stats["entry_points"] or stats["entry_point_mismatches"]):
        raise AssertionError(f"14e: the HEVC tiles round trip: {info}, {res}")
    check_kept(decoded, out_dir, kept, sharp_indices(n), False, "14e tiles")
    return res


def phase_video_hevc_main10(dev: torch.device, tmp: str, frames: list, b_decode_ms: float) -> dict:
    """14e, Main 10: 14b's first HEVC_MAIN10_FRAMES 1920x1080 frames as 10-bit
    I/P/B in HEVC_B's shape (HEVC_MAIN10), decoded on the host (converted to
    BGR24 as cv2 converts yuv420p10) and through the extraction on the card;
    the decode's ms a frame beside the 8-bit I/P/B stream's of this call."""
    H, W = frames[0].shape[:2]
    path = os.path.join(tmp, "hevc_main10.mp4")
    t = time.perf_counter()
    hevc_streams.write_frames(path, frames, fps=VIDEO_FPS, qp=HEVC_QP, ctb=HEVC_CTB, **HEVC_MAIN10)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    with video_io.VideoReader(path) as reader:
        decoded = list(reader)
        stats = reader.stats
    dec_s = time.perf_counter() - t
    info = video_io.video_info(path)
    psnrs = [video_psnr(a, b) for a, b in zip(decoded, frames)]
    out_dir = os.path.join(tmp, "hevc_main10_frames")
    sync(dev)
    t = time.perf_counter()
    kept = extract_sharpest_frames(path, out_dir, interval=VIDEO_INTERVAL, device=dev)
    sync(dev)
    ext_s = time.perf_counter() - t
    n = len(frames)
    res = dict(encode_s=enc_s, decode_ms=dec_s / n * 1e3, min_psnr=min(psnrs),
               bytes=os.path.getsize(path), extract_s=ext_s, frames_per_s=n / ext_s,
               kept=len(kept), **{k: stats[k] for k in (
                   "pictures_10bit", "i_slices", "p_slices", "b_slices", "bipred_pus", "skip_cus",
                   "intra_cus", "ctb64_pictures", "wpp_pictures", "wpp_synced_rows",
                   "entry_points", "entry_point_mismatches", "hvcc_bit_depth_mismatches")})
    res["decode_vs_b"] = res["decode_ms"] / b_decode_ms
    log(f"14e HEVC Main 10 I/P/B at {W}x{H} ({HEVC_MAIN10}, CTB {HEVC_CTB}, QP {HEVC_QP}): {n} "
        f"frames written in {enc_s:.3f} s ({res['bytes']} bytes, {stats['pictures_10bit']} "
        f"pictures at 10 bits, {stats['i_slices']} I, {stats['p_slices']} P and "
        f"{stats['b_slices']} B slices, {stats['bipred_pus']} bi-predicted prediction units, "
        f"{stats['wpp_synced_rows']} CTB rows synced under WPP, {stats['entry_points']} entry "
        f"points, {stats['entry_point_mismatches']} wrong, {stats['hvcc_bit_depth_mismatches']} "
        f"hvcC bit depths wrong); decode {res['decode_ms']:.3f} ms a frame on the host "
        f"({res['decode_vs_b']:.3f}x the 8-bit I/P/B stream's); round trip PSNR min "
        f"{res['min_psnr']:.2f} dB; extract_sharpest_frames {ext_s:.3f} s, "
        f"{res['frames_per_s']:.2f} frames/s, kept {len(kept)}")
    if (info != (n, float(VIDEO_FPS), W, H) or len(decoded) != n
            or res["min_psnr"] < VIDEO_MIN_PSNR or stats["pictures_10bit"] != n
            or not stats["b_slices"] or not stats["bipred_pus"] or stats["ctb64_pictures"] != n
            or stats["wpp_pictures"] != n or not stats["wpp_synced_rows"]
            or not stats["entry_points"] or stats["entry_point_mismatches"]
            or stats["hvcc_bit_depth_mismatches"]):
        raise AssertionError(f"14e: the HEVC Main 10 round trip: {info}, {res}")
    check_kept(decoded, out_dir, kept, sharp_indices(n), False, "14e Main 10")
    return res


def hlg_frames(H: int, W: int, n: int) -> list:
    """n BGR frames made in integers from HLG_SEED (the same bytes on any
    host): a colour field bilinearly spread from a coarse random grid, with
    fine random texture; the first sharp, the rest box-blurred (9 x 9)."""
    rng = np.random.default_rng(HLG_SEED)
    gh, gw = 9, 16
    grid = rng.integers(0, 256, (gh, gw, 3)).astype(np.int32)
    ys = np.arange(H, dtype=np.int32) * (gh - 1) * 256 // (H - 1)
    xs = np.arange(W, dtype=np.int32) * (gw - 1) * 256 // (W - 1)
    y0, fy = np.minimum(ys >> 8, gh - 2), ys - (np.minimum(ys >> 8, gh - 2) << 8)
    x0, fx = np.minimum(xs >> 8, gw - 2), xs - (np.minimum(xs >> 8, gw - 2) << 8)
    top = grid[y0][:, x0] * (256 - fx)[None, :, None] + grid[y0][:, x0 + 1] * fx[None, :, None]
    bot = grid[y0 + 1][:, x0] * (256 - fx)[None, :, None] + grid[y0 + 1][:, x0 + 1] * fx[None, :, None]
    field = (top * (256 - fy)[:, None, None] + bot * fy[:, None, None]) >> 16
    sharp = np.clip(field + rng.integers(-48, 49, (H, W, 1), dtype=np.int32), 0, 255)
    r = VIDEO_BLUR // 2
    pad = np.pad(sharp, ((r + 1, r), (r + 1, r), (0, 0)), mode="edge").cumsum(0).cumsum(1)
    box = (pad[VIDEO_BLUR:, VIDEO_BLUR:] - pad[:-VIDEO_BLUR, VIDEO_BLUR:]
           - pad[VIDEO_BLUR:, :-VIDEO_BLUR] + pad[:-VIDEO_BLUR, :-VIDEO_BLUR]) // VIDEO_BLUR ** 2
    return [np.ascontiguousarray((sharp if k == 0 else box).astype(np.uint8)) for k in range(n)]


def phase_video_hevc_hlg(dev: torch.device, tmp: str, b_decode_ms: float) -> dict:
    """14e, HDR: HLG_FRAMES 1920x1080 frames from a numpy seed as HEVC_HLG
    (an iPhone's HLG recording's signalling in HEVC_B's shape), decoded on
    the host through cv2's colour management (csrc/mp4.h) and through the
    extraction on the card: the stream's and the decoded frames' SHA-256
    against the recorded ones, the 3D LUT's against its own (the libm of this
    host), the LUT's build and the decode's ms a frame beside the 8-bit I/P/B
    stream's of this call."""
    t = time.perf_counter()
    lut_sha = hashlib.sha256(video_io.colour_lut(True, True).tobytes()).hexdigest()
    lut_s = time.perf_counter() - t
    frames = hlg_frames(1080, 1920, HLG_FRAMES)
    H, W = frames[0].shape[:2]
    path = os.path.join(tmp, "hevc_hlg.mp4")
    t = time.perf_counter()
    hevc_streams.write_frames(path, frames, fps=VIDEO_FPS, qp=HEVC_QP, ctb=HEVC_CTB, **HEVC_HLG)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    with video_io.VideoReader(path) as reader:
        decoded = list(reader)
        stats = reader.stats
    dec_s = time.perf_counter() - t
    stream_sha = hashlib.sha256(open(path, "rb").read()).hexdigest()
    decoded_sha = hashlib.sha256(b"".join(f.tobytes() for f in decoded)).hexdigest()
    info = video_io.video_info(path)
    out_dir = os.path.join(tmp, "hevc_hlg_frames")
    sync(dev)
    t = time.perf_counter()
    kept = extract_sharpest_frames(path, out_dir, interval=VIDEO_INTERVAL, device=dev)
    sync(dev)
    ext_s = time.perf_counter() - t
    n = len(frames)
    res = dict(lut_build_s=lut_s, encode_s=enc_s, decode_ms=dec_s / n * 1e3,
               bytes=os.path.getsize(path), extract_s=ext_s, frames_per_s=n / ext_s,
               kept=len(kept), stream_sha256=stream_sha, decoded_sha256=decoded_sha,
               lut_sha256=lut_sha,
               **{k: stats[k] for k in (
                   "pictures_10bit", "b_slices", "colour_managed_pictures",
                   "alternative_transfer_seis", "dolby_vision_rpus", "wpp_pictures",
                   "entry_point_mismatches")})
    res["decode_vs_b"] = res["decode_ms"] / b_decode_ms
    log(f"14e HEVC HLG at {W}x{H} ({HEVC_HLG}, CTB {HEVC_CTB}, QP {HEVC_QP}): {n} frames from "
        f"seed {HLG_SEED} written in {enc_s:.3f} s ({res['bytes']} bytes, stream SHA-256 "
        f"{stream_sha}{'' if stream_sha == HLG_STREAM_SHA256 else ', not the recorded one'}); "
        f"the 3D LUT built in {lut_s:.3f} s, SHA-256 {lut_sha}"
        f"{'' if lut_sha == HLG_LUT_SHA256 else ', not the recorded one'}; "
        f"{stats['colour_managed_pictures']} pictures through the LUT, "
        f"{stats['alternative_transfer_seis']} SEIs naming the transfer, "
        f"{stats['dolby_vision_rpus']} RPU units skipped; decode {res['decode_ms']:.3f} ms a frame "
        f"on the host ({res['decode_vs_b']:.3f}x the 8-bit I/P/B stream's); decoded SHA-256 "
        f"{decoded_sha}{'' if decoded_sha == HLG_DECODED_SHA256 else ', not the recorded one'}; "
        f"extract_sharpest_frames {ext_s:.3f} s, {res['frames_per_s']:.2f} frames/s, kept "
        f"{len(kept)}")
    if (info != (n, float(VIDEO_FPS), W, H) or len(decoded) != n or lut_sha != HLG_LUT_SHA256
            or stream_sha != HLG_STREAM_SHA256 or decoded_sha != HLG_DECODED_SHA256
            or stats["pictures_10bit"] != n or stats["colour_managed_pictures"] != n
            or not stats["b_slices"] or stats["alternative_transfer_seis"] < 1
            or stats["dolby_vision_rpus"] != n or stats["wpp_pictures"] != n
            or stats["entry_point_mismatches"]):
        raise AssertionError(f"14e: the HEVC HLG stream: {info}, {res}")
    check_kept(decoded, out_dir, kept, sharp_indices(n), False, "14e HLG")
    return res


def phase_video_fly(dev: torch.device, tmp: str) -> dict:
    """14c: the NeRF fly-through at 720x1280 on a seeded full-width field."""
    from monohair_tpu_torch.synthetic import CAPTURE_FOV_Y, capture_orbit_pose
    field = FourierField(generator=torch.Generator().manual_seed(0)).to(dev)
    poses = [nerf_to_ngp(capture_orbit_pose(0.3 + 0.4 * k, elev=0.12)) for k in range(FLY_POSES)]
    path = os.path.join(tmp, "base_cam.json")
    save_base_cam(path, [_se3(m[:, :3], m[:, 3]) for m in poses], [CAPTURE_FOV_Y] * FLY_POSES)
    rendered = []

    class Kept(video_io.VideoWriter):
        def write(self, frame):
            rendered.append(np.array(frame))
            super().write(frame)

    out = os.path.join(tmp, "ngp_video.mp4")
    real = pipeline_ngp.VideoWriter
    pipeline_ngp.VideoWriter = Kept
    try:
        sync(dev)
        t = time.perf_counter()
        n = pipeline_ngp.render_camera_path_video(field, path, out, *FLY_SIZE,
                                                  frames_per_seg=FLY_FRAMES_PER_SEG,
                                                  background=NGP_BG)
        seconds = time.perf_counter() - t
    finally:
        pipeline_ngp.VideoWriter = real
    decoded = list(video_io.read_video(out))
    want = (FLY_POSES - 1) * FLY_FRAMES_PER_SEG
    psnrs = [video_psnr(a, b) for a, b in zip(decoded, rendered)]
    res = dict(frames=n, seconds=seconds, seconds_a_frame=seconds / max(n, 1),
               min_psnr=min(psnrs), bytes=os.path.getsize(out))
    log(f"14c render_camera_path_video at {FLY_SIZE[1]}x{FLY_SIZE[0]}: {n} frames in "
        f"{seconds:.3f} s ({res['seconds_a_frame']:.3f} s a frame), {res['bytes']} bytes; "
        f"decoded vs rendered PSNR min {res['min_psnr']:.2f} dB")
    if (n != want or len(decoded) != want or decoded[0].shape != (*FLY_SIZE, 3)
            or res["min_psnr"] < VIDEO_MIN_PSNR):
        raise AssertionError(f"14c: {n} frames rendered, {len(decoded)} decoded of shape "
                             f"{decoded[0].shape if decoded else None}: {res}")
    return res


def phase_video(dev: torch.device) -> dict:
    """Phase 14: the codec (14a), the extraction (14b), the fly-through (14c),
    H.264 (14d), HEVC (14e)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as tmp:
        pk.reset_launch_counts()
        res = dict(codec=phase_video_codec(tmp), extract=phase_video_extract(dev, tmp),
                   fly=phase_video_fly(dev, tmp))
        frames = res["extract"].pop("frames")
        res["h264"] = phase_video_h264(dev, tmp, frames)
        t = time.perf_counter()
        res["hevc"] = phase_video_hevc(dev, tmp, frames, res["h264"].pop("frames"))
        log(f"14e took {time.perf_counter() - t:.1f} s")
        res["launches"] = dict(pk.LAUNCHES)
    return res


# ---------------------------------------------------------------------------
# phase 15: the segmentation nets' training
# ---------------------------------------------------------------------------

PARSER_SIZE = 512                # the tool's frames (S)
PARSER_BATCH = 4                 # the tool's --batch
PARSER_CHECK = (2, 256)          # 15a's card-vs-CPU step: batch and frame size
PARSER_TIMED_STEPS = 20          # steady steps timed with CUDA events
PARSER_BUDGET_S = 10.0           # 15b: the CLI's training time, both nets (the script's time)
PARSER_FRAMES = (64, 8)          # 15b: training and eval frames (the tool's: 640 + 48)
PARSER_GATE_WINDOW = 25          # 15b: the first and last steps whose mean losses are compared
PARSER_MIN_STEPS = 3 * PARSER_GATE_WINDOW  # 15b: each net's steps however slow its 15a step
PARSER_NETS = {"parser": (lambda: BiSeNet(19, width=1.0), parser_loss, True, 0),
               "matte": (lambda: MODNet(width=1.0), matte_loss, False, 1)}


def parser_inputs(kind: str, frames: np.ndarray, labels: np.ndarray, device, dtype):
    """A batch as the CLI builds it, made on the host in f32 and then moved
    (CUDA divides by a scalar through its reciprocal, an ulp off the CPU's
    division): ImageNet-normalised frames and labels (parser), or [-1, 1]
    frames, the matte and its band (matte)."""
    x = torch.from_numpy(frames).float() / 255.0
    lab = torch.from_numpy(labels)
    if kind == "parser":
        x = (x - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD)
        batch = (x.permute(0, 3, 1, 2), lab)
    else:
        y = seg_frames.matte_from_label(lab)
        batch = (((x - 0.5) / 0.5).permute(0, 3, 1, 2), y, seg_frames.boundary_band(y))
    return tuple(t.to(device, dtype).contiguous() if t.is_floating_point() else t.to(device)
                 for t in batch)


def parser_card_against_cpu(kind: str, dev: torch.device) -> dict:
    """15a for one net at full width: one step's loss and gradients on the
    card against the CPU in float64 from the same flax-initialised weights,
    at PARSER_CHECK's batch and size; then at 512x512 and batch 4 the steady
    ms a step (CUDA events), one step's profile and the peak memory.
    Train-mode BatchNorm over BiSeNet's pooled (N, C, 1, 1) features (the
    attention and the global branch: 2 values a channel at batch 2) makes its
    f32 gradients ill-conditioned: the CPU's own f32 gradient is ~4e-3 of its
    norm from float64 at 256x256, an H100's 6e-3 to 1e-2. So
    the card is held in float64 (loss within 1e-8 relative, gradients within
    1e-6 of their norm), and in f32 on the loss (1e-4 relative); the f32
    gradients' errors are printed beside the CPU f32's."""
    make, loss_fn, batch_stats, seed = PARSER_NETS[kind]
    n, size = PARSER_CHECK
    frames, labels = seg_frames.render_frames(np.random.default_rng(11), n, size)
    out = {}
    for where, device, dtype in (("cuda", dev, torch.float32),
                                 ("cuda64", dev, torch.float64),
                                 ("cpu", torch.device("cpu"), torch.float64),
                                 ("cpu32", torch.device("cpu"), torch.float32)):
        state = seg_train.create_state(make().to(device, dtype),
                                       torch.Generator().manual_seed(seed), 1e-3, 100)
        batch = parser_inputs(kind, frames, labels, device, dtype)
        t = time.perf_counter()
        loss, grads = seg_train.loss_and_grads(state, loss_fn, *batch, batch_stats=batch_stats)
        sync(device)
        out[where] = dict(loss=float(loss), seconds=time.perf_counter() - t,
                          grads=torch.cat([g.double().flatten().cpu() for g in grads]))
        del state, batch, grads
    host = out["cpu"]

    def errors(o):
        return (abs(o["loss"] - host["loss"]) / abs(host["loss"]),
                float(torch.linalg.norm(o["grads"] - host["grads"])
                      / torch.linalg.norm(host["grads"])))

    err = {k: errors(out[k]) for k in ("cuda", "cuda64", "cpu32")}
    log(f"15a {kind}: one step of {n} frames of {size}x{size} at full width from the same "
        f"weights against the CPU in float64 (loss {host['loss']:.9f}, "
        f"{host['grads'].numel()} gradient elements, {host['seconds']:.2f} s): the card in "
        f"float64 loss rel err {err['cuda64'][0]:.3g}, gradients within {err['cuda64'][1]:.3g} "
        f"of their norm; the card in f32 {err['cuda'][0]:.3g} and {err['cuda'][1]:.3g}; the "
        f"CPU in f32 {err['cpu32'][0]:.3g} and {err['cpu32'][1]:.3g}")
    if not (err["cuda64"][0] <= 1e-8 and err["cuda64"][1] <= 1e-6 and err["cuda"][0] <= 1e-4):
        raise AssertionError(f"15a {kind}: the card's training step disagrees with the CPU's")
    loss_err, grad_err = err["cuda"]
    grad32 = err["cpu32"][1]

    frames, labels = seg_frames.render_frames(np.random.default_rng(12), PARSER_BATCH,
                                              PARSER_SIZE)
    batch = parser_inputs(kind, frames, labels, dev, torch.float32)
    state = seg_train.create_state(make().to(dev), torch.Generator().manual_seed(seed), 1e-3, 100)
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def step():
        seg_train.train_step(state, loss_fn, *batch, batch_stats=batch_stats)

    ms = cuda_time_ms(step, iters=PARSER_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    busy = device_profile(step, f"one {kind} training step", top=10)
    log(f"15a {kind}: {ms:.3f} ms a steady step of {PARSER_BATCH} frames of "
        f"{PARSER_SIZE}x{PARSER_SIZE} (CUDA events over {PARSER_TIMED_STEPS}), busy share "
        f"{busy:.4f}, peak device memory {peak / 2**30:.3f} GiB")
    return dict(loss_err=loss_err, grad_err=grad_err, cpu32_grad_err=grad32, ms=ms, busy=busy,
                peak_bytes=peak)


def phase_hair_parser(dev: torch.device) -> dict:
    """Phase 15: the segmentation nets' training. 15a per net
    (parser_card_against_cpu); 15b python -m monohair_tpu_torch.train_hair_parser's
    main at width 1.0 on PARSER_FRAMES frames of 512x512, each net's steps cut
    to half of PARSER_BUDGET_S at 15a's step time (at least PARSER_MIN_STEPS,
    so that the gate's two windows never overlap on a slower card or host; at
    most the tool's 4000 and 3000), its .npz read back through the runners
    (hair IoU and matte MAE printed, not gated at this cut); the gate: each
    net's mean loss over its last PARSER_GATE_WINDOW steps below its first."""
    exact_f32()
    torch.cuda.empty_cache()
    result = {}
    for kind in PARSER_NETS:
        with Phase(f"15a {kind}"):
            result[kind] = parser_card_against_cpu(kind, dev)
    torch.cuda.empty_cache()
    with Phase("15b train_hair_parser CLI"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_parser_") as tmp:
        steps = {k: min(default, max(PARSER_MIN_STEPS,
                                     int(PARSER_BUDGET_S / 2 * 1e3 / result[k]["ms"])))
                 for k, default in (("parser", 4000), ("matte", 3000))}
        argv = ["--steps", str(steps["parser"]), "--modnet_steps", str(steps["matte"]),
                "--n_train", str(PARSER_FRAMES[0]), "--n_eval", str(PARSER_FRAMES[1]),
                "--out", tmp, "--device", dev.type]
        pk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        run = parser_cli.main(argv)
        result["launches"] = dict(pk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        gates = {}
        for kind in PARSER_NETS:
            losses = run[kind]["losses"]
            w = PARSER_GATE_WINDOW
            gates[kind] = (float(losses[:w].mean()), float(losses[-w:].mean()))
        written = sorted(os.listdir(tmp))
        log(f"15b: train_hair_parser at width 1.0 on {PARSER_FRAMES[0]}+{PARSER_FRAMES[1]} "
            f"frames of {PARSER_SIZE}x{PARSER_SIZE}: {run['seconds']:.2f} s (frames "
            f"{run['render_seconds']:.2f} s, eval {run['eval_seconds']:.2f} s); parser "
            f"{steps['parser']} steps at {run['parser']['ms_per_step']:.3f} ms, matte "
            f"{steps['matte']} steps at {run['matte']['ms_per_step']:.3f} ms; mean loss of the "
            f"first / last {PARSER_GATE_WINDOW} steps: parser {gates['parser'][0]:.4f} / "
            f"{gates['parser'][1]:.4f}, matte {gates['matte'][0]:.4f} / {gates['matte'][1]:.4f}; "
            f"through the runners: hair IoU {run['iou']:.4f}, matte MAE {run['mae']:.4f} (no "
            f"gate at this cut); peak device memory {peak / 2**30:.3f} GiB; wrote {written}")
        if written != ["bisenet.npz", "meta.json", "modnet.npz", "stats.txt"]:
            raise AssertionError(f"15b: the CLI wrote {written}")
        for kind, (first, last) in gates.items():
            if len(run[kind]["losses"]) < 2 * PARSER_GATE_WINDOW:
                raise AssertionError(f"15b: {steps[kind]} {kind} steps: too few for the gate")
            if not (np.isfinite(run[kind]["losses"]).all() and last < first):
                raise AssertionError(f"15b: the {kind}'s loss did not fall: {first} -> {last}")
        result["cli"] = dict(steps=steps, seconds=run["seconds"],
                             render_seconds=run["render_seconds"],
                             parser_ms=run["parser"]["ms_per_step"],
                             matte_ms=run["matte"]["ms_per_step"], iou=run["iou"],
                             mae=run["mae"], loss_windows=gates, peak_bytes=peak)
    return result


# ---------------------------------------------------------------------------
# phase 16: the capture case whole
# ---------------------------------------------------------------------------

# PMVO's surface points on the true hair cap, at least: 0.7927 measured on
# the card with the NeRF's mesh (its fog passes the filters too), 0.09 below
CAP_SHARE_GATE = 0.7
# infer_inner's query spacing (base.yaml's 0.005 asks 62 M queries of the
# NeRF's mesh, whose fog fills its box: 595 s in tools/run_capture_case.py)
CAPTURE_EVAL_VSIZE = 0.02


@contextlib.contextmanager
def timed_calls(seconds: dict, *targets):
    """Each (module, name) of `targets` replaced, for the block, by a wrapper
    that adds its calls' wall seconds (after a device synchronisation) to
    seconds[name]."""
    real = [getattr(m, name) for m, name in targets]

    def wrap(fn, name):
        def timed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            return out
        return timed

    for (m, name), fn in zip(targets, real):
        setattr(m, name, wrap(fn, name))
    try:
        yield seconds
    finally:
        for (m, name), fn in zip(targets, real):
            setattr(m, name, fn)


def counting_filter_masks(counts: dict):
    """solver.filter_masks, adding each call's points, and those left after
    each of the filters filter_points combines, to `counts`."""
    real = solver.filter_masks

    def counted(maps, points, *args):
        k = real(maps, points, *args)
        seen, confident, hair = k["seen"], ~k["low_conf"], k["hair"]
        for name, n in (("loaded", len(points)), ("seen", seen.sum()),
                        ("confident", (seen & confident).sum()),
                        ("hair", (seen & confident & hair).sum())):
            counts[name] = counts.get(name, 0) + int(n)
        return k
    return real, counted


def phase_capture_whole(dev: torch.device, tmp: str, cfg: Config) -> dict:
    """Phase 16: python -m monohair_tpu_torch.run_pipeline's main on the card
    over phase 9's and 10's capture case in `tmp` (32 frames at 1280x720: the
    NeRF's mesh as ours/colmap_points.obj, the fitted bust's Bust/, the depth
    maps from both), stage 1's steps off: PMVO over every candidate of the
    mesh, infer_inner with the shipped nets at their shipped margin (queries
    at CAPTURE_EVAL_VSIZE), HairGrow from full/ through connect_all_segments
    to full/connected_strands.hair.
    Gated on both kernels launched, a non-empty finite strand file and the
    share of PMVO's surface points on the true hair cap (CAP_SHARE_GATE);
    printed: the candidates after each filter (counted as PMVO's filter
    runs), each stage's seconds and peak device memory,
    connect_all_segments' free segments and ms a segment."""
    exact_f32()
    torch.cuda.empty_cache()
    case = os.path.join(tmp, "capture")
    cfg["prepare_data"] = dict.fromkeys(PREPARE_STEPS, False)
    cfg.PMVO["infer_inner"] = True
    cfg.mvs.update(occ_model_path=MVS_WEIGHTS["occ"], ori_model_path=MVS_WEIGHTS["ori"],
                   eval_vsize=CAPTURE_EVAL_VSIZE)
    with open(os.path.join(tmp, "case.yaml"), "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    connect, kept = {}, {}
    real = hair_grow_stage.connect_all_segments
    real_masks, solver.filter_masks = counting_filter_masks(kept)

    def connect_timed(strands, *a, **k):
        t = time.perf_counter()
        joined = real(strands, *a, **k)
        connect.update(segments=len(strands), seconds=time.perf_counter() - t)
        return joined

    hair_grow_stage.connect_all_segments = connect_timed
    pk.reset_launch_counts()
    t = time.perf_counter()
    parts = {}
    try:
        with timed_calls(parts, (pmvo_stage, "load_colmap_points"),
                         (pmvo_stage, "filter_raw_points"),
                         (infer_inner_stage, "load_mvs_inputs"),
                         (infer_inner_stage, "colmap_guided_queries")):
            steps = pipeline_cli.main(["--yaml=" + os.path.join(tmp, "case"),
                                       f"--device={dev.type}"])
    finally:
        hair_grow_stage.connect_all_segments, solver.filter_masks = real, real_masks
    wall = time.perf_counter() - t
    launches = dict(pk.LAUNCHES)
    out = os.path.join(case, "output", cfg.name)
    seconds = check_stage_metrics(out)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        peaks = {json.loads(line)["name"].split("/")[1]: json.loads(line).get("peak_bytes")
                 for line in f}
    surface = np.load(os.path.join(out, "optimize", "surface.npy"))
    share = capture_cap_share_of_points(case, surface)
    segments, points = load_hair(os.path.join(out, "full", "connected_strands.hair"))
    ms_a_segment = connect["seconds"] / max(connect["segments"], 1) * 1e3
    log(f"16 run_pipeline on phase 9's and 10's capture case ({CAPTURE_FRAMES} frames at "
        f"{CAPTURE_SIZE[1]}x{CAPTURE_SIZE[0]}, the NeRF's mesh, the fitted bust): {wall:.2f} s; "
        f"stage seconds {seconds}; peak device memory per stage (GiB) "
        f"{json.dumps({k: round(v / 2**30, 3) for k, v in peaks.items() if v is not None})}; "
        f"steps {json.dumps({k: {n: round(x, 3) for n, x in v.items()} for k, v in steps.items()})}; "
        f"within them (s) {json.dumps({k: round(v, 3) for k, v in parts.items()})}")
    log(f"16 PMVO's candidates through its filters: loaded {kept['loaded']}, seen in > 1 views "
        f"{kept['seen']}, and not low-confidence in > 4 {kept['confident']}, and on the hair "
        f"mask in >= half {kept['hair']} ({len(surface)} surface points written); "
        f"{share:.4f} of them on the true hair cap (gate {CAP_SHARE_GATE}); kernel launches "
        f"{launches}")
    log(f"16 connect_all_segments: {connect['segments']} free segments in "
        f"{connect['seconds']:.3f} s = {ms_a_segment:.3f} ms a segment; "
        f"full/connected_strands.hair {len(segments)} strands, {len(points)} points")
    print(smi_line(), flush=True)
    if unlaunched(launches, ("patch_gather", "patch_min_loss")):
        raise AssertionError(f"16: a kernel of PMVO's path was not launched: {launches}")
    if len(segments) == 0 or not np.isfinite(points).all():
        raise AssertionError("16: the capture case grew no strands")
    if share < CAP_SHARE_GATE:
        raise AssertionError(f"16: {share:.4f} of PMVO's surface points on the true hair cap "
                             f"(gate {CAP_SHARE_GATE})")
    return dict(wall=wall, seconds=seconds, peaks=peaks, steps=steps, parts=parts, survivors=kept,
                surface=len(surface), cap_share=share, connect=connect,
                connect_ms_a_segment=ms_a_segment, strands=len(segments), launches=launches)


KERNEL_META = {
    "patch_gather": dict(route="cuda", source="monohair_tpu_torch/csrc/patch_kernels.cu",
                         replaces="monohair_tpu/ops/pallas_kernels.py:188"),
    "patch_gather_bf16": dict(route="cuda", source="monohair_tpu_torch/csrc/patch_kernels.cu",
                              replaces="monohair_tpu/ops/pallas_kernels.py:188"),
    "patch_min_loss": dict(route="cuda", source="monohair_tpu_torch/csrc/patch_kernels.cu",
                           replaces="monohair_tpu/ops/pallas_kernels.py:63"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the full-width line search with torch.profiler "
                         "and print where the device time goes")
    opts = ap.parse_args(argv)

    with Phase("1 device"):
        device = phase_device()
    dev = torch.device("cuda", 0)
    with Phase("2 build"):
        phase_build()
    with Phase("3 kernels"):
        kernels = phase_kernels(dev)
    with Phase("4 stage"):
        phase_stage("cuda")
    with Phase("5 full width"):
        width = phase_full_width(dev)
    with Phase("6 grow"):
        grow = phase_grow_full_width(dev)
    # phase 7 renders phase 6's strands, then checks and reads its own paths
    stage3 = phase_stage3(dev, grow.pop("voxel_strands"), opts.profile)
    with Phase("8 prepare_data"):
        stage1 = phase_prepare_data(dev)
    # phases 9, 10 and 16 share one capture case
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as capture:
        with Phase("9 prepare_data with the NeRF"):
            ngp = phase_ngp(dev, capture)
        capture_cfg = ngp.pop("config")
        with Phase("10 prepare_data with the bust fit"):
            bust = phase_bust_fit(dev, capture, capture_cfg, ngp.pop("mvs_poses"))
        with Phase("11 train"):
            train = phase_train(dev)
        with Phase("12 run_pipeline"):
            pipeline = phase_pipeline(dev, stage3["stage"]["margin"])
        with Phase("13a JPEG codec"):
            phase_codec()
        with Phase("13b-c bf16 maps and the mesh"):
            bf16 = phase_bf16_and_mesh(dev)
        with Phase("13d JPEG capture through run_pipeline"):
            phase_jpeg_capture(dev)
        with Phase("14 video"):
            video = phase_video(dev)
        with Phase("15 hair parser training"):
            hair_parser = phase_hair_parser(dev)
        with Phase("16 the capture case whole through run_pipeline"):
            whole = phase_capture_whole(dev, capture, capture_cfg)
    print(smi_line(), flush=True)
    by_path = {"pmvo": width["launches"], "infer_inner_fuse": stage3["stage"]["launches"],
               "prepare_data": stage1["launches"], "prepare_data_ngp": ngp["launches"],
               "prepare_data_bust": bust["launches"], "train_mvs": train["launches"],
               "run_pipeline": pipeline["launches"], "pmvo_bf16": bf16["launches"],
               "video": video["launches"], "train_hair_parser": hair_parser["launches"],
               "capture_whole": whole["launches"]}
    kernels["patch_min_loss"]["scene_ms"] = width["scene_ms"]
    if opts.profile:
        with Phase("profile"):
            profile_line_search(dev)
    line = [dict(name=name, **KERNEL_META[name],
                 launches=sum(counts.get(name, 0) for counts in by_path.values()),
                 launches_by_path={path: counts.get(name, 0) for path, counts in by_path.items()},
                 **kernels[name]) for name in KERNEL_META]
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
