"""Train the hair parser (BiSeNet) and the person matte (MODNet) on synthetic
frames, then evaluate hair IoU and the matte's error through stage 1's own
runners (port of tools/train_hair_parser.py, which trained the shipped
trained/hair_parser weights):

    python -m monohair_tpu_torch.train_hair_parser [--steps 4000] [--batch 4] \\
        [--width 1.0] [--n_train 640] [--n_eval 48] [--lr 1e-3] \\
        [--out trained/hair_parser] [--modnet_steps 3000] [--device cuda]

Runs on the GPU unless --device=cpu is given. As the tool does, from one
numpy Generator seeded 0 and consumed in the tool's order:
- n_train + n_eval frames of 512x512 (``segment/frames.py``: a quarter from
  the capture case, the rest generic heads over busy backgrounds), labels 0
  background, 1 skin, 17 hair;
- BiSeNet (width --width, flax's initialisers) for --steps Adam steps on the
  cosine schedule: per step a batch of frame indices and a coin for a
  horizontal flip (no left/right class swap), ImageNet-normalised, the
  three heads' cross-entropy (``segment/train.py``), BatchNorm in train mode;
- MODNet for --modnet_steps steps: frames scaled to [-1, 1], the matte
  (label > 0), its 13x13 boundary band, MODNet's three-term loss, BatchNorm
  on its running statistics (the tool calls the net without its train flag);
- hair IoU (hair_mask > 127 against label 17) and the matte's mean absolute
  error over the eval frames through ParsingRunner (3 scales x flip) and
  MattingRunner, one frame at a time.
Writes <out>/bisenet.npz and <out>/modnet.npz (flax trees, the layout both
packages' runners load), <out>/stats.txt and <out>/meta.json in the tool's
format, and prints each net's ms a step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .ops import exact_f32
from .segment import frames as seg_frames
from .segment.bisenet import HAIR_CLASS, BiSeNet
from .segment.convert import save_flax_npz
from .segment.modnet import MODNet
from .segment.runners import IMAGENET_MEAN, IMAGENET_STD, MattingRunner, ParsingRunner
from .segment.train import create_state, matte_loss, parser_loss, train_step

LOG_EVERY = 100


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="train the hair parser and the person matte")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--n_train", type=int, default=640)
    ap.add_argument("--n_eval", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="trained/hair_parser")
    ap.add_argument("--modnet_steps", type=int, default=3000)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loop(what: str, state, steps: int, batch_fn: Callable, loss_fn: Callable,
          batch_stats: bool, device: torch.device) -> dict:
    """`steps` Adam steps on the batches batch_fn() gives: every step's loss
    (kept on the device until the end) and the loop's ms a step."""
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(train_step(state, loss_fn, *batch_fn(), batch_stats=batch_stats))
        if i % LOG_EVERY == 0:
            print(f"[{what}] step {i}/{steps} loss {float(losses[-1]):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    _sync(device)
    seconds = time.perf_counter() - t0
    ms = seconds * 1e3 / max(steps, 1)
    print(f"[{what}] {steps} steps in {seconds:.2f} s: {ms:.3f} ms a step", flush=True)
    return dict(losses=torch.stack(losses).cpu().numpy() if losses else np.zeros(0),
                seconds=seconds, ms_per_step=ms)


def train_nets(frames: torch.Tensor, labels: torch.Tensor, rng: np.random.Generator,
               args: argparse.Namespace, device, parser_init: Optional[Mapping] = None,
               matte_init: Optional[Mapping] = None) -> dict:
    """The two training loops of the tool on (N, S, S, 3) uint8 frames and
    (N, S, S) uint8 labels on the device (the first args.n_train frames
    train), drawing each batch from rng after the frames were drawn from it.
    The nets start from flax's initialisers (torch generators seeded 0 and 1,
    as the tool's PRNG keys) or from the given state dicts. Returns the
    trained nets and each loop's losses and times."""
    device = torch.device(device)
    n_train = args.n_train
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)

    parser = BiSeNet(width=args.width).to(device)
    state = create_state(parser, torch.Generator().manual_seed(0), args.lr, args.steps)
    if parser_init is not None:
        parser.load_state_dict(parser_init)

    def parser_batch():
        idx = torch.as_tensor(rng.integers(0, n_train, args.batch), device=device)
        x = frames[idx].float() / 255.0
        y = labels[idx]
        if rng.random() < 0.5:
            x, y = x.flip(2), y.flip(2)
        return ((x - mean) / std).permute(0, 3, 1, 2).contiguous(), y

    out = {"parser": _loop("parser", state, args.steps, parser_batch, parser_loss, True,
                           device)}

    matte = MODNet(width=args.width).to(device)
    mstate = create_state(matte, torch.Generator().manual_seed(1), args.lr, args.modnet_steps)
    if matte_init is not None:
        matte.load_state_dict(matte_init)

    def matte_batch():
        idx = torch.as_tensor(rng.integers(0, n_train, args.batch), device=device)
        x = (frames[idx].float() / 255.0 - 0.5) / 0.5
        y = seg_frames.matte_from_label(labels[idx])
        return x.permute(0, 3, 1, 2).contiguous(), y, seg_frames.boundary_band(y)

    out["matte"] = _loop("matte", mstate, args.modnet_steps, matte_batch, matte_loss, False,
                         device)
    out["parser"]["net"], out["matte"]["net"] = parser.eval(), matte.eval()
    return out


def evaluate(parser_path: str, matte_path: str, frames: torch.Tensor, labels: torch.Tensor,
             width: float, device) -> dict:
    """Hair IoU and the matte's MAE over the frames through the runners, one
    frame at a time, as the tool evaluates."""
    runner = ParsingRunner(parser_path, width=width, device=device)
    mrunner = MattingRunner(matte_path, width=width, device=device)
    inter = union = 0.0
    mae = []
    for k in range(len(frames)):
        hm = runner.hair_mask(frames[k:k + 1])[0] > 127
        gt = labels[k] == HAIR_CLASS
        inter += float((hm & gt).sum())
        union += float((hm | gt).sum())
        m = mrunner.matte(frames[k:k + 1])[0]
        mae.append(float(torch.abs(m - seg_frames.matte_from_label(labels[k])).mean()))
    return dict(iou=inter / max(union, 1), mae=float(np.mean(mae)))


def main(argv=None, parser_init: Optional[Mapping] = None,
         matte_init: Optional[Mapping] = None) -> dict:
    """The CLI; returns what train_nets and evaluate returned and the
    seconds of each part."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device (pass --device cpu for the CPU)")
        exact_f32()
    t_start = time.perf_counter()
    rng = np.random.default_rng(0)
    size = seg_frames.FRAME_SIZE
    print(f"rendering {args.n_train}+{args.n_eval} synthetic frames of {size}x{size}...",
          flush=True)
    frames_np, labels_np = seg_frames.render_frames(rng, args.n_train + args.n_eval, size)
    render_s = time.perf_counter() - t_start
    print(f"rendered in {render_s:.2f} s", flush=True)
    frames = torch.from_numpy(frames_np).to(device)
    labels = torch.from_numpy(labels_np).to(device)

    out = train_nets(frames, labels, rng, args, device, parser_init, matte_init)
    os.makedirs(args.out, exist_ok=True)
    parser_path = os.path.join(args.out, "bisenet.npz")
    matte_path = os.path.join(args.out, "modnet.npz")
    save_flax_npz(out["parser"]["net"], parser_path)
    save_flax_npz(out["matte"]["net"], matte_path)

    t = time.perf_counter()
    ev = evaluate(parser_path, matte_path, frames[args.n_train:], labels[args.n_train:],
                  args.width, device)
    eval_s = time.perf_counter() - t
    print(f"ensemble hair IoU over {args.n_eval} frames: {ev['iou']:.4f}")
    print(f"matte MAE: {ev['mae']:.4f}")
    with open(os.path.join(args.out, "stats.txt"), "w") as f:
        f.write(f"hair_iou {ev['iou']:.4f}\nmatte_mae {ev['mae']:.4f}\n"
                f"steps {args.steps} width {args.width} "
                f"train {args.n_train} eval {args.n_eval}\n")
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({"width": args.width}, f)
    seconds = time.perf_counter() - t_start
    print(f"train_hair_parser: {seconds:.2f} s (frames {render_s:.2f}, parser "
          f"{out['parser']['seconds']:.2f}, matte {out['matte']['seconds']:.2f}, eval "
          f"{eval_s:.2f}); parser {out['parser']['ms_per_step']:.3f} ms a step, matte "
          f"{out['matte']['ms_per_step']:.3f} ms a step", flush=True)
    return dict(out, **ev, seconds=seconds, render_seconds=render_s, eval_seconds=eval_s,
                parser_path=parser_path, matte_path=matte_path)


if __name__ == "__main__":
    main(sys.argv[1:])
