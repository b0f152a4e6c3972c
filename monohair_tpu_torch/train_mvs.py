"""Train the DeepMVSHair occupancy/orientation nets (port of the root
train_mvs.py):

    python -m monohair_tpu_torch.train_mvs --data_root=<cases> --calib=<cam_params.json> \\
        --kind=occ --steps=20000 [--resume] [--device=cpu]

Runs on the GPU unless --device=cpu is given. Each case directory under
data_root holds imgs/<view>/{undirectional_map,hair_depth,bust_depth,mask}.png
and the ground truth ours/{Occ3D,Ori3D}.mat; one cam_params.json serves every
case. The reference ships the nets' weights but no trainer (SURVEY.md §2.4 #27).

As the JAX trainer does: a held-out split evaluated every --eval_every steps
(all of a case's points, or the last --holdout_cases cases), written to
<out>/stats_<kind>.txt in the reference's columns (occ: train loss, precision,
recall, then the same for val; ori: train L1, val L1); balanced occ batches;
a streaming LRU case store. The checkpoint is `checkpoint.py`'s:
<out>/<kind>.npz (the net, which infer_inner's load_net reads as it is) and
<out>/<kind>_train.npz (Adam's state and the step), every --save_every steps
and at the end; --resume continues from them.

One departure, a fault of the JAX trainer: it seeds each case's split with
Python's hash() of the case name, which Python salts per process, so a resumed
run draws another split. Here the seed is zlib.crc32 of the name.
"""

import argparse
import os
import sys
import time
import zlib
from collections import OrderedDict

import numpy as np
import torch

from .checkpoint import has_train_state, load_train_state, save_train_state
from .coords import voxel_to_world
from .io.mat_io import load_occ_mat, load_ori_mat
from .models.pifu import OccAttn, OriAttn
from .mvs.eval import load_mvs_inputs
from .mvs.sampling import sample_occ_training_points, sample_ori_training_points
from .mvs.train import create_state, eval_step, occ_metrics, train_step
from .ops import exact_f32


def case_seed(case: str, seed: int = 0) -> int:
    """The seed of a case's split: stable across processes (crc32, not hash())."""
    return seed + zlib.crc32(case.encode()) % (2 ** 31)


class CaseStore:
    """Lazy per-case loader with an LRU cache of at most `max_cached` cases
    (the maps on the device, the sampled points split into train and val), so
    multi-case training streams from disk."""

    def __init__(self, data_root: str, calib: str, kind: str, val_frac: float,
                 max_cached: int = 4, seed: int = 0, device="cuda"):
        self.root = data_root
        self.calib = calib
        self.kind = kind
        self.val_frac = val_frac
        self.max_cached = max_cached
        self.seed = seed
        self.device = device
        self.cases = sorted(d for d in os.listdir(data_root)
                            if os.path.isdir(os.path.join(data_root, d)))
        if not self.cases:
            raise SystemExit(f"no case directories under {data_root}")
        self._cache = OrderedDict()

    def points(self, case: str):
        """(world points (N, 3) float32, targets) of a case, before the split."""
        cd = os.path.join(self.root, case)
        occ = load_occ_mat(os.path.join(cd, "ours/Occ3D.mat"))
        if self.kind == "occ":
            pts_v, targets = sample_occ_training_points(occ)
        else:
            ori = load_ori_mat(os.path.join(cd, "ours/Ori3D.mat"))
            pts_v, targets = sample_ori_training_points(occ, ori)
        pts_w = voxel_to_world(torch.from_numpy(pts_v)).numpy().astype(np.float32)
        return pts_w, targets

    def get(self, case: str):
        if case in self._cache:
            self._cache.move_to_end(case)
            return self._cache[case]
        inputs, _ = load_mvs_inputs(os.path.join(self.root, case), self.calib,
                                    device=self.device)
        pts_w, targets = self.points(case)
        # a deterministic per-case split, the same in every process
        perm = np.random.default_rng(case_seed(case, self.seed)).permutation(len(pts_w))
        n_val = int(len(perm) * self.val_frac)
        entry = {"inputs": inputs,
                 "train": (pts_w[perm[n_val:]], targets[perm[n_val:]]),
                 "val": (pts_w[perm[:n_val]], targets[perm[:n_val]])}
        tr_pts, tr_targets = entry["train"]
        entry["train_dev"] = (torch.as_tensor(tr_pts, device=self.device),
                              torch.as_tensor(tr_targets, device=self.device))
        self._cache[case] = entry
        while len(self._cache) > self.max_cached:
            self._cache.popitem(last=False)
        return entry


def parse_args(argv):
    ap = argparse.ArgumentParser(description="train the DeepMVSHair occ/ori nets")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--calib", required=True, help="cam_params.json path")
    ap.add_argument("--kind", choices=["occ", "ori"], default="occ")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--out", default="checkpoints/mvs")
    ap.add_argument("--val_frac", type=float, default=0.1)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--save_every", type=int, default=5000)
    ap.add_argument("--max_cached_cases", type=int, default=16,
                    help="LRU case-cache size; keep it >= the number of training cases "
                         "when memory allows, or every miss re-reads and resamples a case")
    ap.add_argument("--resume", action="store_true",
                    help="restore the net, Adam's state and the step from --out and continue")
    ap.add_argument("--holdout_cases", type=int, default=0,
                    help="hold the LAST N cases out of training entirely; the val columns "
                         "then measure case-level generalisation")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def balanced_batch(entry: dict, rng: np.random.Generator, batch: int) -> np.ndarray:
    """Half positive, half negative indices of a case's training points: the
    sampler's negatives outnumber its positives ~5:1, and unweighted
    cross-entropy on that mix plateaued at a val recall ~0.28 in the JAX
    package's runs. A case whose points are all of one class falls back to
    unbalanced draws."""
    _, targets = entry["train"]
    if "pos_neg" not in entry:
        entry["pos_neg"] = (np.flatnonzero(targets > 0), np.flatnonzero(targets == 0))
    pos_i, neg_i = entry["pos_neg"]
    if len(pos_i) == 0 or len(neg_i) == 0:
        return rng.integers(0, len(targets), batch)
    return np.concatenate([pos_i[rng.integers(0, len(pos_i), batch // 2)],
                           neg_i[rng.integers(0, len(neg_i), batch - batch // 2)]])


def main(argv):
    """Train; returns {"losses": the training loss of every step taken,
    "seconds": the training loop's wall seconds, "start": the first step,
    "state": the final mvs.train.TrainState}."""
    args = parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda":
        exact_f32()
    store = CaseStore(args.data_root, args.calib, args.kind, args.val_frac,
                      args.max_cached_cases, device=device)
    if args.holdout_cases:
        train_cases = store.cases[:-args.holdout_cases]
        val_cases = store.cases[-args.holdout_cases:]
    else:
        train_cases = val_cases = store.cases
    print(f"{len(train_cases)} training / "
          f"{len(val_cases) if args.holdout_cases else 0} held-out cases "
          f"(streaming, cache {args.max_cached_cases})", flush=True)
    first = store.get(store.cases[0])
    V = first["inputs"].imgs.shape[0]
    is_occ = args.kind == "occ"
    model = (OccAttn if is_occ else OriAttn)(num_views=V).to(device)
    state = create_state(model, torch.Generator().manual_seed(0), args.lr, args.steps)

    os.makedirs(args.out, exist_ok=True)
    stats_path = os.path.join(args.out, f"stats_{args.kind}.txt")
    if args.resume and has_train_state(args.out, args.kind):
        load_train_state(args.out, args.kind, state)
        print(f"resumed from {args.out} at step {state.step}", flush=True)
    start = state.step

    def batch_metrics(out, targets, loss):
        if is_occ:
            m = occ_metrics(out, targets)
            return [float(loss), m["precision"], m["recall"]]
        return [float(loss)]

    def evaluate(split):
        """Aggregate the split over its cases (batched, eval mode). With
        --holdout_cases, 'val' runs on cases never trained on. A last short
        batch is padded by repeating its last point, and the padding counts."""
        rows = []
        for case in (train_cases if split == "train" else val_cases):
            entry = store.get(case)
            pts, targets = entry[split]
            if not len(pts):
                continue
            sel = np.arange(min(len(pts), 4 * args.batch))
            for beg in range(0, len(sel), args.batch):
                sub = sel[beg:beg + args.batch]
                if len(sub) < args.batch:
                    sub = np.concatenate([sub, np.repeat(sub[-1:], args.batch - len(sub))])
                inputs = entry["inputs"]
                loss, out = eval_step(state, inputs.imgs, inputs.w2c, inputs.ndc,
                                      torch.as_tensor(pts[sub], device=device),
                                      torch.as_tensor(targets[sub], device=device))
                rows.append(batch_metrics(out, targets[sub], loss))
        return np.mean(rows, 0) if rows else np.zeros(3 if is_occ else 1)

    rng = np.random.default_rng(start)
    losses = []
    t0 = time.monotonic()
    for i in range(start, args.steps):
        entry = store.get(train_cases[int(rng.integers(0, len(train_cases)))])
        if is_occ:
            sel = balanced_batch(entry, rng, args.batch)
        else:
            sel = rng.integers(0, len(entry["train"][0]), args.batch)
        idx = torch.as_tensor(sel, device=device)
        pts, targets = (t[idx] for t in entry["train_dev"])
        inputs = entry["inputs"]
        losses.append(train_step(state, inputs.imgs, inputs.w2c, inputs.ndc, pts, targets))
        if i % args.eval_every == 0:
            line = "\t".join(f"{x:.6f}" for x in np.concatenate([evaluate("train"),
                                                                 evaluate("val")]))
            with open(stats_path, "a") as f:
                f.write(line + "\n")
            print(f"step {i}: {line}", flush=True)
        if (i + 1) % args.save_every == 0 or i + 1 == args.steps:
            save_train_state(args.out, args.kind, state)
    seconds = time.monotonic() - t0
    print(f"saved {os.path.join(args.out, args.kind)}.npz", flush=True)
    return {"losses": torch.stack(losses).tolist() if losses else [], "seconds": seconds,
            "start": start, "state": state}


if __name__ == "__main__":
    main(sys.argv[1:])
