#!/usr/bin/env python
"""How far the MVS nets' f32 training gradients sit from float64, on the card
and on the CPU.

    python tools/mvs_train_precision.py

Needs one CUDA device. Writes 4 training cases as chip_smoke.py phase 11
does (16 ring views at 256x256), then for the ori and the occ net takes one
batch of 4096 training points and computes loss_and_grads from one seeded
state three times: on the card in f32, on the card in float64 and on the CPU
in f32. Prints the loss of each, the gradients' distance from the card's
float64 ones as a share of their norm, and the 10 parameters whose gradients
the card and the CPU disagree on most (the conv biases in front of a
BatchNorm lead: their true gradient is 0, so theirs is rounding noise). For
the ori net, also the smallest and median norm of the head's raw output and
the near-ties of its sign-agnostic L1 (the branches of min(pos, neg) and the
components of |pred -+ gt| within 1e-4 and 1e-5 of a tie).
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from monohair_tpu_torch import train_mvs as train_cli  # noqa: E402
from monohair_tpu_torch.models.pifu import mvs_projection  # noqa: E402
from monohair_tpu_torch.mvs.train import create_state, loss_and_grads  # noqa: E402

RUNS = (("card32", "cuda", torch.float32), ("card64", "cuda", torch.float64),
        ("cpu32", "cpu", torch.float32))


def ori_ties(model, args) -> str:
    coord, cam = mvs_projection(args[1], args[2], args[3])
    with torch.no_grad():
        out = model._fuse(model.get_feat(args[0]), args[3], cam, coord)
        n = out.norm(dim=-1)
        p = out / n[:, None].clamp_min(1e-12)
        pos = (p - args[4]).abs().mean(-1)
        neg = (p + args[4]).abs().mean(-1)
        comps = int(((p - args[4]).abs() < 1e-5).sum() + ((p + args[4]).abs() < 1e-5).sum())
    return (f"raw |out| min {float(n.min()):.6f} median {float(n.median()):.6f}; "
            f"|pos - neg| < 1e-4 at {int(((pos - neg).abs() < 1e-4).sum())} points; "
            f"{comps} components within 1e-5 of a tie")


def main() -> None:
    c.phase_device()
    dev = torch.device("cuda", 0)
    c.exact_f32()
    with tempfile.TemporaryDirectory() as tmp:
        calib = c.write_train_cases(tmp, dev)
        for kind in ("ori", "occ"):
            entry = train_cli.CaseStore(os.path.join(tmp, "data"), calib, kind, 0.1,
                                        device=dev).get("case000")
            rng = np.random.default_rng(1)
            pts, targets = entry["train_dev"]
            sel = (train_cli.balanced_batch(entry, rng, c.TRAIN_BATCH) if kind == "occ"
                   else rng.integers(0, len(pts), c.TRAIN_BATCH))
            idx = torch.as_tensor(sel, device=dev)
            base = (entry["inputs"].imgs, entry["inputs"].w2c, entry["inputs"].ndc,
                    pts[idx], targets[idx])
            grads = {}
            for name, device, dtype in RUNS:
                model = c.TRAIN_NETS[kind](num_views=c.MVS_VIEWS).to(device, dtype)
                state = create_state(model, torch.Generator().manual_seed(0), c.TRAIN_LR,
                                     c.TRAIN_STEPS)
                args = [t.to(device, dtype) if t.is_floating_point() else t.to(device)
                        for t in base]
                t = time.perf_counter()
                loss, g = loss_and_grads(state, *args)
                grads[name] = [x.detach().double().cpu() for x in g]
                print(f"{kind} {name}: loss {float(loss):.9f} in {time.perf_counter() - t:.2f} s"
                      + (f"; {ori_ties(model, args)}" if kind == "ori" else ""), flush=True)
            flat = {k: torch.cat([x.flatten() for x in v]) for k, v in grads.items()}

            def rel(a, b):
                return float((flat[a] - flat[b]).norm() / flat[b].norm())

            print(f"{kind} gradients, distance as a share of the norm: card f32 vs card "
                  f"float64 {rel('card32', 'card64'):.3g}, CPU f32 vs card float64 "
                  f"{rel('cpu32', 'card64'):.3g}, card f32 vs CPU f32 "
                  f"{rel('card32', 'cpu32'):.3g}", flush=True)
            names = [n for n, _ in c.TRAIN_NETS[kind](num_views=c.MVS_VIEWS).named_parameters()]
            rows = []
            for i, name in enumerate(names):
                ref = max(float(grads["card64"][i].norm()), 1e-30)
                rows.append((float((grads["card32"][i] - grads["cpu32"][i]).norm()) / ref,
                             float((grads["card32"][i] - grads["card64"][i]).norm()) / ref,
                             float((grads["cpu32"][i] - grads["card64"][i]).norm()) / ref,
                             ref, name))
            for row in sorted(rows, reverse=True)[:10]:
                print("  card-cpu %.3g card-f64 %.3g cpu-f64 %.3g norm %.3g %s" % row)


if __name__ == "__main__":
    main()
