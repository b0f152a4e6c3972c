"""Coloured stage logger and metrics file appender (port of
monohair_tpu/log.py; reference log.py), with per-stage wall-clock timing and an
optional torch.profiler trace of a stage.

`Log.metric` appends one JSON line {"t", "name", "value", ...} to
`metrics_path` when it is set; `Log.stage` writes `stage/<name>/seconds`
through it. On a CUDA device the stage's clock stops after a synchronisation,
so its seconds include the device work it queued, and the line also holds the
stage's peak device memory (`peak_bytes`, torch.cuda.max_memory_allocated
from the stage's start) once CUDA is initialised."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

_COLORS = {"info": "\033[36m", "ok": "\033[32m", "warn": "\033[33m",
           "err": "\033[31m", "end": "\033[0m"}


class Log:
    def __init__(self, metrics_path: Optional[str] = None):
        self.metrics_path = metrics_path
        self._t0 = time.monotonic()

    def _emit(self, level: str, msg: str):
        c = _COLORS.get(level, "")
        print(f"{c}[{time.monotonic() - self._t0:8.1f}s] {msg}{_COLORS['end']}", flush=True)

    def info(self, msg: str):
        self._emit("info", msg)

    def ok(self, msg: str):
        self._emit("ok", msg)

    def warn(self, msg: str):
        self._emit("warn", msg)

    def metric(self, name: str, value, **extra):
        """Append a metric line (replaces Log.loss_train, log.py:55-64)."""
        self._emit("info", f"{name} = {value}")
        if self.metrics_path:
            os.makedirs(os.path.dirname(os.path.abspath(self.metrics_path)), exist_ok=True)
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps({"t": time.time(), "name": name,
                                    "value": value, **extra}) + "\n")

    @contextlib.contextmanager
    def stage(self, name: str, trace_dir: Optional[str] = None, device=None):
        """Time a pipeline stage on `device` (synchronised at the end when it
        is a CUDA device); with `trace_dir`, record a torch.profiler trace of
        it (CPU, and CUDA on a CUDA device) as <trace_dir>/<name>.json."""
        self.info(f"stage {name} ...")
        on_card = device is not None and torch.device(device).type == "cuda"
        ctx = contextlib.nullcontext()
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            ctx = torch.profiler.profile(activities=acts)
        extra = {}
        # CUDA that no stage has touched yet holds no memory to reset
        if on_card and torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        with ctx as prof:
            yield
            if on_card:
                torch.cuda.synchronize(device)
        dt = time.monotonic() - t0
        if on_card and torch.cuda.is_initialized():
            extra["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
        self.metric(f"stage/{name}/seconds", round(dt, 2), **extra)
        self.ok(f"stage {name} done in {dt:.1f}s")


log = Log()
