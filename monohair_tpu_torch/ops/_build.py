"""Build the port's native sources and load them with ctypes.

Each source under ``monohair_tpu_torch/csrc/`` compiles at first use into a
shared library with a C interface, in ``build/monohair_tpu_torch/`` at the
repository root (git-ignored): CUDA sources (``.cu``) with plain nvcc for
sm_90a, host C++ sources (``.cpp``) with g++. The library's name carries a
hash of the source, of the headers beside it (``csrc/*.h``, which the
sources include) and of the flags (for host C++ also of the CPU that
-march=native targets), so an unchanged source is not rebuilt, and
it is renamed into place atomically, so concurrent builds (test workers) see
all or nothing. A failed build raises with the compiler's output; there is no
fallback. torch.utils.cpp_extension is not used: a file that includes
PyTorch's headers takes minutes to compile, this takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "monohair_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The JAX package's flags for the same C++ (monohair_tpu/native/__init__.py),
# so that both libraries give the same bits: -march=native lets g++ contract
# a * b + c into fused multiply-adds, which changes the results. A library
# built for one CPU may not run on another, so the name of a host library also
# hashes what -march=native means on this CPU (native_target).
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}
# per source: {"seconds": nvcc wall time (0.0 when the cached build was used),
# "log": nvcc's output, "path": the library}
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return nvcc


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return gxx


@functools.lru_cache(maxsize=1)
def native_target() -> str:
    """The -m flags that -march=native expands to on this host, as g++ -v
    reports them to its compiler proper."""
    proc = subprocess.run([find_gxx(), "-march=native", "-E", "-v", "-x", "c++",
                           os.devnull, "-o", os.devnull], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ -march=native -v failed:\n{proc.stderr}")
    return " ".join(f for line in proc.stderr.splitlines() if "cc1plus" in line
                    for f in line.split() if f.startswith("-m"))


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash exists."""
    src = CSRC_DIR / source
    cuda = src.suffix == ".cu"
    flags = NVCC_FLAGS if cuda else GXX_FLAGS
    target = "" if cuda else native_target()
    headers = b"".join(h.name.encode() + h.read_bytes() for h in sorted(CSRC_DIR.glob("*.h")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()
                            + target.encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        BUILD_INFO.setdefault(source, {"seconds": 0.0, "log": "", "path": str(lib)})
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc() if cuda else find_gxx(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}) for {src}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    BUILD_INFO[source] = {"seconds": seconds, "log": log, "path": str(lib)}
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build(source)))
    return _LOADED[source]
