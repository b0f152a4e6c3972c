"""The PMVO line search's two kernels: CUDA on the card, plain PyTorch beside.

``patch_gather`` replaces ``patch_gather_dma`` and ``patch_min_loss`` replaces
``patch_min_loss_fused`` (monohair_tpu/ops/pallas_kernels.py). The kernels are
in ``csrc/patch_kernels.cu``; ``*_plain`` are line-for-line ports of the JAX
``*_reference`` functions.

Dispatch is by the tensors' device alone: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

SOURCE = "patch_kernels.cu"
LAUNCHES = {"patch_gather": 0, "patch_gather_bf16": 0, "patch_min_loss": 0}

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures set
    (pointers and the stream as c_void_p, so ctypes does not cut them)."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        for fn in (lib.patch_gather, lib.patch_gather_bf16):
            fn.argtypes = [_c_ptr, _c_ptr, _c_ptr] + [_c_int] * 5 + [_c_ptr]
            fn.restype = _c_int
        lib.patch_min_loss.argtypes = ([_c_ptr] * 4 + [ctypes.c_float] + [_c_ptr] * 3
                                       + [_c_int] * 4 + [_c_ptr])
        lib.patch_min_loss.restype = _c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# patch gather
# ---------------------------------------------------------------------------

def patch_gather_plain(padded_maps: torch.Tensor, rc: torch.Tensor,
                       patch_size: int) -> torch.Tensor:
    """Port of ``patch_gather_reference`` and the f32 cast after it: (V, Hp,
    Wp, C) edge-padded maps and (V, N, 2) clamped centres -> (V, N,
    patch_size**2, C) f32 (bf16 maps are gathered, then upcast exactly)."""
    offs = torch.arange(patch_size, device=rc.device)
    orow = offs.repeat_interleave(patch_size)
    ocol = offs.repeat(patch_size)
    rows = rc[..., 0:1].long() + orow          # padded coords: centre rc -> rc + off
    cols = rc[..., 1:2].long() + ocol
    views = torch.arange(padded_maps.shape[0], device=rc.device)[:, None, None]
    return padded_maps[views, rows, cols].float()


def patch_gather(padded_maps: torch.Tensor, rc: torch.Tensor,
                 patch_size: int) -> torch.Tensor:
    """Gather (patch x patch) windows of an 8-channel edge-padded map.

    padded_maps: (V, H + patch - 1, W + patch - 1, 8) f32 or bf16 (the maps of
    PMVO.bf16_maps); rc: (V, N, 2) int32 window centres in unpadded
    coordinates, already clamped. Returns (V, N, patch**2, 8) f32, taps in
    row-major offset order. On the card f32 and bf16 maps each have a kernel;
    another dtype raises a TypeError.
    """
    if padded_maps.device.type == "cpu":
        return patch_gather_plain(padded_maps, rc, patch_size)
    if padded_maps.device.type != "cuda":
        raise ValueError(f"patch_gather: unsupported device {padded_maps.device}")
    V, Hp, Wp, C = padded_maps.shape
    if C != 8:
        raise ValueError(f"patch_gather: the kernel takes 8 channels, got {C}")
    N = rc.shape[1]
    kernel = {torch.float32: "patch_gather", torch.bfloat16: "patch_gather_bf16"}.get(
        padded_maps.dtype)
    if kernel is None:
        raise TypeError(f"patch_gather: the kernels take f32 or bf16 maps, got "
                        f"{padded_maps.dtype}")
    _check("padded_maps", padded_maps, padded_maps.dtype, (V, Hp, Wp, 8), padded_maps.device)
    _check("rc", rc, torch.int32, (V, N, 2), padded_maps.device)
    P = patch_size * patch_size
    if V * N * P * 8 >= 2 ** 31 or V * Hp * Wp * 8 >= 2 ** 31:
        raise ValueError("patch_gather: more than 2**31 elements")
    out = torch.empty((V, N, P, 8), dtype=torch.float32, device=padded_maps.device)
    with torch.cuda.device(padded_maps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), kernel)(padded_maps.data_ptr(), rc.data_ptr(), out.data_ptr(),
                                      V, N, Hp, Wp, patch_size, stream)
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    return out


# ---------------------------------------------------------------------------
# tap loop + view reduction
# ---------------------------------------------------------------------------

def patch_min_loss_plain(prj_dir: torch.Tensor, ori_patch: torch.Tensor,
                         conf_patch: torch.Tensor, visible: torch.Tensor,
                         conf_threshold: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Port of ``patch_min_loss_reference``. Norms and dot products are written
    out as single products and sums, the order the kernel uses too."""
    prj_r, prj_c = prj_dir[..., 0], prj_dir[..., 1]
    prnorm = torch.sqrt(prj_r * prj_r + prj_c * prj_c)
    high_conf = (torch.amax(conf_patch, -1) > conf_threshold)[..., None]

    def tap(p):
        o_r = ori_patch[:, :, p, 0][..., None]
        o_c = ori_patch[:, :, p, 1][..., None]
        cosv = o_r * prj_r + o_c * prj_c
        denom = torch.clamp_min(torch.sqrt(o_r * o_r + o_c * o_c) * prnorm, 1e-8)
        return 1.0 - torch.abs(cosv) / denom, conf_patch[:, :, p][..., None]

    min_loss, conf0 = tap(0)
    best_conf = conf0 * torch.ones_like(min_loss)
    for p in range(1, ori_patch.shape[2]):
        loss_p, conf_p = tap(p)
        better = loss_p < min_loss
        take = torch.where(high_conf, better & (conf_p > conf_threshold), better)
        min_loss = torch.where(take, loss_p, min_loss)
        best_conf = torch.where(take, conf_p * torch.ones_like(loss_p), best_conf)
    weight = torch.where(visible[:, :, None] == -1.0, 0.0, 1.0) * best_conf
    return (torch.sum(weight * min_loss, 0), torch.sum(weight, 0),
            torch.sum((weight > 0).float(), 0))


# the tap-loop kernel's limits, as patch_kernels.cu's launcher sets them: the
# counts are written as f32, exact up to 2**24 views (up to 1023 views they are
# packed 10 bits each into one register, beyond that each has its own); a
# warp's windows live in the default 48 KB of dynamic shared memory, or, when
# they need more, in what a block may opt in to (227 KB on the H100). The
# launcher refuses more with cudaErrorInvalidValue.
MAX_VIEWS = 2 ** 24
SMEM_OPTIN = 227 * 1024


def check_min_loss_limits(V: int, S: int, P: int) -> None:
    """Raise a ValueError naming the limit when the tap-loop kernel cannot
    take V views, S samples and P taps (the plain version takes any). The
    shared-memory budget is the launcher's: a warp stages the windows of G
    points, each (P | 1) float4 taps and one int of flags, where G is 1 for
    S > 16 and min(16, 32 / L) for L, the power of two >= S, otherwise."""
    if V > MAX_VIEWS:
        raise ValueError(f"patch_min_loss: the CUDA kernel takes at most {MAX_VIEWS} "
                         f"views (counts exact in f32), got {V}")
    G = 1
    if S <= 16:
        L = 1
        while L < S:
            L *= 2
        G = min(16, 32 // L)
    per_warp = G * ((P | 1) * 16 + 4)
    if per_warp > SMEM_OPTIN:
        raise ValueError(
            f"patch_min_loss: the CUDA kernel's shared-memory budget is {SMEM_OPTIN} "
            f"bytes a warp (the H100's opt-in limit of a block); S={S} samples and "
            f"P={P} taps need {per_warp} ({G} windows of {P | 1} taps x 16 bytes "
            f"+ 4 bytes of flags)")


def patch_min_loss(prj_dir: torch.Tensor, ori_patch: torch.Tensor,
                   conf_patch: torch.Tensor, visible: torch.Tensor,
                   conf_threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused tap loop + view reduction.

    prj_dir: (V, N, S, 2); ori_patch: (V, N, P, 2); conf_patch: (V, N, P);
    visible: (V, N), all f32. Returns (sum_v weight*min_loss, sum_v weight,
    #(weight > 0)), each (N, S).
    """
    dev = prj_dir.device
    if dev.type == "cpu":
        return patch_min_loss_plain(prj_dir, ori_patch, conf_patch, visible,
                                    conf_threshold)
    if dev.type != "cuda":
        raise ValueError(f"patch_min_loss: unsupported device {dev}")
    V, N, S, _ = prj_dir.shape
    P = ori_patch.shape[2]
    _check("prj_dir", prj_dir, torch.float32, (V, N, S, 2), dev)
    _check("ori_patch", ori_patch, torch.float32, (V, N, P, 2), dev)
    _check("conf_patch", conf_patch, torch.float32, (V, N, P), dev)
    _check("visible", visible, torch.float32, (V, N), dev)
    if P < 1 or V * N * max(S, P) * 2 >= 2 ** 31:
        raise ValueError(f"patch_min_loss: unsupported sizes V={V} N={N} S={S} P={P}")
    check_min_loss_limits(V, S, P)
    num = torch.empty((N, S), dtype=torch.float32, device=dev)
    den = torch.empty_like(num)
    cnt = torch.empty_like(num)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().patch_min_loss(prj_dir.data_ptr(), ori_patch.data_ptr(),
                                    conf_patch.data_ptr(), visible.data_ptr(),
                                    float(conf_threshold), num.data_ptr(), den.data_ptr(),
                                    cnt.data_ptr(), V, N, S, P, stream)
    _raise_on(err, "patch_min_loss")
    LAUNCHES["patch_min_loss"] += 1
    return num, den, cnt
