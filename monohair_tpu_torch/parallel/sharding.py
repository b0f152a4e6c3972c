"""Point-axis sharding over the local devices of one process (port of
monohair_tpu/parallel/sharding.py).

The JAX package shards each PMVO chunk and each MVS batch along its leading
(point) axis over a one-process `jax.sharding.Mesh` of local devices, with the
per-view maps replicated. Its counterpart here is one process over a tuple of
`torch.device`s, with no `torch.distributed`: `shard_batch` cuts the leading
axis into one contiguous slice per device, each slice runs on its own device,
and the caller concatenates the results in shard order. Every result is per
point, so a mesh of k shards gives the unsharded results bit for bit. The MVS
nets' batches go to the devices whole instead (mvs/eval.py says why).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Mesh = Tuple[torch.device, ...]


def data_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The local CUDA devices (the first `num_devices` of them)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("data_mesh: no CUDA device")
    if num_devices is not None:
        if not 1 <= num_devices <= n:
            raise ValueError(f"data_mesh: {num_devices} devices asked, {n} present")
        n = num_devices
    return tuple(torch.device("cuda", i) for i in range(n))


def shard_batch(x: torch.Tensor, mesh: Optional[Sequence[torch.device]]
                ) -> List[torch.Tensor]:
    """`x` cut along its leading axis into one contiguous slice per device of
    the mesh (sizes differ by at most one), each on its device; [x] as it is
    without a mesh."""
    if mesh is None:
        return [x]
    return [s.to(d) for s, d in zip(torch.tensor_split(x, len(mesh)), mesh)]


def _to(obj: Any, device: torch.device) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, torch.nn.Module):
        first = next(iter(obj.parameters()), None)
        return obj if first is None or first.device == device else copy.deepcopy(obj).to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


def replicate(obj: Any, mesh: Optional[Sequence[torch.device]]) -> Tuple[Any, ...]:
    """One copy of `obj` (tensors, dataclasses such as PMVOMaps, named tuples,
    lists, dicts and modules, nested) on each device of the mesh, made once: a
    device named twice shares its copy, and a device that already holds the
    object gets it as it is. Without a mesh: (obj,)."""
    if mesh is None:
        return (obj,)
    copies: Dict[torch.device, Any] = {}
    for d in mesh:
        if d not in copies:
            copies[d] = _to(obj, d)
    return tuple(copies[d] for d in mesh)


def concat_shards(outs: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """The per-shard results of one call (each a sequence of tensors) joined
    in shard order, on the host."""
    return [torch.cat([o[i].cpu() for o in outs]) for i in range(len(outs[0]))]
