"""3D max/avg pooling, stride 1, 'same' padding (port of
monohair_tpu/ops/pool3d.py): the F.max_pool3d/avg_pool3d shell-sampling
primitives of the reference (PMVO_utils.py:217-252 `SamplePointsAroundVolume`,
sampleOcc.py:141-146), on an (X, Y, Z) volume viewed as (1, 1, X, Y, Z)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _volume_op(op, vol: torch.Tensor, kernel: int, **kw) -> torch.Tensor:
    return op(vol[None, None], kernel, stride=1, padding=kernel // 2, **kw)[0, 0]


def max_pool3d(vol: torch.Tensor, kernel: int) -> torch.Tensor:
    """(X, Y, Z) max pool, stride 1, same padding (the padding never wins)."""
    return _volume_op(F.max_pool3d, vol, kernel)


def avg_pool3d(vol: torch.Tensor, kernel: int) -> torch.Tensor:
    """(X, Y, Z) average pool, stride 1, same padding; the padded zeros count
    in the denominator (count_include_pad=True, torch's default)."""
    return _volume_op(F.avg_pool3d, vol, kernel, count_include_pad=True)


def close_volume(occ: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Morphological closing: dilate (max), then keep only the voxels the
    dilation covers fully (avg == 1) (PMVO_utils.py:220-223)."""
    closed = avg_pool3d(max_pool3d(occ, kernel), kernel)
    return torch.where(closed < 1.0, torch.zeros_like(closed), closed)


def shell_voxels(occ: torch.Tensor, kernel: int = 3, close: bool = True,
                 erosion: bool = False) -> torch.Tensor:
    """The one-ring shell around the occupied volume (PMVO_utils.py:217-238):
    dilate(occ) - occ, optionally on the closed volume, optionally adding the
    eroded boundary."""
    if close:
        occ = close_volume(occ, kernel)
    shell = max_pool3d(occ, kernel) - occ
    if erosion:
        er = avg_pool3d(occ, 3)
        er = torch.where(er < 1.0, torch.zeros_like(er), er)
        shell = shell + (occ - er)
    return shell
