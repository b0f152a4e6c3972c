"""Stage 1's bust: the SMPL-X bust fit (model, soft rasteriser, losses and
Adam fit, the fit_bust step) and the fitted-transform application."""

from typing import Callable, Dict, Tuple

import numpy as np
import torch

_CONSTANTS: Dict[Tuple[str, str], torch.Tensor] = {}


def device_constant(key: str, device, make: Callable[[], np.ndarray]) -> torch.Tensor:
    """`make()` as a tensor on `device`, copied there once: a copy from the
    host in every step of the fit would wait for the card each time."""
    k = (key, str(torch.device(device)))
    if k not in _CONSTANTS:
        _CONSTANTS[k] = torch.as_tensor(make(), device=device)
    return _CONSTANTS[k]
