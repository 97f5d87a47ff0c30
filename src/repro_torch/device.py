"""Where the port's tensors live.

Every entry point takes ``device=None``, which means ``"cuda"``. When CUDA
is not available the entry point raises and says to pass ``device="cpu"``:
the port never moves to the CPU on its own, so a run that was meant for
the card cannot quietly measure the host instead.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU "
            "(the port never falls back to the CPU on its own)")
    return dev


def float_dtype(x) -> torch.dtype:
    """The price model's dtype rule: float64 stays float64, anything
    else computes in float32."""
    dt = getattr(x, "dtype", None)
    if dt in (torch.float64, np.float64):
        return torch.float64
    return torch.float32


def as_tensor(x, device: DeviceLike = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (array-like or tensor) on the resolved device, in ``dtype``
    (default: `float_dtype`)."""
    dev = resolve_device(device)
    return torch.as_tensor(x, dtype=dtype or float_dtype(x), device=dev)
