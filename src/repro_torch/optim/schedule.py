"""Learning-rate schedules (pure functions of the step counter), in
float32 as the reference's (`repro.optim.schedule`).

The cosine is the C library's ``cosf``, elementwise on the host: it is
the function XLA's CPU backend runs for the reference's ``jnp.cos``, and
PyTorch's float32 cosine differs from it in the last place at some
arguments, so the schedule would drift from the reference's by an ulp.
A schedule is a host scalar per step, so nothing runs on the card.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.argtypes = [ctypes.c_float]
    lib.cosf.restype = ctypes.c_float
    return lib.cosf


def _cosf(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine of a CPU float32 tensor by the C library's cosf."""
    cosf = _libm_cosf()
    return torch.tensor([cosf(v) for v in x.reshape(-1).tolist()],
                        dtype=torch.float32).reshape(x.shape)


def warmup_cosine(step, base_lr: float, warmup_steps: int,
                  total_steps: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac * base_lr``; a
    float32 CPU tensor of ``step``'s shape (an int or a tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac)
                     * 0.5 * (1.0 + _cosf(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, base_lr: float) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32,
                                           device="cpu"), base_lr)
