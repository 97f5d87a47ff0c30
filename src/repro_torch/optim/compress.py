"""Int8 gradient compression with error feedback (mirrors
`repro.optim.compress`).

The reference targets the cross-pod gradient reduction: each pod
quantises its gradient to int8 with one float32 scale per tensor,
all-gathers the payload over the ``pod`` axis and de-quantise-sums it;
error feedback carries the quantisation residual into the next step. On
one device only the quantise / de-quantise round trip exists, which the
trainer runs with ``grad_compress``. The reductions over a mesh axis
(`compressed_pmean`, `compressed_pmean_leaf`) come with the mesh slice.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map


def quantize_int8(x: torch.Tensor, err: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantisation; returns (q int8, scale float32
    scalar, new_err float32 like x). Rounds half to even, as the
    reference's ``jnp.round``."""
    xf = x.float() + err
    scale = torch.max(torch.abs(xf)) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    new_err = xf - q.float() * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _needs_mesh(name: str):
    raise NotImplementedError(
        f"{name} reduces over a mesh axis, which comes with the mesh slice "
        "(ROADMAP queue 1 item 9); on one device use quantize_int8 and "
        "dequantize")


def compressed_pmean_leaf(g: torch.Tensor, err: torch.Tensor,
                          axis_name: str):
    """Mean-reduce one gradient leaf over ``axis_name`` on an int8 wire:
    not ported (needs a mesh)."""
    _needs_mesh("compressed_pmean_leaf")


def compressed_pmean(grads: Any, err: Any, axis_name: str):
    """Tree-wide int8 error-feedback mean over ``axis_name``: not ported
    (needs a mesh)."""
    _needs_mesh("compressed_pmean")
