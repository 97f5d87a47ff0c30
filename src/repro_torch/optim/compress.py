"""Int8 gradient compression with error feedback (mirrors
`repro.optim.compress`).

The reference targets the cross-pod gradient reduction: each pod
quantises its gradient to int8 with one float32 scale per tensor,
all-gathers the payload over the ``pod`` axis and de-quantise-sums it;
error feedback carries the quantisation residual into the next step. On
one device the trainer runs the quantise / de-quantise round trip with
``grad_compress``; the mean over an axis of the active mesh
(`compressed_pmean`, `compressed_pmean_leaf`, on `torch.distributed`
through `repro_torch.parallel.axes`) gathers the int8 payloads and their
scales.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map
from repro_torch.parallel.axes import all_gather


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


def compressed_pmean_leaf(g: torch.Tensor, err: torch.Tensor,
                          axis_name: str
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce one gradient leaf over ``axis_name`` of the active mesh
    on an int8 wire: every rank quantises, all-gathers the int8 payloads
    and the float32 scales, and de-quantise-sums them locally. Returns
    (mean in ``g``'s dtype, the new error feedback)."""
    q, scale, new_err = quantize_int8(g, err)
    qs = all_gather(q, axis_name)                      # [P, ...] int8 wire
    ss = all_gather(scale, axis_name)                  # [P] float32
    total = torch.tensordot(ss, qs.float(), dims=1)
    return (total / qs.shape[0]).to(g.dtype), new_err


def compressed_pmean(grads: Any, err: Any, axis_name: str
                     ) -> tuple[Any, Any]:
    """Tree-wide int8 error-feedback mean over ``axis_name``."""
    out = tree_map(lambda g, e: compressed_pmean_leaf(g, e, axis_name),
                   grads, err)
    return (tree_map(lambda _, pair: pair[0], grads, out),
            tree_map(lambda _, pair: pair[1], grads, out))
