"""Entry points of the attention kernels in the model's layout.

The model calls these (`repro_torch.models.attention`), as the reference
calls `repro.kernels.ops`. The reference's wrappers transpose to
[B, heads, seq, Dh], pad to TPU blocks of ``bq``/``bkv`` rows and pick
interpret mode off the TPU; the port's kernels read the model's
[B, S, heads, Dh] layout through strides, pick their own 64-row tiles and
mask the ragged edge themselves. ``bq``/``bkv`` are accepted so that call
sites keep their shape, and ignored. The route follows the tensors'
device: kernels on CUDA tensors, their plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, bq: int = 512,
                    bkv: int = 512) -> torch.Tensor:
    """FlashAttention forward. q: [B,Sq,H,Dh]; k,v: [B,Skv,G,Dh];
    returns [B,Sq,H,Dh]. Causal/window masks are positional with
    ``q_offset`` added to query positions (chunked prefill)."""
    del bq, bkv
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, bkv: int = 512
                     ) -> torch.Tensor:
    """One-token attention against a cache. q: [B,1,H,Dh];
    k,v: [B,W,G,Dh]; valid: [B,W] int8 or bool. Returns [B,1,H,Dh]."""
    del bkv
    if valid.dtype != torch.int8:
        valid = valid.to(torch.int8)
    return _decode.decode_attention(q, k, v, valid)
