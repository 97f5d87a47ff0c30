"""Entry points of the serving path's kernels in the model's layout.

The model calls these (`repro_torch.models.attention`,
`repro_torch.models.ssm`), as the reference calls `repro.kernels.ops`.
The reference's attention wrappers transpose to [B, heads, seq, Dh], pad
to TPU blocks of ``bq``/``bkv`` rows and pick interpret mode off the
TPU; the port's kernels read the model's
[B, S, heads, Dh] layout through strides, pick their own 64-row tiles and
mask the ragged edge themselves. ``bq``/``bkv`` are accepted so that call
sites keep their shape, and ignored. The route follows the tensors'
device: kernels on CUDA tensors, their plain versions on CPU tensors,
and on meta tensors (the dry run, `repro_torch.launch.dryrun`) a
shape-only path that returns an empty output of the right shape and adds
the attention's matrix-product FLOPs to the active count
(`repro_torch.launch.hlo_analysis.add_flops`); no other device takes it.

`ssd_scan` keeps the reference's contract: it zero-pads the sequence to a
chunk multiple and cuts the padding off y. The kernel carries the state
in the model's [B,H,P,N] layout, so the reference's transposes to and
from the TPU kernel's [B,H,N,P] have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import _pad_seq


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, bq: int = 512,
                    bkv: int = 512) -> torch.Tensor:
    """FlashAttention forward. q: [B,Sq,H,Dh]; k,v: [B,Skv,G,Dh];
    returns [B,Sq,H,Dh]. Causal/window masks are positional with
    ``q_offset`` added to query positions (chunked prefill)."""
    del bq, bkv
    if q.device.type == "meta":
        return _shape_only(q, k.shape[1])
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, bkv: int = 512
                     ) -> torch.Tensor:
    """One-token attention against a cache. q: [B,1,H,Dh];
    k,v: [B,W,G,Dh]; valid: [B,W] int8 or bool. Returns [B,1,H,Dh]."""
    del bkv
    if q.device.type == "meta":
        return _shape_only(q, k.shape[1])
    if valid.dtype != torch.int8:
        valid = valid.to(torch.int8)
    return _decode.decode_attention(q, k, v, valid)


def _shape_only(q: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Meta tensors only: the attention output [B, Sq, H, Dh] (empty) and
    its two products' FLOPs, 2 x 2 B H Sq Skv Dh (every key, masked or
    not, as the reference's blockwise attention computes them)."""
    from repro_torch.launch.hlo_analysis import add_flops

    b, sq, h, dh = q.shape
    add_flops(4.0 * b * h * sq * kv_len * dh)
    return torch.empty_like(q)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba2), the contract of
    `repro_torch.models.ssm.ssd_chunked`: x [B,S,H,P]; dt [B,S,H]
    post-softplus; a [H] negative; b, c [B,S,G,N]; h0 [B,H,P,N] or None.
    Returns y [B,S,H,P] and h_last [B,H,P,N], float32. A sequence that is
    not a multiple of ``chunk`` is zero-padded, which is exact because the
    padded dt is 0 (decay exp(0) = 1, no state added)."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        y, h_last = _ssd.ssd_scan(*(_pad_seq(t, pad) for t in (x, dt)), a,
                                  *(_pad_seq(t, pad) for t in (b, c)),
                                  chunk, h0)
        return y[:, :s], h_last
    return _ssd.ssd_scan(x, dt, a, b, c, chunk, h0)
