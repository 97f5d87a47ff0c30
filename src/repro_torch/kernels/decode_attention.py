"""Single-token attention over a KV cache: the hand-written Hopper kernel
and its wrapper.

`decode_attention` runs ``decode_attention_fwd`` of ``csrc/attention.cu``
(the port of the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``) on CUDA tensors
and the plain `repro_torch.kernels.ref.decode_attention_plain` on CPU
tensors, with the same tiles, skip of tiles that hold no valid slot,
splits of the cache, casts and int8 validity mask. There is no fallback:
on a CUDA tensor the kernel is built, launched and checked, or the call
raises. ``decode_attention.launches`` counts kernel launches,
``decode_attention.device_launches`` the kernels on the card (one a
call: the splits fold in the same launch).

The kernel folds its splits in the same launch: the block that takes the
last ticket on a (batch row, group) counter folds them and resets the
counter. The counters live in one int32 buffer per (device, stream),
made by ``torch.zeros`` and left at 0 by every call, so no call clears
them and calls on two streams never share one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPE_CODES,
                                                 check_operands, refuse_grad,
                                                 vectorizable)
from repro_torch.kernels.ref import DECODE_SPLIT, decode_attention_plain

MAX_HEADS_PER_GROUP = 32

# (device index, stream handle) -> int32 ticket counters, all 0 between calls
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    lib = build.load("attention")
    lib.decode_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p])
    lib.decode_attention_fwd.restype = ctypes.c_int
    return lib


def _ticket_counters(device: torch.device, stream: int, n: int
                     ) -> torch.Tensor:
    """The ticket counters of ``stream`` on ``device``, at least ``n`` of
    them, all 0: allocated with ``torch.zeros`` on first use and regrown
    (to zeros) when a call has more (batch row, group) pairs."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        size = n if buf is None else max(n, 2 * buf.numel())
        buf = _counters[key] = torch.zeros(size, dtype=torch.int32,
                                           device=device)
    return buf


def _launch(q, k, v, valid) -> torch.Tensor:
    check_operands("decode_attention", q, (k, v), ("k", "v"))
    b, sq, h, dh = q.shape
    w, g = k.shape[1], k.shape[2]
    if sq != 1 or k.shape != v.shape or w == 0:
        raise ValueError(f"decode_attention: q must be [B, 1, H, Dh] and "
                         f"k, v one [B, W, G, Dh] shape, got q "
                         f"{list(q.shape)}, k {list(k.shape)}, v "
                         f"{list(v.shape)}")
    if h // g > MAX_HEADS_PER_GROUP:
        raise ValueError(f"decode_attention: {h // g} query heads per KV "
                         f"group; the kernel takes at most "
                         f"{MAX_HEADS_PER_GROUP}")
    if valid.dtype != torch.int8 or tuple(valid.shape) != (b, w) \
            or valid.stride(-1) != 1 or valid.device != q.device:
        raise ValueError(f"decode_attention: valid must be int8 [B, W] = "
                         f"{[b, w]} with a contiguous last dimension on "
                         f"{q.device}, got {valid.dtype} "
                         f"{list(valid.shape)} on {valid.device}")
    lib = _library()
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    n_split = -(-w // DECODE_SPLIT)
    r = h // g
    # scratch of the splits: acc [B, G, n, R, Dh] first (16-byte aligned),
    # then m and l [B, G, n, R]
    n_ml = b * g * n_split * r
    part = torch.empty((n_ml * (dh + 2),) if n_split > 1 else (0,),
                       dtype=torch.float32, device=q.device)
    n0 = build.kernels_launched("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = ((part.data_ptr() + 4 * n_ml * dh,
                 part.data_ptr() + 4 * n_ml * (dh + 1), part.data_ptr(),
                 _ticket_counters(q.device, stream, b * g).data_ptr())
                if n_split > 1 else (None,) * 4)
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), *ptrs, DTYPE_CODES[q.dtype], b, w, h, g, dh,
            q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            valid.stride(0), int(vectorizable(q, k, v)), dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    decode_attention.device_launches += \
        build.kernels_launched("attention") - n0
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """One query token per row against a cache. q: [B,1,H,Dh];
    k,v: [B,W,G,Dh]; valid: [B,W] int8 (nonzero = the slot holds a key
    this token may see). Returns [B,1,H,Dh] in q's dtype.

    The route follows the tensors' device: CUDA tensors launch the kernel,
    CPU tensors run the plain `decode_attention_plain`. ``use_kernel``
    only asserts the route. On CUDA tensors it is forward only: inputs
    that require grad, with grad mode on, raise.
    """
    if use_kernel is not None and use_kernel != q.is_cuda:
        raise ValueError(
            f"decode_attention(use_kernel={use_kernel}) on {q.device} "
            "tensors: CUDA tensors launch the kernel and CPU tensors run "
            "the plain version; move the tensors instead")
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, valid)
    refuse_grad("decode_attention", q, k, v)
    return _launch(q, k, v, valid)


decode_attention.launches = 0
decode_attention.device_launches = 0
