"""FlashAttention forward: the hand-written Hopper kernel and its wrapper.

`flash_attention` runs ``flash_attention_fwd`` of ``csrc/attention.cu``
(the port of the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``) on CUDA tensors and
the plain `repro_torch.kernels.ref.flash_attention_plain` on CPU tensors.
The two share their tiles, their skip of masked tiles and their casts
(scores and carry in float32, p rounded to v's type for p.v, the output
in q's type), so they differ only in the order of float32 sums (bf16
inputs run on the tensor cores, whose bf16 products are exact in
float32). There is
no fallback: on a CUDA tensor the kernel is built, launched and checked,
or the call raises. ``flash_attention.launches`` counts kernel launches,
``flash_attention.device_launches`` the kernels on the card (one a call).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_plain

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def _library() -> ctypes.CDLL:
    lib = build.load("attention")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def check_operands(name: str, q: torch.Tensor, kv: tuple,
                   kv_names: tuple) -> None:
    """Raise on what the attention kernels do not take: another device or
    dtype than q's, a dtype other than float32/bfloat16, a head dim other
    than 16/32/64/128, a last dimension that is not contiguous, or a head
    count that is not a multiple of the KV groups."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.ndim != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: q must be [B, S, H, Dh] with Dh in "
                         f"{HEAD_DIMS}, got {list(q.shape)}")
    for n, x in zip(("q",) + kv_names, (q,) + kv):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: {n} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
        if x.ndim != 4 or x.shape[-1] != q.shape[-1] \
                or x.shape[0] != q.shape[0]:
            raise ValueError(f"{name}: {n} has shape {list(x.shape)}, "
                             f"q {list(q.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension of {n} must be "
                             "contiguous")
    h, g = q.shape[2], kv[0].shape[2]
    if g == 0 or h % g != 0:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{g} KV groups")


def refuse_grad(name: str, *xs) -> None:
    """Raise where grad mode is on and an input requires grad: the kernels
    are forward only (they save no residuals and have no backward), so a
    result would come back with no autograd history and the gradient would
    be lost without a word. Their plain versions, on CPU tensors, are
    PyTorch operations and do carry gradients."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        raise ValueError(
            f"{name} on CUDA tensors is forward only (the kernel has no "
            "backward): detach the inputs, or run under torch.no_grad()")


def vectorizable(*xs: torch.Tensor) -> bool:
    """True where every row of every tensor starts on a 16-byte boundary,
    so the kernels may load 16 bytes at a time."""
    for x in xs:
        e = x.element_size()
        if x.data_ptr() % 16 or any((s * e) % 16 for s in x.stride()[:-1]):
            return False
    return True


def _launch(q, k, v, causal: bool, window: int, q_offset: int
            ) -> torch.Tensor:
    check_operands("flash_attention", q, (k, v), ("k", "v"))
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {list(k.shape)} and v "
                         f"{list(v.shape)} differ")
    b, sq, h, dh = q.shape
    skv, g = k.shape[1], k.shape[2]
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention: empty query or key sequence")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window {window} and q_offset "
                         f"{q_offset} must be >= 0")
    lib = _library()
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    n0 = build.kernels_launched("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, sq, skv, h, g, dh, *strides,
            int(causal), int(window), int(q_offset),
            int(vectorizable(q, k, v)), dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.device_launches += build.kernels_launched("attention") - n0
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """FlashAttention forward. q: [B,Sq,H,Dh]; k,v: [B,Skv,G,Dh], the
    model's layout, read through their strides; returns [B,Sq,H,Dh] in
    q's dtype. Causal and window masks are positional, with ``q_offset``
    added to the query positions (chunked prefill).

    The route follows the tensors' device: CUDA tensors launch the kernel,
    CPU tensors run the plain `flash_attention_plain`. ``use_kernel``
    only asserts the route: ``True`` raises on CPU tensors and ``False``
    on CUDA tensors. On CUDA tensors it is forward only: inputs that
    require grad, with grad mode on, raise (`refuse_grad`).
    """
    if use_kernel is not None and use_kernel != q.is_cuda:
        raise ValueError(
            f"flash_attention(use_kernel={use_kernel}) on {q.device} "
            "tensors: CUDA tensors launch the kernel and CPU tensors run "
            "the plain version; move the tensors instead")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     window=int(window),
                                     q_offset=int(q_offset))
    refuse_grad("flash_attention", q, k, v)
    return _launch(q, k, v, causal, int(window), int(q_offset))


flash_attention.launches = 0
flash_attention.device_launches = 0
