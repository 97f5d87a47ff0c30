"""The Mamba2 SSD chunk scan: the hand-written Hopper kernel and its
wrapper.

`ssd_scan` runs ``ssd_scan_fwd`` of ``csrc/ssd_scan.cu`` (the port of the
TPU kernel ``repro/kernels/ssd_scan.py::_ssd_kernel``) on CUDA tensors and
the plain `repro_torch.kernels.ref.ssd_scan_plain` on CPU tensors. The
two run the same three passes (chunk states, the sequential state pass,
chunk outputs) with the same casts and the state in the same [B,H,P,N]
layout, so they differ only in the order of float32 sums. There is no
fallback: on a CUDA tensor the kernel is built, launched and checked, or
the call raises. With bf16 x, B and C every product of the kernel runs on
the tensor cores, a float32 operand in three bf16 parts (float32
accuracy); float32 inputs run on the CUDA cores. The kernel is forward
only. ``ssd_scan.launches`` counts
the wrapper's calls that launch, ``ssd_scan.device_launches`` the kernels
they put on the card (three a call, one for each pass).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES, refuse_grad
from repro_torch.kernels.ref import ssd_scan_plain

MAX_CHUNK = 4096     # the chunk's dt and cum live in shared memory


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib


def _check(x, dt, a, b, c, chunk: int, h0) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b.ndim != 4 \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan: expected x [B,S,H,P], dt [B,S,H], a "
                         f"[H], b and c [B,S,G,N]; got {list(x.shape)}, "
                         f"{list(dt.shape)}, {list(a.shape)}, "
                         f"{list(b.shape)}, {list(c.shape)}")
    bsz, s, nh, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(dt.shape) != (bsz, s, nh) or tuple(a.shape) != (nh,) \
            or tuple(b.shape[:2]) != (bsz, s) or g == 0 or nh % g:
        raise ValueError(f"ssd_scan: shapes disagree: x {list(x.shape)}, "
                         f"dt {list(dt.shape)}, a {list(a.shape)}, b "
                         f"{list(b.shape)} ({nh} heads in {g} groups)")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_scan: b and c must be x's dtype {x.dtype}, "
                         f"got {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and a must be float32, got "
                         f"{dt.dtype}, {a.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c), ("a", a)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: the last dimension of {name} must "
                             "be contiguous")
    if not 0 < chunk <= MAX_CHUNK or s == 0 or s % chunk:
        raise ValueError(f"ssd_scan: the sequence ({s}) must be a positive "
                         f"multiple of the chunk ({chunk}, at most "
                         f"{MAX_CHUNK}); pad it (`repro_torch.kernels.ops."
                         f"ssd_scan` does)")
    if h0 is not None and (tuple(h0.shape) != (bsz, nh, p, n)
                           or h0.device != x.device):
        raise ValueError(f"ssd_scan: h0 must be [B,H,P,N] = "
                         f"{[bsz, nh, p, n]} on {x.device}, got "
                         f"{list(h0.shape)} on {h0.device}")


def _launch(x, dt, a, b, c, chunk: int, h0
            ) -> tuple[torch.Tensor, torch.Tensor]:
    _check(x, dt, a, b, c, chunk, h0)
    bsz, s, nh, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    lib = _library()
    y = torch.empty((bsz, s, nh, p), dtype=torch.float32, device=dev)
    h_last = torch.empty((bsz, nh, p, n), dtype=torch.float32, device=dev)
    cum = torch.empty((bsz, nh, s), dtype=torch.float32, device=dev)
    st = torch.empty((bsz, nh, s // chunk, n, p), dtype=torch.float32,
                     device=dev)
    h0c = None if h0 is None else h0.to(torch.float32).contiguous()
    strides = [st_ for t in (x, dt, b, c) for st_ in t.stride()[:3]]
    n0 = build.kernels_launched("ssd_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if h0c is None else h0c.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), cum.data_ptr(), st.data_ptr(),
            DTYPE_CODES[x.dtype], bsz, s, nh, g, p, n, chunk, *strides,
            stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    ssd_scan.device_launches += build.kernels_launched("ssd_scan") - n0
    return y, h_last


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None, *,
             use_kernel: Optional[bool] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunk scan. x: [B,S,H,P] (float32 or bfloat16); dt: [B,S,H]
    float32 (post-softplus); a: [H] float32 (negative); b, c: [B,S,G,N]
    in x's dtype; h0: [B,H,P,N] or None. S must be a multiple of
    ``chunk`` on the kernel's route (`repro_torch.kernels.ops.ssd_scan`
    pads). Returns y [B,S,H,P] and h_last [B,H,P,N], float32.

    The route follows the tensors' device: CUDA tensors launch the kernel,
    CPU tensors run the plain `ssd_scan_plain`. ``use_kernel`` only
    asserts the route. On CUDA tensors it is forward only: inputs that
    require grad, with grad mode on, raise.
    """
    if use_kernel is not None and use_kernel != x.is_cuda:
        raise ValueError(
            f"ssd_scan(use_kernel={use_kernel}) on {x.device} tensors: CUDA "
            "tensors launch the kernel and CPU tensors run the plain "
            "version; move the tensors instead")
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, a, b, c, int(chunk), h0)
    refuse_grad("ssd_scan", x, dt, a, b, c, h0)
    return _launch(x, dt, a, b, c, int(chunk), h0)


ssd_scan.launches = 0
ssd_scan.device_launches = 0
