"""Hour-by-hour feasible dispatch: the hand-written Hopper kernel and its
wrapper.

`dispatch_scan` runs ``csrc/dispatch_scan.cu`` (the port of the TPU
kernel ``repro/kernels/dispatch_scan.py::_dispatch_kernel``) on CUDA
tensors and the plain `repro_torch.kernels.ref.dispatch_ref` on CPU
tensors; the two agree bit for bit (one summation order, see
`repro_torch.kernels.ref.dispatch_alloc_hour`). There is no fallback: on
a CUDA tensor the kernel is built, launched and checked, or the call
raises; the plain version never runs on the card's data.
``dispatch_scan.launches`` counts kernel launches, and
``dispatch_scan.device_launches`` the kernels on the card (one a call).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dispatch_ref


def _library() -> ctypes.CDLL:
    lib = build.load("dispatch_scan")
    lib.dispatch_scan_f32.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.dispatch_scan_f32.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(
            f"dispatch_scan: {name} must be a contiguous {dtype} tensor of "
            f"shape {list(shape)} on {device}, got {x.dtype} "
            f"{list(x.shape)} on {x.device}")


def _launch(avail: torch.Tensor, rank: torch.Tensor, demand: torch.Tensor,
            min_dwell: int) -> torch.Tensor:
    if avail.ndim != 2:
        raise ValueError("dispatch_scan: avail must be [S, T], got "
                         f"{list(avail.shape)}")
    s, t = avail.shape
    if s == 0 or t == 0:
        raise ValueError("dispatch_scan: empty dispatch problem")
    if min_dwell < 0:
        raise ValueError(f"dispatch_scan: min_dwell must be >= 0, got "
                         f"{min_dwell}")
    dev = avail.device
    _check("avail", avail, torch.float32, (s, t), dev)
    _check("rank", rank, torch.int32, (t, 3 * s), dev)
    _check("demand", demand, torch.float32, (t,), dev)
    lib = _library()
    out = torch.empty((s, t), dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("dispatch_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dispatch_scan_f32(avail.data_ptr(), rank.data_ptr(),
                                    demand.data_ptr(), out.data_ptr(),
                                    s, t, int(min_dwell), stream)
    if err != 0:
        raise RuntimeError(f"dispatch_scan kernel launch failed: CUDA "
                           f"error {err}")
    dispatch_scan.launches += 1
    dispatch_scan.device_launches += \
        build.kernels_launched("dispatch_scan") - n0
    return out


def dispatch_scan(avail: torch.Tensor, rank: torch.Tensor,
                  demand: torch.Tensor, *, min_dwell: int = 0,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Feasible dispatch allocation. avail: [S, T] float32 MW; rank:
    [T, 3S] int32, the inverse of each hour's segment sort permutation
    (`repro_torch.dispatch.segment_rank`); demand: [T] float32 MW.
    Returns the allocation [S, T] float32 on the inputs' device.

    The route follows the tensors' device: CUDA tensors launch the
    kernel, CPU tensors run the plain `dispatch_ref`. ``use_kernel``
    only asserts the route: ``True`` raises on CPU tensors and ``False``
    raises on CUDA tensors, so the plain version never runs in place of
    the kernel on the card.
    """
    if use_kernel is not None and use_kernel != avail.is_cuda:
        raise ValueError(
            f"dispatch_scan(use_kernel={use_kernel}) on {avail.device} "
            "tensors: CUDA tensors launch the kernel and CPU tensors run "
            "the plain dispatch_ref; move the tensors instead")
    if not avail.is_cuda:
        return dispatch_ref(avail, rank, demand, min_dwell=int(min_dwell))
    return _launch(avail, rank, demand, int(min_dwell))


dispatch_scan.launches = 0
dispatch_scan.device_launches = 0
