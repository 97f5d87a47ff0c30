"""Batched hysteresis scan: the hand-written Hopper kernel and its wrapper.

`fleet_scan` runs ``csrc/fleet_scan.cu`` (the port of the TPU kernel
``repro/kernels/fleet_scan.py::_fleet_kernel``) on CUDA tensors and the
plain `repro_torch.kernels.ref.fleet_scan_ref` on CPU tensors. There is
no fallback: on a CUDA tensor the kernel is built, launched and checked,
or the call raises. ``fleet_scan.launches`` counts the wrapper's calls
that launch, ``fleet_scan.device_launches`` the kernels they put on
the card (two a call: the chunk pass and the stitch).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import FleetScanOut, fleet_scan_ref

CHUNK_HOURS = 256   # hours per pass-1 chunk (a multiple of the 32-hour tile)


def _library() -> ctypes.CDLL:
    lib = build.load("fleet_scan")
    lib.fleet_scan_f32.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fleet_scan_f32.restype = ctypes.c_int
    lib.fleet_scan_scratch_floats.argtypes = [ctypes.c_int] * 2
    lib.fleet_scan_scratch_floats.restype = ctypes.c_longlong
    return lib


def _row_param(v, b: int, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        if v.device != device or v.dtype != torch.float32:
            raise ValueError("fleet_scan: parameters must be float32 "
                             f"tensors on {device} (or Python numbers), "
                             f"got {v.dtype} on {v.device}")
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.ndim > 1 or t.numel() not in (1, b):
        raise ValueError(f"fleet_scan: parameters must be scalars or [{b}]")
    return t.expand(b).contiguous()


def _launch(prices: torch.Tensor, p_on, p_off, off_level,
            idle_frac) -> FleetScanOut:
    if prices.dtype != torch.float32 or prices.ndim != 2 \
            or not prices.is_contiguous():
        raise ValueError("fleet_scan: prices must be a contiguous [B, T] "
                         f"float32 tensor, got {prices.dtype} "
                         f"{tuple(prices.shape)}")
    b, t = prices.shape
    if b == 0 or t == 0:
        raise ValueError("fleet_scan: empty price block")
    dev = prices.device
    params = [_row_param(v, b, dev) for v in (p_on, p_off, off_level,
                                               idle_frac)]
    lib = _library()
    n_chunks = -(-t // CHUNK_HOURS)
    scratch = torch.empty(lib.fleet_scan_scratch_floats(b, n_chunks),
                          dtype=torch.float32, device=dev)
    out = torch.empty((4, b), dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("fleet_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fleet_scan_f32(prices.data_ptr(),
                                 *(q.data_ptr() for q in params),
                                 scratch.data_ptr(), out.data_ptr(),
                                 b, t, CHUNK_HOURS, stream)
    if err != 0:
        raise RuntimeError(f"fleet_scan kernel launch failed: CUDA error "
                           f"{err}")
    fleet_scan.launches += 1
    fleet_scan.device_launches += build.kernels_launched("fleet_scan") - n0
    return FleetScanOut(out[0], out[1], out[2], out[3])


def fleet_scan(prices: torch.Tensor, p_on, p_off, off_level, idle_frac, *,
               use_kernel: Optional[bool] = None) -> FleetScanOut:
    """Batched hysteresis scan. prices: [B, T]; params: [B] or scalars.

    Same contract as `repro_torch.kernels.ref.fleet_scan_ref` (which
    requires ``p_on <= p_off``). ``use_kernel=None`` launches the CUDA
    kernel for a CUDA tensor and runs the plain version for a CPU tensor;
    ``True`` demands the kernel (and raises on the CPU); ``False`` runs the
    plain version wherever the tensor is.
    """
    if use_kernel is None:
        use_kernel = prices.is_cuda
    if not use_kernel:
        return fleet_scan_ref(prices, p_on, p_off, off_level, idle_frac)
    if not prices.is_cuda:
        raise ValueError("fleet_scan(use_kernel=True) needs CUDA tensors; "
                         "the CPU runs the plain fleet_scan_ref")
    return _launch(prices, p_on, p_off, off_level, idle_frac)


fleet_scan.launches = 0
fleet_scan.device_launches = 0
