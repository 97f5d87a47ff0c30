"""Batched hysteresis scan: the hand-written Hopper kernel and its wrapper.

`fleet_scan` runs ``csrc/fleet_scan.cu`` (the port of the TPU kernel
``repro/kernels/fleet_scan.py::_fleet_kernel``) on CUDA tensors and the
plain `repro_torch.kernels.ref.fleet_scan_ref` on CPU tensors. There is
no fallback: on a CUDA tensor the kernel is built, launched and checked,
or the call raises. ``fleet_scan.launches`` counts the wrapper's calls
that launch, ``fleet_scan.device_launches`` the kernels they put on
the card (one a call).

With ``market_idx`` the prices are an [N, T] market block and row b
reads row ``market_idx[b]``: the kernel reads through the index, so no
[B, T] block is gathered on the card (the reference's `fleet_scan` takes
only [B, T]; the port's backtest passes its grid's markets and index).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import FleetScanOut, fleet_scan_ref


def _library() -> ctypes.CDLL:
    lib = build.load("fleet_scan")
    lib.fleet_scan_f32.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fleet_scan_f32.restype = ctypes.c_int
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


def _check_index(prices: torch.Tensor, market_idx) -> None:
    if not isinstance(market_idx, torch.Tensor) \
            or market_idx.dtype != torch.int64 or market_idx.ndim != 1 \
            or market_idx.device != prices.device \
            or not market_idx.is_contiguous():
        got = (f"{market_idx.dtype} {tuple(market_idx.shape)} on "
               f"{market_idx.device}" if isinstance(market_idx, torch.Tensor)
               else type(market_idx).__name__)
        raise ValueError("fleet_scan: market_idx must be a contiguous [B] "
                         f"int64 tensor on {prices.device}, got {got}")


def _launch(prices: torch.Tensor, p_on, p_off, off_level, idle_frac,
            market_idx: Optional[torch.Tensor]) -> FleetScanOut:
    if prices.dtype != torch.float32 or prices.ndim != 2 \
            or not prices.is_contiguous():
        raise ValueError("fleet_scan: prices must be a contiguous [B, T] "
                         "(or, with market_idx, [N, T]) float32 tensor, got "
                         f"{prices.dtype} {tuple(prices.shape)}")
    n, t = prices.shape
    b = n if market_idx is None else market_idx.shape[0]
    if b == 0 or n == 0 or t == 0:
        raise ValueError("fleet_scan: empty price block")
    dev = prices.device
    params = [_row_param(v, b, dev) for v in (p_on, p_off, off_level,
                                               idle_frac)]
    lib = _library()
    out = torch.empty((4, b), dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("fleet_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fleet_scan_f32(
            prices.data_ptr(),
            None if market_idx is None else market_idx.data_ptr(),
            *(q.data_ptr() for q in params), out.data_ptr(), b, n, t, stream)
    if err != 0:
        raise RuntimeError(f"fleet_scan kernel launch failed: CUDA error "
                           f"{err}")
    fleet_scan.launches += 1
    fleet_scan.device_launches += build.kernels_launched("fleet_scan") - n0
    return FleetScanOut(out[0], out[1], out[2], out[3])


def fleet_scan(prices: torch.Tensor, p_on, p_off, off_level, idle_frac, *,
               market_idx: Optional[torch.Tensor] = None,
               use_kernel: Optional[bool] = None) -> FleetScanOut:
    """Batched hysteresis scan. prices: [B, T], or [N, T] with
    ``market_idx`` (an int64 [B] tensor on the same device: row b reads
    ``prices[market_idx[b]]``); params: [B] or scalars.

    Same contract as `repro_torch.kernels.ref.fleet_scan_ref`, off tested
    first (an inverted band ``p_on > p_off`` gives what the plain version
    gives). ``use_kernel=None`` launches the CUDA kernel for a CUDA tensor
    and runs the plain version (on the gathered rows) for a CPU tensor;
    ``True`` demands the kernel (and raises on the CPU); ``False`` runs the
    plain version wherever the tensor is. On the card an index outside
    [0, N) stops the kernel, and the error surfaces at the next
    synchronisation.
    """
    if market_idx is not None:
        _check_index(prices, market_idx)
    if use_kernel is None:
        use_kernel = prices.is_cuda
    if not use_kernel:
        rows = prices if market_idx is None else prices[market_idx]
        return fleet_scan_ref(rows, p_on, p_off, off_level, idle_frac)
    if not prices.is_cuda:
        raise ValueError("fleet_scan(use_kernel=True) needs CUDA tensors; "
                         "the CPU runs the plain fleet_scan_ref")
    return _launch(prices, p_on, p_off, off_level, idle_frac, market_idx)


fleet_scan.launches = 0
fleet_scan.device_launches = 0
