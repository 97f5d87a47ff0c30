"""Fused, checkpointed VJP of the soft-state trajectory, with its two
hand-written Hopper kernels.

`soft_state_fused` evaluates the relaxed hysteresis recurrence
s_t = alpha_t s_{t-1} + beta_t (`repro_torch.kernels.ref.soft_gates`) and
differentiates it by hand:

  forward   the states s [B, T] and, as the only residual beyond the
            inputs, the state entering each ``block_t``-hour block
            (``carries`` [B, n_blocks]);
  backward  recompute each block's states from its carry, run the adjoint
            u_t = g_t + alpha_{t+1} u_{t+1} and apply
            `repro_torch.kernels.ref.soft_gate_grad`.

On CUDA tensors both directions launch ``csrc/soft_scan.cu`` (the port of
the TPU kernel pair ``repro/kernels/soft_scan_vjp.py::_fwd_kernel`` and
``_bwd_kernel``); on CPU tensors they run the plain blocked versions
`soft_scan_fwd_ref` / `soft_scan_bwd_ref`, which follow the inputs'
dtype (so ``torch.autograd.gradcheck`` runs in float64). There is no
fallback: a CUDA tensor launches the kernel or the call raises.
``soft_scan_fwd.launches`` and ``soft_scan_bwd.launches`` count the
wrappers' calls that launch, their ``device_launches`` the kernels those
calls put on the card (one a call). ``block_t`` is any positive number of
hours, on the card as on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import soft_scan_bwd_ref, soft_scan_fwd_ref

DEFAULT_BLOCK_T = 256


def _library() -> ctypes.CDLL:
    lib = build.load("soft_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.soft_scan_fwd_f32.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.soft_scan_fwd_f32.restype = i32
    lib.soft_scan_bwd_f32.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    lib.soft_scan_bwd_f32.restype = i32
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, dev: torch.device):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
            or x.device != dev or tuple(x.shape) != shape \
            or not x.is_contiguous():
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
               if isinstance(x, torch.Tensor) else type(x).__name__)
        raise ValueError(f"soft_scan: {name} must be a contiguous float32 "
                         f"{list(shape)} tensor on {dev}, got {got}")


def _check_block(p: torch.Tensor, block_t: int) -> tuple[int, int]:
    if p.ndim != 2 or p.shape[0] == 0 or p.shape[1] == 0:
        raise ValueError(f"soft_scan: prices must be [B, T] with B, T > 0, "
                         f"got {tuple(p.shape)}")
    if block_t <= 0:
        raise ValueError(f"soft_scan: block_t must be positive, got "
                         f"{block_t}")
    return p.shape


def _route(p: torch.Tensor, use_kernel: Optional[bool], name: str) -> bool:
    if use_kernel is None:
        return p.is_cuda
    if use_kernel and not p.is_cuda:
        raise ValueError(f"{name}(use_kernel=True) needs CUDA tensors; the "
                         "CPU runs the plain blocked version")
    return bool(use_kernel)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def soft_scan_fwd(p: torch.Tensor, p_on: torch.Tensor, p_off: torch.Tensor,
                  inv_tau: torch.Tensor, *, block_t: int = DEFAULT_BLOCK_T,
                  use_kernel: Optional[bool] = None):
    """``(s [B, T], carries [B, n_blocks])`` of the relaxed recurrence.

    ``use_kernel=None`` launches the CUDA kernel for a CUDA tensor and runs
    `soft_scan_fwd_ref` for a CPU tensor; ``True`` demands the kernel (and
    raises on the CPU); ``False`` runs the plain version wherever the
    tensors are. The kernel takes contiguous float32 ``p`` [B, T],
    ``p_on``/``p_off`` [B] and ``inv_tau`` [1] on one device.
    """
    if not _route(p, use_kernel, "soft_scan_fwd"):
        return soft_scan_fwd_ref(p, p_on, p_off, inv_tau, block_t)
    b, t = _check_block(p, block_t)
    dev = p.device
    _check("prices", p, (b, t), dev)
    _check("p_on", p_on, (b,), dev)
    _check("p_off", p_off, (b,), dev)
    _check("inv_tau", inv_tau, (1,), dev)
    lib = _library()
    nb = -(-t // block_t)
    s = torch.empty((b, t), dtype=torch.float32, device=dev)
    carries = torch.empty((b, nb), dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("soft_scan")
    with torch.cuda.device(dev):
        err = lib.soft_scan_fwd_f32(
            p.data_ptr(), p_on.data_ptr(), p_off.data_ptr(),
            inv_tau.data_ptr(), s.data_ptr(), carries.data_ptr(), b, t,
            block_t, _stream(dev))
    if err != 0:
        raise RuntimeError(f"soft_scan_fwd kernel launch failed: CUDA "
                           f"error {err}")
    soft_scan_fwd.launches += 1
    soft_scan_fwd.device_launches += build.kernels_launched("soft_scan") - n0
    return s, carries


def soft_scan_bwd(p: torch.Tensor, p_on: torch.Tensor, p_off: torch.Tensor,
                  inv_tau: torch.Tensor, carries: torch.Tensor,
                  g: torch.Tensor, *, block_t: int = DEFAULT_BLOCK_T,
                  want_dp: bool = True, use_kernel: Optional[bool] = None):
    """``(d_p [B, T] or None, d_p_on [B], d_p_off [B], d_inv_tau [])``:
    the VJP of `soft_scan_fwd`'s states for the cotangent ``g`` [B, T],
    from the forward's ``carries``. ``want_dp=False`` skips d_p (the
    tuner's prices carry no gradient). Routes like `soft_scan_fwd`."""
    if not _route(p, use_kernel, "soft_scan_bwd"):
        d_p, d_on, d_off, d_it = soft_scan_bwd_ref(p, p_on, p_off, inv_tau,
                                                   carries, g, block_t)
        return (d_p if want_dp else None), d_on, d_off, d_it
    b, t = _check_block(p, block_t)
    dev = p.device
    nb = -(-t // block_t)
    _check("prices", p, (b, t), dev)
    _check("g", g, (b, t), dev)
    _check("p_on", p_on, (b,), dev)
    _check("p_off", p_off, (b,), dev)
    _check("inv_tau", inv_tau, (1,), dev)
    _check("carries", carries, (b, nb), dev)
    lib = _library()
    d_p = torch.empty((b, t), dtype=torch.float32, device=dev) \
        if want_dp else None
    sums = torch.empty((3, b), dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("soft_scan")
    with torch.cuda.device(dev):
        err = lib.soft_scan_bwd_f32(
            p.data_ptr(), g.data_ptr(), p_on.data_ptr(), p_off.data_ptr(),
            inv_tau.data_ptr(), carries.data_ptr(),
            d_p.data_ptr() if want_dp else None, sums.data_ptr(), b, t,
            block_t, _stream(dev))
    if err != 0:
        raise RuntimeError(f"soft_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    soft_scan_bwd.launches += 1
    soft_scan_bwd.device_launches += build.kernels_launched("soft_scan") - n0
    # the row sum of d_inv_tau in float64, in a fixed order
    d_it = sums[2].double().sum().to(torch.float32)
    return d_p, sums[0], sums[1], d_it


soft_scan_fwd.launches = 0
soft_scan_fwd.device_launches = 0
soft_scan_bwd.launches = 0
soft_scan_bwd.device_launches = 0


class _SoftState(torch.autograd.Function):
    """s = soft state of (p, p_on, p_off, tau); saves the inputs and the
    per-block entering states only."""

    @staticmethod
    def forward(ctx, p, p_on, p_off, tau, block_t):
        inv_tau = (1.0 / tau).reshape(1)
        s, carries = soft_scan_fwd(p, p_on, p_off, inv_tau, block_t=block_t)
        ctx.save_for_backward(p, p_on, p_off, tau, carries)
        ctx.block_t = block_t
        return s

    @staticmethod
    def backward(ctx, g):
        p, p_on, p_off, tau, carries = ctx.saved_tensors
        inv_tau = (1.0 / tau).reshape(1)
        need = ctx.needs_input_grad
        d_p, d_on, d_off, d_it = soft_scan_bwd(
            p, p_on, p_off, inv_tau, carries, g.contiguous(),
            block_t=ctx.block_t, want_dp=need[0])
        d_tau = (-inv_tau[0] ** 2 * d_it).reshape(tau.shape) \
            if need[3] else None
        return (d_p, d_on if need[1] else None,
                d_off if need[2] else None, d_tau, None)


def soft_state_fused(prices: torch.Tensor, p_on, p_off, *, tau,
                     block_t: int = DEFAULT_BLOCK_T) -> torch.Tensor:
    """Soft on-state trajectory s [B, T] (s_{-1} = 1) with the fused,
    checkpointed backward; differentiable in (prices, p_on, p_off, tau).

    Same contract and values as `repro_torch.kernels.soft_scan.soft_state`
    up to summation order. prices: [B, T]; p_on/p_off: [B] or scalars;
    ``tau`` a number or a tensor (a device tensor keeps a step free of
    host reads). Float64 prices stay float64 (on the CPU); anything else
    computes in float32. CUDA tensors launch the kernels, CPU tensors run
    the plain blocked versions.
    """
    dtype = torch.float64 if prices.dtype == torch.float64 \
        else torch.float32
    p = prices.to(dtype).contiguous()
    b = p.shape[0]
    p_on, p_off = (torch.as_tensor(v, device=p.device).to(dtype)
                   .expand(b).contiguous() for v in (p_on, p_off))
    tau = torch.as_tensor(tau, device=p.device).to(dtype)
    return _SoftState.apply(p, p_on, p_off, tau, int(block_t))
