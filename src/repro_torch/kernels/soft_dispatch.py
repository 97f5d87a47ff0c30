"""Differentiable (temperature-relaxed) cross-site dispatch, with its three
hand-written Hopper kernels.

`repro_torch.kernels.dispatch_scan` answers where the load runs under given
schedules, but its greedy water-fill allocates through sorted clips, so a
site that receives no load gets no gradient. This module relaxes each
hour's fill into the *entropic* water-fill at temperature ``tau``:

    x_j = w_j sigmoid((lam - key_j) / tau),   sum_j x_j = demand

over the locked / retain / fresh capacity segments, with the water level
``lam`` bisected from the hard level under no gradient and made
differentiable by one Newton step; the dwell locks are smoothed too (see
`repro_torch.kernels.ref.soft_dispatch_hour_parts`). As tau -> 0 it
converges to the hard allocation.

The route follows the tensors' device:

  * CUDA, ``fused=True``: `soft_dispatch_fused`, a `torch.autograd.Function`
    whose forward launches the residual-emitting kernel (the port of the
    TPU kernel ``repro/kernels/soft_dispatch.py::_fused_fwd_kernel``) and
    whose backward launches the reversed-time adjoint kernel (the port of
    ``_fused_bwd_kernel``; two launches a call: an hour-parallel pass of
    the coefficients into a scratch buffer, then the reversed chain), both
    in ``csrc/soft_dispatch.cu``;
  * CUDA, ``fused=False``: the forward-only kernel (the port of
    ``_soft_dispatch_kernel``), which raises if an input requires grad;
  * CPU, ``fused=True``: the plain `soft_dispatch_fwd_ref` /
    `soft_dispatch_bwd_ref` under the same autograd.Function;
  * CPU, ``fused=False``: autograd through the plain per-hour operations
    (`soft_dispatch_ref`), the native baseline.

There is no fallback: a CUDA tensor launches a kernel or the call raises.
``soft_dispatch_scan.launches``, ``soft_dispatch_fused_fwd.launches`` and
``soft_dispatch_fused_bwd.launches`` count the wrappers' kernel calls, and
their ``device_launches`` the kernels those calls put on the card (one a
forward call, two a backward call).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (_Softplus, soft_dispatch_bwd_ref,
                                     soft_dispatch_fwd_ref, soft_dispatch_ref)


def _library() -> ctypes.CDLL:
    lib = build.load("soft_dispatch")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptr, n_int in ((lib.soft_dispatch_f32, 7, 4),
                             (lib.soft_dispatch_fused_fwd_f32, 9, 4),
                             (lib.soft_dispatch_fused_bwd_f32, 14, 3)):
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
        fn.restype = i32
    lib.soft_dispatch_bwd_scratch_floats.argtypes = [i32] * 3
    lib.soft_dispatch_bwd_scratch_floats.restype = ctypes.c_longlong
    for fn in (lib.soft_dispatch_fwd_levels, lib.soft_dispatch_fwd_threads):
        fn.argtypes, fn.restype = [i32], i32
    return lib


def _check(name: str, x, dtype: torch.dtype, shape: tuple,
           dev: torch.device) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != dtype \
            or x.device != dev or tuple(x.shape) != shape \
            or not x.is_contiguous():
        got = (f"{x.dtype} {list(x.shape)} on {x.device}"
               if isinstance(x, torch.Tensor) else type(x).__name__)
        raise ValueError(f"soft_dispatch: {name} must be a contiguous "
                         f"{dtype} tensor of shape {list(shape)} on {dev}, "
                         f"got {got}")


def _check_problem(avail, keys, order, demand, inv_tau, inv_tau_mw,
                   min_dwell: int):
    """Validates the kernels' common inputs; returns (S, T)."""
    if not isinstance(avail, torch.Tensor) or avail.ndim != 2 \
            or avail.shape[0] == 0 or avail.shape[1] == 0:
        raise ValueError("soft_dispatch: avail must be a non-empty [S, T] "
                         "tensor")
    s, t = avail.shape
    if s > 1024:
        raise ValueError(f"soft_dispatch: the kernels take at most 1024 "
                         f"sites (one thread each), got {s}")
    if min_dwell < 0:
        raise ValueError(f"soft_dispatch: min_dwell must be >= 0, got "
                         f"{min_dwell}")
    dev = avail.device
    f32 = torch.float32
    _check("avail", avail, f32, (s, t), dev)
    _check("keys", keys, f32, (t, 3 * s), dev)
    if order is not None:
        _check("order", order, torch.int32, (t, 3 * s), dev)
    _check("demand", demand, f32, (t,), dev)
    _check("inv_tau", inv_tau, f32, (1,), dev)
    _check("inv_tau_mw", inv_tau_mw, f32, (1,), dev)
    return s, t


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _inv_taus(tau, mw_scale: float, dtype: torch.dtype, dev: torch.device):
    """(1 / tau, 1 / (tau mw_scale)) as [1] tensors on ``dev``, computed
    there (a device ``tau`` keeps a step free of host reads)."""
    it = (1.0 / torch.as_tensor(tau, device=dev).to(dtype)).reshape(1)
    return it, it / torch.tensor(mw_scale, dtype=dtype)


def soft_dispatch_scan(avail: torch.Tensor, keys: torch.Tensor,
                       order: torch.Tensor, demand: torch.Tensor, *, tau,
                       min_dwell: int = 0, mw_scale: float = 0.05,
                       n_bisect: int = 30) -> torch.Tensor:
    """The relaxed allocation [S, T], forward only: on CUDA tensors the
    forward kernel (contiguous float32 avail [S, T], keys [T, 3S], demand
    [T]; int32 order [T, 3S]; S <= 1024), which refuses inputs that
    require grad; on CPU tensors the plain `soft_dispatch_ref`."""
    if not avail.is_cuda:
        return soft_dispatch_ref(avail, keys, order, demand, tau=tau,
                                 min_dwell=min_dwell, mw_scale=mw_scale,
                                 n_bisect=n_bisect)
    if any(isinstance(x, torch.Tensor) and x.requires_grad
           for x in (avail, keys, demand, tau)):
        raise ValueError(
            "soft_dispatch(fused=False) on CUDA tensors is forward only (the "
            "forward kernel saves no residuals): pass fused=True to "
            "differentiate, or detach the inputs")
    dev = avail.device
    it, itm = _inv_taus(tau, mw_scale, torch.float32, dev)
    s, t = _check_problem(avail, keys, order, demand, it, itm,
                          int(min_dwell))
    lib = _library()
    alloc = torch.empty((s, t), dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("soft_dispatch")
    with torch.cuda.device(dev):
        err = lib.soft_dispatch_f32(
            avail.data_ptr(), keys.data_ptr(), order.data_ptr(),
            demand.data_ptr(), it.data_ptr(), itm.data_ptr(),
            alloc.data_ptr(), s, t, int(min_dwell), int(n_bisect),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "soft_dispatch")
    soft_dispatch_scan.launches += 1
    soft_dispatch_scan.device_launches += \
        build.kernels_launched("soft_dispatch") - n0
    return alloc


def soft_dispatch_fused_fwd(avail: torch.Tensor, keys: torch.Tensor,
                            order: torch.Tensor, demand: torch.Tensor,
                            inv_tau: torch.Tensor, inv_tau_mw: torch.Tensor,
                            *, min_dwell: int = 0, n_bisect: int = 30):
    """``(alloc [S, T], dwell_in [S, T], lam_hat [T])``: the forward with
    the residuals of the fused VJP. CUDA tensors launch the kernel
    (``inv_tau``/``inv_tau_mw`` float32 [1] on the card); CPU tensors run
    the plain `soft_dispatch_fwd_ref`."""
    if not avail.is_cuda:
        return soft_dispatch_fwd_ref(avail, keys, order, demand, inv_tau,
                                     inv_tau_mw, min_dwell=min_dwell,
                                     n_bisect=n_bisect)
    s, t = _check_problem(avail, keys, order, demand, inv_tau, inv_tau_mw,
                          int(min_dwell))
    dev = avail.device
    lib = _library()
    alloc = torch.empty((s, t), dtype=torch.float32, device=dev)
    dwin = torch.empty_like(alloc)
    lam = torch.empty(t, dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("soft_dispatch")
    with torch.cuda.device(dev):
        err = lib.soft_dispatch_fused_fwd_f32(
            avail.data_ptr(), keys.data_ptr(), order.data_ptr(),
            demand.data_ptr(), inv_tau.data_ptr(), inv_tau_mw.data_ptr(),
            alloc.data_ptr(), dwin.data_ptr(), lam.data_ptr(), s, t,
            int(min_dwell), int(n_bisect),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "soft_dispatch_fused_fwd")
    soft_dispatch_fused_fwd.launches += 1
    soft_dispatch_fused_fwd.device_launches += \
        build.kernels_launched("soft_dispatch") - n0
    return alloc, dwin, lam


def soft_dispatch_fused_bwd(avail: torch.Tensor, keys: torch.Tensor,
                            demand: torch.Tensor, inv_tau: torch.Tensor,
                            inv_tau_mw: torch.Tensor, alloc: torch.Tensor,
                            dwin: torch.Tensor, lam: torch.Tensor,
                            g: torch.Tensor, *, min_dwell: int = 0,
                            want_dkeys: bool = True):
    """``(d_avail [S, T], d_keys [T, 3S] or None, d_demand [T], sum
    d_inv_tau, sum d_inv_tau_mw)``: the VJP of `soft_dispatch_fused_fwd`'s
    allocation for the cotangent ``g`` [S, T], from its residuals; the two
    sums are float64. CUDA tensors launch the kernel, CPU tensors run the
    plain `soft_dispatch_bwd_ref`.

    On the card a call allocates a scratch buffer of every hour's
    coefficients, ``T x stride`` float32 with ``stride = 12 + 28 S`` (20 S
    without dwell locks) rounded up to a multiple of 4: 4 T (12 + 28 S)
    bytes, 8.0 MB at 32 sites x 2190 h, 63 MB at 64 x 8760, and at most
    1.0 GB (1024 sites x 8760 h)."""
    if not avail.is_cuda:
        return soft_dispatch_bwd_ref(avail, keys, demand, inv_tau,
                                     inv_tau_mw, alloc, dwin, lam, g,
                                     min_dwell=min_dwell,
                                     want_dkeys=want_dkeys)
    s, t = _check_problem(avail, keys, None, demand, inv_tau, inv_tau_mw,
                          int(min_dwell))
    dev = avail.device
    for name, x in (("alloc", alloc), ("dwin", dwin), ("g", g)):
        _check(name, x, torch.float32, (s, t), dev)
    _check("lam", lam, torch.float32, (t,), dev)
    lib = _library()
    d_avail = torch.empty((s, t), dtype=torch.float32, device=dev)
    d_keys = torch.empty((t, 3 * s), dtype=torch.float32, device=dev) \
        if want_dkeys else None
    d_demand = torch.empty(t, dtype=torch.float32, device=dev)
    sums = torch.empty(2, dtype=torch.float64, device=dev)
    # the coefficients of every hour, written by the first of the two
    # launches and read by the second: per call, on the call's stream
    scratch = torch.empty(
        lib.soft_dispatch_bwd_scratch_floats(s, t, int(min_dwell)),
        dtype=torch.float32, device=dev)
    n0 = build.kernels_launched("soft_dispatch")
    with torch.cuda.device(dev):
        err = lib.soft_dispatch_fused_bwd_f32(
            avail.data_ptr(), keys.data_ptr(), demand.data_ptr(),
            alloc.data_ptr(), dwin.data_ptr(), lam.data_ptr(), g.data_ptr(),
            inv_tau.data_ptr(), inv_tau_mw.data_ptr(), d_avail.data_ptr(),
            d_keys.data_ptr() if want_dkeys else None, d_demand.data_ptr(),
            sums.data_ptr(), scratch.data_ptr(), s, t, int(min_dwell),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "soft_dispatch_fused_bwd")
    soft_dispatch_fused_bwd.launches += 1
    soft_dispatch_fused_bwd.device_launches += \
        build.kernels_launched("soft_dispatch") - n0
    return d_avail, d_keys, d_demand, sums[0], sums[1]


soft_dispatch_scan.launches = 0
soft_dispatch_scan.device_launches = 0
soft_dispatch_fused_fwd.launches = 0
soft_dispatch_fused_fwd.device_launches = 0
soft_dispatch_fused_bwd.launches = 0
soft_dispatch_fused_bwd.device_launches = 0


class _SoftDispatchFused(torch.autograd.Function):
    """alloc = soft dispatch of (avail, keys, demand, tau); saves the
    inputs, the allocation, the entering dwell and the bisected levels.
    ``order`` gets no gradient."""

    @staticmethod
    def forward(ctx, avail, keys, order, demand, tau, min_dwell, mw_scale,
                n_bisect):
        it, itm = _inv_taus(tau, mw_scale, avail.dtype, avail.device)
        alloc, dwin, lam = soft_dispatch_fused_fwd(
            avail, keys, order, demand, it, itm, min_dwell=min_dwell,
            n_bisect=n_bisect)
        ctx.save_for_backward(avail, keys, demand, tau, alloc, dwin, lam)
        ctx.min_dwell, ctx.mw_scale = min_dwell, mw_scale
        return alloc

    @staticmethod
    def backward(ctx, g):
        avail, keys, demand, tau, alloc, dwin, lam = ctx.saved_tensors
        need = ctx.needs_input_grad
        it, itm = _inv_taus(tau, ctx.mw_scale, avail.dtype, avail.device)
        d_av, d_ke, d_de, s_it, s_itm = soft_dispatch_fused_bwd(
            avail, keys, demand, it, itm, alloc, dwin, lam,
            g.to(avail.dtype).contiguous(), min_dwell=ctx.min_dwell,
            want_dkeys=need[1])
        d_tau = None
        if need[4]:
            it64, itm64 = it[0].double(), itm[0].double()
            d_tau = (-(it64 ** 2) * s_it - it64 * itm64 * s_itm) \
                .to(tau.dtype).reshape(tau.shape)
        return (d_av if need[0] else None, d_ke if need[1] else None, None,
                d_de if need[3] else None, d_tau, None, None, None)


def soft_dispatch_fused(avail: torch.Tensor, keys: torch.Tensor,
                        order: torch.Tensor, demand: torch.Tensor, *, tau,
                        min_dwell: int = 0, mw_scale: float = 0.05,
                        n_bisect: int = 30) -> torch.Tensor:
    """`soft_dispatch` under the fused VJP: the same allocation, and a
    backward that replays each hour's Newton correction from the saved
    levels instead of transposing the bisection. Differentiable in
    ``avail``, ``keys``, ``demand`` and ``tau``. On CUDA tensors both
    directions are kernels, in float32; on CPU tensors the plain versions,
    in the availability's dtype (float64 stays float64)."""
    dev = avail.device
    dtype = torch.float64 if avail.dtype == torch.float64 \
        and not avail.is_cuda else torch.float32
    return _SoftDispatchFused.apply(
        avail.to(dtype).contiguous(), keys.to(dtype).contiguous(),
        order.to(device=dev, dtype=torch.int32).contiguous(),
        demand.to(dtype).contiguous(),
        torch.as_tensor(tau, device=dev).to(dtype), int(min_dwell),
        float(mw_scale), int(n_bisect))


def soft_dispatch(avail: torch.Tensor, keys: torch.Tensor,
                  order: torch.Tensor, demand: torch.Tensor, *, tau,
                  min_dwell: int = 0, mw_scale: float = 0.05,
                  n_bisect: int = 30, fused: bool = False) -> torch.Tensor:
    """Differentiable fleet dispatch allocation at temperature ``tau``.

    avail: [S, T] MW; keys/order: [T, 3S] precomputed segment keys and
    their ascending sort (`repro_torch.dispatch.segment_keys` /
    `segment_rank`); demand: [T] MW. Returns the relaxed allocation
    [S, T], converging to the hard `dispatch_scan` allocation as
    tau -> 0. ``fused=True`` differentiates through the fused VJP
    (`soft_dispatch_fused`, kernels on the card); ``fused=False`` runs the
    forward kernel on CUDA tensors (forward only) and autograd through the
    plain per-hour operations on CPU tensors."""
    if fused:
        return soft_dispatch_fused(avail, keys, order, demand, tau=tau,
                                   min_dwell=min_dwell, mw_scale=mw_scale,
                                   n_bisect=n_bisect)
    if avail.is_cuda:
        avail, keys, demand = (x.to(torch.float32).contiguous()
                               for x in (avail, keys, demand))
        order = order.to(device=avail.device, dtype=torch.int32).contiguous()
    return soft_dispatch_scan(avail, keys, order, demand, tau=tau,
                              min_dwell=min_dwell, mw_scale=mw_scale,
                              n_bisect=n_bisect)


def soft_shed(avail_total: torch.Tensor, demand: torch.Tensor, tau, *,
              mw_scale: float = 0.05) -> torch.Tensor:
    """Smoothed per-hour shed: how much of ``demand`` [T] exceeds the
    fleet's total availability ``avail_total`` [T], relaxed at the MW
    temperature the water-fill uses:

        shed_t = w softplus((demand_t - avail_total_t) / w),
        w = max(tau mw_scale, 1e-9)

    converging to ``relu(demand - avail_total)`` as tau -> 0."""
    d = demand
    w = torch.clamp(torch.as_tensor(tau, device=d.device).to(d.dtype)
                    * torch.tensor(mw_scale, dtype=d.dtype), min=1e-9)
    return w * _Softplus.apply((d - avail_total) / w)
