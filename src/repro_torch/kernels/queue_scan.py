"""The work ledger: a bounded, deadline-aged deferral queue, its three
hand-written Hopper kernels and their wrappers.

The reference runs the ledger as a `lax.scan` (``repro/kernels/
queue_scan.py``: `queue_scan` and the fleet-coupled
`workload_fleet_scan`), which XLA compiles into one loop on the device.
Here the hour loop runs inside ``csrc/queue_scan.cu``:

  * `workload_ledger_fwd` — the hard ledger of the workload backtest: a
    thread a (row, draw), the hours in windows (a window's prices, read
    through ``market_idx``, and demand loaded a window ahead, its
    shutdown states computed before its hours), each hour in closed form
    on the queue's prefix sums, the draws served with the hour's realised
    capacity; [B, G] sums, and with telemetry each row's hourly sums over
    its draws, summed once a window (mirror:
    `ref.workload_ledger_seg_ref`);
  * `soft_ledger_fwd` / `soft_ledger_bwd` — [B, T] demand and capacity,
    the hard clip or its `smoothclip` relaxation in float32 or float64, a
    row's d + 1 buckets on the lanes of a warp segment; the forward saves
    the queue entering every hour ([T, B, d], youngest first, as the
    plain version does), the backward computes every hour's smoothclip
    derivatives in parallel and then runs reverse time through the
    linear adjoint alone (two kernels a window of hours). `SoftLedger` is
    the pair under autograd (d capacity and d demand), the tuner's SLO
    term.

On CPU tensors each wrapper runs its plain version
(`repro_torch.kernels.ref`: `workload_ledger_ref`, `soft_ledger_fwd_ref`,
`soft_ledger_bwd_ref`, Python hour loops); on CUDA tensors it launches
its kernel or raises, with no fallback. ``use_kernel=False`` runs the
plain version wherever the tensors are. Each wrapper counts its calls
that launch (``.launches``) and the kernels they put on the card
(``.device_launches``).

`queue_scan` and `workload_fleet_scan` keep the reference's contracts on
top: the first runs the forward kernel, and `SoftLedger` on any device
where the soft ledger must carry a gradient; the second the engine's
`fleet_scan` kernel for the fleet sums and `workload_ledger_fwd` for the
ledger.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fleet_scan import _row_param, fleet_scan
from repro_torch.kernels.ref import (QUEUE_MWH_SCALE, FleetScanOut,
                                     QueueHourly, QueueScanOut,
                                     WorkloadLedgerOut, _ledger_inputs,
                                     queue_hour_step, queue_scan_ref,
                                     smoothclip, soft_ledger_bwd_ref,
                                     soft_ledger_fwd_ref,
                                     workload_ledger_ref)

__all__ = ["QUEUE_MWH_SCALE", "QueueHourly", "QueueScanOut", "SoftLedger",
           "WorkloadFleetOut", "WorkloadHourly", "WorkloadLedgerOut",
           "queue_hour_step", "queue_scan", "smoothclip", "soft_ledger_bwd", "soft_ledger_fwd", "workload_fleet_scan",
           "workload_ledger_fwd"]

_MAX_REG_D = 8       # csrc/queue_scan.cu's kMaxRegD: above it the hard
                     # kernel keeps the queue in a scratch the wrapper
                     # allocates
_MAX_DRAWS = 1024    # one row's draws fit one block of the hard kernel


class WorkloadFleetOut(NamedTuple):
    """Fused fleet + ledger scan output: the exact `FleetScanOut` sums of
    the engine's scan ([B] each) and the ledger's [B, G] sums over the G
    demand draws every row serves."""

    fleet: FleetScanOut
    served: torch.Tensor       # [B, G] MWh
    dropped: torch.Tensor      # [B, G] MWh
    backlog: torch.Tensor      # [B, G] MWh-hours deferred
    served_cost: torch.Tensor  # [B, G] EUR at the hour each MWh is served


class WorkloadHourly(NamedTuple):
    """Per-hour fleet-mean ledger aggregates ([T] each, the mean over rows
    x draws) — the payload of the ``workload.hourly`` telemetry drain."""

    demand_mwh: torch.Tensor
    served_mwh: torch.Tensor
    dropped_mwh: torch.Tensor
    backlog_mwh: torch.Tensor


def _library() -> ctypes.CDLL:
    lib = build.load("queue_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.workload_ledger_f32.argtypes = [ptr] * 8 + [ctypes.c_float] \
        + [i32] * 5 + [ptr] * 4
    lib.workload_ledger_f32.restype = i32
    for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fwd = getattr(lib, f"soft_ledger_fwd_{suffix}")
        fwd.argtypes = [ptr] * 4 + [real] + [i32] * 4 + [ptr] * 6
        fwd.restype = i32
        bwd = getattr(lib, f"soft_ledger_bwd_{suffix}")
        bwd.argtypes = [ptr] * 4 + [real] + [i32] * 3 + [ptr] * 6
        bwd.restype = i32
    lib.soft_ledger_fwd_scratch.argtypes = [i32] * 2
    lib.soft_ledger_bwd_scratch.argtypes = [i32] * 4
    lib.soft_ledger_fwd_scratch.restype = ctypes.c_longlong
    lib.soft_ledger_bwd_scratch.restype = ctypes.c_longlong
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _route(x: torch.Tensor, use_kernel: Optional[bool], name: str) -> bool:
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError(f"{name}(use_kernel=True) needs CUDA tensors; the "
                         "CPU runs the plain version")
    return bool(use_kernel)


def _check(name: str, x, shape: tuple, dtype: torch.dtype,
           dev: torch.device) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != dtype \
            or x.device != dev or tuple(x.shape) != shape \
            or not x.is_contiguous():
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
               if isinstance(x, torch.Tensor) else type(x).__name__)
        raise ValueError(f"queue_scan: {name} must be a contiguous {dtype} "
                         f"{list(shape)} tensor on {dev}, got {got}")


def _check_deadline(deadline) -> int:
    d = int(deadline)
    if d < 0:
        raise ValueError(f"queue_scan: deadline must be >= 0, got "
                         f"{deadline}")
    return d


def _tau(tau, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``tau`` (a number or tensor) as a [1] tensor of ``dtype`` (a number
    is converted straight to ``dtype``, not through float32)."""
    t = tau.to(device=dev, dtype=dtype) if isinstance(tau, torch.Tensor) \
        else torch.tensor(float(tau), dtype=dtype, device=dev)
    return t.reshape(1)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def workload_ledger_fwd(prices: torch.Tensor, p_on, p_off, off_level,
                        cap_mwh, demand: torch.Tensor, dt, *,
                        deadline: int, bound,
                        market_idx: Optional[torch.Tensor] = None,
                        hourly: bool = False,
                        use_kernel: Optional[bool] = None):
    """The fleet-coupled hard ledger: ``(WorkloadLedgerOut [B, G] each,
    hourly [4, B, T] or None)``.

    prices: [B, T], or [N, T] with ``market_idx`` (int64 [B]); p_on/p_off/
    off_level/cap_mwh/dt: [B] float32 tensors or numbers; demand: [G, T]
    float32 MW. Every row runs its shutdown state machine (off tested
    first, starting on) and serves ``dt_b * demand[g]`` with the hour's
    realised capacity ``cap_mwh_b * (lvl + (1 - lvl) on)``. ``hourly``
    adds each row's per-hour sums over its draws of arrivals, served,
    dropped and backlog MWh; the other outputs are the same bit for bit.
    Routes like `repro_torch.kernels.fleet_scan.fleet_scan`
    (`workload_ledger_ref` on the CPU)."""
    d = _check_deadline(deadline)
    if not _route(prices, use_kernel, "workload_ledger_fwd"):
        return workload_ledger_ref(prices, p_on, p_off, off_level, cap_mwh,
                                   demand, dt, deadline=d, bound=bound,
                                   market_idx=market_idx, hourly=hourly)
    dev, f32 = prices.device, torch.float32
    if prices.ndim != 2 or prices.shape[0] == 0 or prices.shape[1] == 0:
        raise ValueError(f"workload_ledger_fwd: prices must be [B, T] or "
                         f"[N, T] with B, T > 0, got {tuple(prices.shape)}")
    n, t = prices.shape
    _check("prices", prices, (n, t), f32, dev)
    b = n if market_idx is None else int(market_idx.shape[0])
    if market_idx is not None:
        _check("market_idx", market_idx, (b,), torch.int64, dev)
    if demand.ndim != 2 or demand.shape[1] != t:
        raise ValueError(f"workload_ledger_fwd: demand must be [G, {t}], "
                         f"got {tuple(demand.shape)}")
    g = int(demand.shape[0])
    if not 0 < g <= _MAX_DRAWS:
        raise ValueError(f"workload_ledger_fwd: the kernel serves 1 to "
                         f"{_MAX_DRAWS} draws, got {g}")
    _check("demand", demand, (g, t), f32, dev)
    params = [_row_param(v, b, dev) for v in (p_on, p_off, off_level,
                                               cap_mwh, dt)]
    lib = _library()
    out = torch.empty((4, b, g), dtype=f32, device=dev)
    hr = torch.empty((4, b, t), dtype=f32, device=dev) if hourly else None
    scratch = torch.empty((d, b, g), dtype=f32, device=dev) \
        if d > _MAX_REG_D else None
    n0 = build.kernels_launched("queue_scan")
    with torch.cuda.device(dev):
        err = lib.workload_ledger_f32(
            prices.data_ptr(), _ptr(market_idx),
            *(x.data_ptr() for x in params), demand.data_ptr(),
            float(bound), b, n, g, t, d, out.data_ptr(), _ptr(hr),
            _ptr(scratch), _stream(dev))
    if err != 0:
        raise RuntimeError(f"workload_ledger_fwd kernel launch failed: CUDA "
                           f"error {err}")
    workload_ledger_fwd.launches += 1
    workload_ledger_fwd.device_launches += \
        build.kernels_launched("queue_scan") - n0
    return WorkloadLedgerOut(*out), hr


def _soft_checks(demand, cap, tau, prices, dev):
    if demand.ndim != 2 or demand.shape[0] == 0 or demand.shape[1] == 0:
        raise ValueError(f"soft_ledger: demand must be [B, T] with B, T > 0, "
                         f"got {tuple(demand.shape)}")
    dtype = demand.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"soft_ledger: float32 or float64 inputs, got "
                         f"{dtype}")
    shape = tuple(demand.shape)
    _check("demand", demand, shape, dtype, dev)
    _check("cap", cap, shape, dtype, dev)
    if prices is not None:
        _check("prices", prices, shape, dtype, dev)
    if tau is not None:
        _check("tau", tau, (1,), dtype, dev)
    return shape, dtype


def soft_ledger_fwd(demand: torch.Tensor, cap: torch.Tensor,
                    tau: Optional[torch.Tensor], *, deadline: int, bound,
                    prices: Optional[torch.Tensor] = None,
                    hard: bool = False, keep_hist: bool = True,
                    hourly: bool = False,
                    use_kernel: Optional[bool] = None):
    """``(sums [4, B], hist, q_final [B, D], hourly [3, B, T] or None)`` of
    the ledger over [B, T] demand and capacity (MWh): the served,
    dropped, backlog (MWh-hours) and served-cost sums, the queue entering
    every hour ([T, B, D] youngest first, the backward's residual; None
    when ``hard`` or not ``keep_hist``), the end-of-run queue (youngest
    first) and the hourly served / dropped / backlog series.

    ``tau`` is the [1] MWh temperature of `smoothclip` (unread, and may be
    None, when ``hard``); prices [B, T] or None price the served MWh. All
    of one dtype, float32 or float64. Routes like `workload_ledger_fwd`
    (`soft_ledger_fwd_ref` on the CPU)."""
    d = _check_deadline(deadline)
    if not _route(demand, use_kernel, "soft_ledger_fwd"):
        sums, hist, q_final, hr = soft_ledger_fwd_ref(
            demand, cap, tau, deadline=d, bound=bound, prices=prices,
            hard=hard, hourly=hourly)
        return sums, (hist if keep_hist else None), q_final, hr
    dev = demand.device
    (b, t), dtype = _soft_checks(demand, cap, None if hard else tau, prices,
                                 dev)
    lib = _library()
    fn = lib.soft_ledger_fwd_f64 if dtype == torch.float64 \
        else lib.soft_ledger_fwd_f32
    sums = torch.empty((4, b), dtype=dtype, device=dev)
    hist = torch.empty((t, b, d), dtype=dtype, device=dev) \
        if keep_hist and not hard else None
    q_final = torch.empty((b, d), dtype=dtype, device=dev)
    hr = torch.empty((3, b, t), dtype=dtype, device=dev) if hourly else None
    n = lib.soft_ledger_fwd_scratch(b, d)
    scratch = torch.empty(n, dtype=dtype, device=dev) if n else None
    n0 = build.kernels_launched("queue_scan")
    with torch.cuda.device(dev):
        err = fn(demand.data_ptr(), cap.data_ptr(), _ptr(prices),
                 None if hard else tau.data_ptr(), float(bound), b, t, d,
                 int(hard), sums.data_ptr(), _ptr(hist), q_final.data_ptr(),
                 _ptr(hr), _ptr(scratch), _stream(dev))
    if err != 0:
        raise RuntimeError(f"soft_ledger_fwd kernel launch failed: CUDA "
                           f"error {err}")
    soft_ledger_fwd.launches += 1
    soft_ledger_fwd.device_launches += \
        build.kernels_launched("queue_scan") - n0
    return sums, hist, q_final, hr


def soft_ledger_bwd(demand: torch.Tensor, cap: torch.Tensor,
                    tau: torch.Tensor, hist: torch.Tensor, g: torch.Tensor,
                    *, deadline: int, bound,
                    prices: Optional[torch.Tensor] = None,
                    want_demand: bool = True,
                    use_kernel: Optional[bool] = None):
    """``(d_cap [B, T], d_demand [B, T] or None)``: the VJP of
    `soft_ledger_fwd`'s (soft) sums for the cotangents ``g`` [4, B], from
    the forward's ``hist``. ``want_demand=False`` skips d demand (the
    tuner's demand carries no gradient). Two kernels on the card a window
    of hours, one window while the hours' smoothclip derivatives fit 128
    MiB. Routes like `soft_ledger_fwd` (`soft_ledger_bwd_ref` on the
    CPU)."""
    d = _check_deadline(deadline)
    if not _route(demand, use_kernel, "soft_ledger_bwd"):
        d_cap, d_dem = soft_ledger_bwd_ref(demand, cap, tau, hist, g,
                                           deadline=d, bound=bound,
                                           prices=prices)
        return d_cap, (d_dem if want_demand else None)
    dev = demand.device
    (b, t), dtype = _soft_checks(demand, cap, tau, prices, dev)
    _check("hist", hist, (t, b, d), dtype, dev)
    _check("g", g, (4, b), dtype, dev)
    lib = _library()
    fn = lib.soft_ledger_bwd_f64 if dtype == torch.float64 \
        else lib.soft_ledger_bwd_f32
    d_cap = torch.empty((b, t), dtype=dtype, device=dev)
    d_dem = torch.empty((b, t), dtype=dtype, device=dev) \
        if want_demand else None
    scratch = torch.empty(lib.soft_ledger_bwd_scratch(
        b, t, d, dtype.itemsize), dtype=dtype, device=dev)
    n0 = build.kernels_launched("queue_scan")
    with torch.cuda.device(dev):
        err = fn(demand.data_ptr(), cap.data_ptr(), _ptr(prices),
                 tau.data_ptr(), float(bound), b, t, d, hist.data_ptr(),
                 g.data_ptr(), d_cap.data_ptr(), _ptr(d_dem), _ptr(scratch),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"soft_ledger_bwd kernel launch failed: CUDA "
                           f"error {err}")
    soft_ledger_bwd.launches += 1
    soft_ledger_bwd.device_launches += \
        build.kernels_launched("queue_scan") - n0
    return d_cap, d_dem


for _fn in (workload_ledger_fwd, soft_ledger_fwd, soft_ledger_bwd):
    _fn.launches = 0
    _fn.device_launches = 0


class SoftLedger(torch.autograd.Function):
    """The soft ledger's four sums [B] each (served, dropped, backlog,
    served cost) of (demand, cap) at the MWh temperature ``tau``, then the
    final queue [B, D] (not differentiated), with the hand-written
    backward; saves the inputs and the queue entering every hour ([T, B,
    D] values)."""

    @staticmethod
    def forward(ctx, demand, cap, tau, prices, deadline, bound):
        sums, hist, q_final, _ = soft_ledger_fwd(
            demand, cap, tau, deadline=deadline, bound=bound, prices=prices)
        ctx.save_for_backward(demand, cap, tau, prices, hist)
        ctx.deadline, ctx.bound = deadline, bound
        ctx.mark_non_differentiable(q_final)
        return (*sums, q_final)

    @staticmethod
    def backward(ctx, *grads):
        demand, cap, tau, prices, hist = ctx.saved_tensors
        g = torch.stack([torch.zeros_like(demand[:, 0]) if x is None else x
                         for x in grads[:4]]).contiguous()
        d_cap, d_dem = soft_ledger_bwd(
            demand, cap, tau, hist, g, deadline=ctx.deadline,
            bound=ctx.bound, prices=prices,
            want_demand=ctx.needs_input_grad[0])
        return (d_dem, d_cap if ctx.needs_input_grad[1] else None, None,
                None, None, None)


def queue_scan(arrivals, cap, *, deadline: int, bound, tau=None,
               prices=None, hourly: bool = False,
               use_kernel: Optional[bool] = None):
    """Scan the work ledger over the horizon (the reference's contract).

    arrivals/cap: [..., T] MWh per hour, mutually broadcastable;
    ``prices`` (optional) prices each served MWh at the hour it is
    actually served. ``tau=None`` is the hard ledger; a number or tensor
    runs the `smoothclip` relaxation, differentiable in arrivals and
    capacity. Float64 inputs compute in float64, anything else in
    float32. With ``hourly=True`` returns ``(QueueScanOut, QueueHourly)``.

    Where the soft ledger must carry a gradient, every device runs
    `SoftLedger` over the flattened rows: the kernel pair on the card,
    their plain versions on the CPU (the hourly series then raise: they
    are not differentiated). Otherwise CUDA tensors launch the forward
    kernel and CPU tensors run `queue_scan_ref`. ``use_kernel=False``
    runs `queue_scan_ref`, autograd through its hour loop, on any
    device."""
    a, c, p = _ledger_inputs(arrivals, cap, prices)
    d = _check_deadline(deadline)
    kernel = _route(a, use_kernel, "queue_scan")
    grad = tau is not None and torch.is_grad_enabled() and (
        a.requires_grad or c.requires_grad)
    if use_kernel is False or not (kernel or grad):
        return queue_scan_ref(a, c, deadline=d, bound=bound, tau=tau,
                              prices=None if prices is None else p,
                              hourly=hourly)
    batch, t = a.shape[:-1], a.shape[-1]
    rows = lambda x: x.reshape(-1, t).contiguous()  # noqa: E731
    a2, c2 = rows(a), rows(c)
    p2 = None if prices is None else rows(p)
    tau_t = None if tau is None else _tau(tau, a.dtype, a.device)
    if grad:
        if hourly:
            raise ValueError("queue_scan(hourly=True) returns no gradient: "
                             "run it without one")
        *sums, q_final = SoftLedger.apply(a2, c2, tau_t, p2, d,
                                          float(bound))
    else:
        s, _, q_final, hr = soft_ledger_fwd(
            a2, c2, tau_t, deadline=d, bound=bound, prices=p2,
            hard=tau is None, keep_hist=False, hourly=hourly)
        sums = tuple(s)
    out = QueueScanOut(*(x.reshape(batch) for x in sums),
                       q_final.reshape(batch + (d,)))
    if hourly:
        return out, QueueHourly(*(x.reshape(batch + (t,)) for x in hr))
    return out


def workload_fleet_scan(prices: torch.Tensor, p_on, p_off, off_level,
                        idle_frac, cap_mwh, demand_mw: torch.Tensor, dt, *,
                        deadline: int, bound, hourly: bool = False,
                        market_idx: Optional[torch.Tensor] = None,
                        use_kernel: Optional[bool] = None):
    """Fleet shutdown state machine and work ledger over the horizon (the
    reference's contract, plus ``market_idx``).

    prices: [B, T] (or [N, T] with ``market_idx``); policy params: [B];
    ``cap_mwh`` [B] is the MWh one fully-on hour serves (power * dt);
    ``demand_mw`` [G, T] the demand draws (MW, converted per row to MWh
    by ``dt`` [B]). The fleet sums come from the engine's `fleet_scan`,
    the ledger from `workload_ledger_fwd` — two launches on the card, the
    ledger feeding nothing back. With ``hourly=True`` returns
    ``(WorkloadFleetOut, WorkloadHourly)``, the hourly means over rows x
    draws reduced from the kernel's per-row sums in float64, in a fixed
    order."""
    fleet = fleet_scan(prices, p_on, p_off, off_level, idle_frac,
                       market_idx=market_idx, use_kernel=use_kernel)
    led, hr = workload_ledger_fwd(
        prices, p_on, p_off, off_level, cap_mwh, demand_mw, dt,
        deadline=deadline, bound=bound, market_idx=market_idx,
        hourly=hourly, use_kernel=use_kernel)
    out = WorkloadFleetOut(fleet, *led)
    if not hourly:
        return out
    n = led.served.numel()
    return out, WorkloadHourly(*(hr.double().sum(1) / n).to(torch.float32))
