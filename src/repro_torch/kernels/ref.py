"""Plain PyTorch versions of the port's kernels.

Each function here is the straightforward form of one hand-written
kernel: the CPU runs it, and on the card it is what the kernel is held
against. The per-hour math mirrors the reference package's oracles line
for line.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FleetScanOut(NamedTuple):
    """Per-row sufficient statistics of a batched policy backtest.

    All cost quantities downstream (CPC, TCO, reduction) are affine in
    these four sums, so the scan never materialises the [B, T] mask.
    """

    draw_price_sum: torch.Tensor     # sum_t draw_t * p_t            [B]
    up_units: torch.Tensor           # sum_t capacity_t              [B]
    n_starts: torch.Tensor           # number of off->on transitions [B]
    restart_price_sum: torch.Tensor  # sum_t start_t * p_t           [B]


def hard_hour_step(on_prev, p_t, p_on, p_off, off_level, idle_frac):
    """One hour of the hard shutdown state machine (off is tested first).
    Returns ``(on, start, cap, draw)``, elementwise and broadcasting."""
    on = torch.where(p_t > p_off, 0.0,
                     torch.where(p_t <= p_on, 1.0, on_prev))
    start = torch.clamp(on - on_prev, min=0.0)
    cap = off_level + (1.0 - off_level) * on
    draw = cap + idle_frac * (1.0 - cap)
    return on, start, cap, draw


class FleetHourly(NamedTuple):
    """Per-hour fleet aggregates ([T] each) of a batched backtest — the
    payload of the ``fleet.hourly`` telemetry drain. The reductions over
    rows run on the device, so only 4T floats cross to the host."""

    on_mw: torch.Tensor       # sum_b weight_b * cap_bt (weighted capacity)
    draw_price: torch.Tensor  # sum_b weight_b * draw_bt * p_bt (EUR-rate)
    starts: torch.Tensor      # off->on transitions across rows
    stops: torch.Tensor       # on->off transitions across rows


def fleet_hourly_ref(prices: torch.Tensor, p_on, p_off, off_level,
                     idle_frac, weight) -> FleetHourly:
    """Hour-indexed companion of `fleet_scan_ref`: the same state machine,
    emitting [T] fleet aggregates instead of per-row sums. ``weight``
    ([B], e.g. each row's MW rating) scales capacity and draw into
    fleet-level MW; transition counts are unweighted.

    The reference steps `hard_hour_step` through a `lax.scan` over hours;
    here the trajectory comes without an hour loop. A row's state at hour
    t is fixed by its last decisive hour at or before t (``p > p_off``
    turns it off, else ``p <= p_on`` turns it on; otherwise it carries,
    starting on): the decisive hours are coded ``2t + on``, a cummax over
    [B, T] finds the last one, and its low bit is the state — the rule
    the fleet-scan kernel and `fleet_scan_seg_ref` use. Capacity, draw,
    starts and stops are then elementwise (as `hard_hour_step` computes
    them), and the [T] sums over rows are reductions: the states,
    starts and stops equal the reference's exactly; ``on_mw`` and
    ``draw_price`` are float32 sums over rows in another order."""
    p = prices.to(torch.float32)
    b, t = p.shape
    p_on, p_off, off_level, idle_frac, weight = (
        torch.as_tensor(v, device=p.device).to(torch.float32)
        .expand(b)[:, None]
        for v in (p_on, p_off, off_level, idle_frac, weight))
    off = p > p_off
    turn_on = (p <= p_on) & ~off
    hour = torch.arange(t, device=p.device)
    code = torch.where(off | turn_on, 2 * hour + turn_on.long(), -1)
    last = torch.cummax(code, dim=1).values
    on = torch.where(last >= 0, (last & 1).to(torch.float32), 1.0)
    on_prev = torch.cat([torch.ones_like(on[:, :1]), on[:, :-1]], 1)
    start = torch.clamp(on - on_prev, min=0.0)
    stop = torch.clamp(on_prev - on, min=0.0)
    cap = off_level + (1.0 - off_level) * on
    draw = cap + idle_frac * (1.0 - cap)
    return FleetHourly(on_mw=torch.sum(weight * cap, 0),
                       draw_price=torch.sum(weight * draw * p, 0),
                       starts=torch.sum(start, 0), stops=torch.sum(stop, 0))


def fleet_scan_ref(prices: torch.Tensor, p_on, p_off, off_level,
                   idle_frac) -> FleetScanOut:
    """Sequential batched hysteresis/threshold scan, one step per hour.

    prices: [B, T]; p_on/p_off/off_level/idle_frac: [B] (or broadcastable)
    per-row policy parameters with p_on <= p_off. Per row, starting on:

        on_t = 0 if p_t > p_off, 1 if p_t <= p_on, else on_{t-1}

    Capacity while "off" is ``off_level``; residual draw while off is
    ``idle_frac`` of the shut-down capacity. Float64 prices compute in
    float64, anything else in float32 (the reference's type).
    """
    dtype = torch.float64 if prices.dtype == torch.float64 \
        else torch.float32
    p = prices.to(dtype)
    b = p.shape[0]
    p_on, p_off, off_level, idle_frac = (
        torch.as_tensor(v, device=p.device).to(dtype)
        .expand(b).contiguous() for v in (p_on, p_off, off_level, idle_frac))
    on = torch.ones(b, dtype=dtype, device=p.device)
    acc = [torch.zeros_like(on) for _ in range(4)]
    for p_t in p.T:
        on_new, start, cap, draw = hard_hour_step(on, p_t, p_on, p_off,
                                                  off_level, idle_frac)
        acc = [acc[0] + draw * p_t, acc[1] + cap,
               acc[2] + start, acc[3] + start * p_t]
        on = on_new
    return FleetScanOut(*acc)


FLEET_SCAN_THREADS = 256   # the fleet-scan kernel's threads a row (NT)
# the hours a thread may own in a window of the fleet-scan kernel, each a
# kernel of its own
FLEET_SCAN_SEGS = (1, 2, 4, 9, 18, 36)


def fleet_scan_seg(t: int, nt: int = FLEET_SCAN_THREADS,
                   segs: tuple = FLEET_SCAN_SEGS) -> int:
    """Hours a thread owns in a window of the fleet-scan kernel (L): the
    fewest of ``segs`` that cover ``t`` in one window of ``nt * L`` hours,
    or the most, in as many windows as it takes."""
    return next((s for s in segs if nt * s >= t), segs[-1])


def fleet_scan_seg_ref(prices: torch.Tensor, p_on, p_off, off_level,
                       idle_frac, *, threads: int = FLEET_SCAN_THREADS,
                       hours: int | None = None) -> FleetScanOut:
    """`fleet_scan_ref` as the CUDA kernel computes it (used by the tests
    and the chip check, never by the wrappers): windows of ``threads *
    hours`` hours (``hours`` defaults to `fleet_scan_seg`), each thread
    owning ``hours`` consecutive hours of a window. Per window: each
    thread's last decisive event, coded ``2k + on`` at window hour k (-1
    where its hours decide nothing); the exclusive max-scan of those codes
    across the threads, whose low bit is each thread's entering state (the
    window's entering state where no event came earlier: 1 before the
    first hour, then the state the largest code of the last window left);
    each thread's replay of its hours through `hard_hour_step` from that
    state, adding the four terms into sums of its own in the prices'
    dtype. Then a tree adds the sums in float64: within each warp of 32
    threads (pairs ``l`` and ``l + st`` for ``st`` = 16, ..., 1), then over
    the warps' sums the same way; rounded once to the prices' dtype
    (float64 stays float64, anything else float32). ``threads`` is a power
    of two of at least 32."""
    if threads < 32 or threads & (threads - 1):
        raise ValueError(f"threads must be a power of two of at least 32, "
                         f"got {threads}")
    dtype = torch.float64 if prices.dtype == torch.float64 \
        else torch.float32
    p = prices.to(dtype)
    b, t = p.shape
    p_on, p_off, off_level, idle_frac = (
        torch.as_tensor(v, device=p.device).to(dtype)
        .expand(b).contiguous()[:, None]
        for v in (p_on, p_off, off_level, idle_frac))
    seg = hours or fleet_scan_seg(t, threads)
    w = threads * seg
    k = torch.arange(w, device=p.device).reshape(threads, seg)
    carry = torch.ones((b, 1), dtype=dtype, device=p.device)
    acc = [torch.zeros((b, threads), dtype=dtype, device=p.device)
           for _ in range(4)]
    for t0 in range(0, t, w):
        n = min(w, t - t0)
        pw = torch.nn.functional.pad(p[:, t0:t0 + n], (0, w - n)) \
            .reshape(b, threads, seg)
        valid = k < n
        off = (pw > p_off[..., None]) & valid
        on = (pw <= p_on[..., None]) & valid & ~off
        last = torch.where(off | on, 2 * k + on.long(), -1).amax(-1)
        incl = torch.cummax(last, dim=1).values
        before = torch.cat([torch.full_like(incl[:, :1], -1),
                            incl[:, :-1]], 1)
        state = torch.where(before >= 0, (before & 1).to(dtype), carry)
        every = incl[:, -1:]
        carry = torch.where(every >= 0, (every & 1).to(dtype), carry)
        for j in range(seg):
            v, x = valid[:, j], pw[..., j]
            now, start, cap, draw = hard_hour_step(state, x, p_on, p_off,
                                                   off_level, idle_frac)
            acc = [torch.where(v, a + d, a)
                   for a, d in zip(acc, (draw * x, cap, start, start * x))]
            state = torch.where(v, now, state)
    acc = [a.double().reshape(b, threads // 32, 32) for a in acc]
    for width in (32, threads // 32):
        st = width // 2
        while st > 0:
            acc = [a[..., :st] + a[..., st:2 * st] for a in acc]
            st //= 2
        acc = [a[..., 0] for a in acc]
    return FleetScanOut(*(a.to(dtype) for a in acc))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)): exact 0 and 1 at the ends, the form the CUDA
    kernels use. Built from `torch.exp` and IEEE arithmetic, which give
    every element the same bits wherever it sits in the tensor (the CPU's
    `torch.sigmoid` rounds the vector body and the scalar tail
    differently), so per-row results do not depend on the batch."""
    return 1.0 / (1.0 + torch.exp(-x))


def soft_gates(p_t, p_on, p_off, inv_tau):
    """Per-hour sigmoid event gates of the relaxed hysteresis recurrence.

    Returns ``(a, f, alpha, beta)`` with a = sigmoid((p_on - p_t)/tau)
    ("turn on"), f = sigmoid((p_t - p_off)/tau) ("turn off"), and the
    affine-map coefficients of s_t = alpha_t s_{t-1} + beta_t.
    Elementwise and broadcasting; shared by every soft-scan path.
    """
    a = _sigmoid((p_on - p_t) * inv_tau)
    f = _sigmoid((p_t - p_off) * inv_tau)
    return a, f, (1.0 - a) * (1.0 - f), a


def soft_gate_grad(p_t, s_prev, u_t, p_on, p_off, inv_tau, gates=None):
    """Per-hour chain rule of the relaxed recurrence.

    Given the adjoint u_t = dL/ds_t (accumulated through later hours) and
    the entering state s_{t-1}, backpropagates through
    s_t = alpha_t s_{t-1} + beta_t and the gates to the hour's inputs.
    Returns per-hour ``(d_p, d_p_on, d_p_off, d_inv_tau)``; callers sum
    the last three over t (and convert d_inv_tau to d_tau via
    d_tau = -inv_tau^2 d_inv_tau). ``gates`` passes an already evaluated
    ``(a, f)``.
    """
    a, f = gates if gates is not None else \
        soft_gates(p_t, p_on, p_off, inv_tau)[:2]
    d_alpha = u_t * s_prev                  # d beta = u_t
    d_a = u_t - d_alpha * (1.0 - f)         # alpha = (1-a)(1-f), beta = a
    d_f = -d_alpha * (1.0 - a)
    d_zon = d_a * a * (1.0 - a)             # z_on  = (p_on - p) inv_tau
    d_zoff = d_f * f * (1.0 - f)            # z_off = (p - p_off) inv_tau
    d_p = (d_zoff - d_zon) * inv_tau
    d_p_on = d_zon * inv_tau
    d_p_off = -d_zoff * inv_tau
    d_inv_tau = d_zon * (p_on - p_t) + d_zoff * (p_t - p_off)
    return d_p, d_p_on, d_p_off, d_inv_tau


def _soft_inputs(prices, p_on, p_off, tau):
    """(p [B, T], p_on [B], p_off [B], inv_tau) in the price dtype
    (float64 stays float64, anything else float32)."""
    dtype = torch.float64 if prices.dtype == torch.float64 \
        else torch.float32
    p = prices.to(dtype)
    b = p.shape[0]
    p_on, p_off = (torch.as_tensor(v, device=p.device).to(dtype)
                   .expand(b).contiguous() for v in (p_on, p_off))
    inv_tau = 1.0 / torch.as_tensor(tau, device=p.device).to(dtype)
    return p, p_on, p_off, inv_tau


def soft_scan_ref(prices: torch.Tensor, p_on, p_off, off_level, idle_frac,
                  *, tau) -> FleetScanOut:
    """Sequential oracle for the temperature-``tau`` relaxation of
    `fleet_scan_ref`:

        s_t = a_t + (1 - a_t)(1 - b_t) s_{t-1},   s_{-1} = 1

    with a_t = sigmoid((p_on - p_t)/tau), b_t = sigmoid((p_t - p_off)/tau).
    Restarts count softly as s_t (1 - s_{t-1}). Computes in the price
    dtype (float64 stays float64)."""
    p, p_on, p_off, inv_tau = _soft_inputs(prices, p_on, p_off, tau)
    b = p.shape[0]
    off_level, idle_frac = (torch.as_tensor(v, device=p.device).to(p.dtype)
                            .expand(b) for v in (off_level, idle_frac))
    s_prev = torch.ones(b, dtype=p.dtype, device=p.device)
    acc = [torch.zeros_like(s_prev) for _ in range(4)]
    for p_t in p.T:
        _, _, alpha, beta = soft_gates(p_t, p_on, p_off, inv_tau)
        s = alpha * s_prev + beta
        start = s * (1.0 - s_prev)
        cap = off_level + (1.0 - off_level) * s
        draw = cap + idle_frac * (1.0 - cap)
        acc = [acc[0] + draw * p_t, acc[1] + cap,
               acc[2] + start, acc[3] + start * p_t]
        s_prev = s
    return FleetScanOut(*acc)


def soft_scan_grad_ref(prices: torch.Tensor, p_on, p_off, g, *, tau):
    """Sequential oracle for the VJP of the soft-state trajectory: given
    the cotangent ``g`` [B, T] of the states, runs the recurrence forward,
    then walks time in reverse with the adjoint
    u_t = g_t + alpha_{t+1} u_{t+1} and `soft_gate_grad`. Returns
    ``(d_prices [B, T], d_p_on [B], d_p_off [B], d_tau [])``."""
    p, p_on, p_off, inv_tau = _soft_inputs(prices, p_on, p_off, tau)
    g = torch.as_tensor(g, device=p.device).to(p.dtype)
    b = p.shape[0]
    s_prev, alphas, s = [], [], torch.ones(b, dtype=p.dtype, device=p.device)
    for p_t in p.T:
        _, _, alpha, beta = soft_gates(p_t, p_on, p_off, inv_tau)
        s_prev.append(s)
        alphas.append(alpha)
        s = alpha * s + beta
    u = torch.zeros_like(s)
    alpha_next = torch.zeros_like(s)
    d_p = [None] * p.shape[1]
    d_on = d_off = d_it = torch.zeros_like(s)
    for t in range(p.shape[1] - 1, -1, -1):
        u = g[:, t] + alpha_next * u
        dp_t, don_t, doff_t, dit_t = soft_gate_grad(
            p[:, t], s_prev[t], u, p_on, p_off, inv_tau)
        d_p[t] = dp_t
        d_on, d_off, d_it = d_on + don_t, d_off + doff_t, d_it + dit_t
        alpha_next = alphas[t]
    d_tau = -inv_tau ** 2 * torch.sum(d_it)
    return torch.stack(d_p, dim=1), d_on, d_off, d_tau


def soft_scan_fwd_ref(p: torch.Tensor, p_on: torch.Tensor,
                      p_off: torch.Tensor, inv_tau, block_t: int):
    """Plain version of the soft-scan forward kernel: the state trajectory
    s [B, T] (s_{-1} = 1) and the state entering each ``block_t``-hour
    block, ``carries`` [B, ceil(T / block_t)], the only residual the
    backward needs. Sequential in time, vectorised over rows, in the
    inputs' dtype. (The reference's blocked XLA forward, `_xla_fwd`.)"""
    b, t = p.shape
    _, _, alpha, beta = soft_gates(p, p_on[:, None], p_off[:, None],
                                   inv_tau)                       # [B, T]
    s = torch.ones(b, dtype=p.dtype, device=p.device)
    cols = []
    for i in range(t):
        s = alpha[:, i] * s + beta[:, i]
        cols.append(s)
    s_all = torch.stack(cols, dim=1)
    nb = -(-t // block_t)
    ones = torch.ones((b, 1), dtype=p.dtype, device=p.device)
    idx = torch.arange(1, nb, device=p.device) * block_t - 1
    return s_all, torch.cat([ones, s_all[:, idx]], dim=1)


def soft_scan_bwd_ref(p: torch.Tensor, p_on: torch.Tensor,
                      p_off: torch.Tensor, inv_tau, carries: torch.Tensor,
                      g: torch.Tensor, block_t: int):
    """Plain version of the soft-scan backward kernel (the reference's
    blocked XLA backward, `_xla_bwd`): walk the ``block_t``-hour blocks in
    reverse; in each, recompute the gates and the states from the saved
    entering carry, run the adjoint u_t = g_t + alpha_{t+1} u_{t+1}
    across the block (seeded by the later block's first hour), apply
    `soft_gate_grad` and add the block's parameter sums. Returns
    ``(d_p [B, T], d_p_on [B], d_p_off [B], d_inv_tau [])``."""
    b, t = p.shape
    nb = -(-t // block_t)
    zeros = torch.zeros(b, dtype=p.dtype, device=p.device)
    u_next, a_next = zeros, zeros
    acc = [zeros, zeros, zeros]
    d_p = [None] * nb
    pon, poff = p_on[:, None], p_off[:, None]
    for j in range(nb - 1, -1, -1):
        sl = slice(j * block_t, min((j + 1) * block_t, t))
        p_b, g_b = p[:, sl], g[:, sl]
        a, f, alpha, beta = soft_gates(p_b, pon, poff, inv_tau)
        s = carries[:, j]
        s_prev = []
        for i in range(p_b.shape[1]):
            s_prev.append(s)
            s = alpha[:, i] * s + beta[:, i]
        u = [None] * p_b.shape[1]
        for i in range(p_b.shape[1] - 1, -1, -1):
            u_next = g_b[:, i] + a_next * u_next
            u[i] = u_next
            a_next = alpha[:, i]
        dp_b, d_on, d_off, d_it = soft_gate_grad(
            p_b, torch.stack(s_prev, dim=1), torch.stack(u, dim=1), pon,
            poff, inv_tau, gates=(a, f))
        d_p[j] = dp_b
        acc = [acc[0] + d_on.sum(1), acc[1] + d_off.sum(1),
               acc[2] + d_it.sum(1)]
    return torch.cat(d_p, dim=1), acc[0], acc[1], torch.sum(acc[2])


SOFT_SCAN_THREADS = 256   # the soft-scan kernels' threads a row (NT)
SOFT_SCAN_MAX_SEG = 12    # the most hours a thread owns in a window


def soft_scan_seg(t: int, nt: int = SOFT_SCAN_THREADS,
                  max_seg: int = SOFT_SCAN_MAX_SEG) -> int:
    """Hours a thread owns in a window of the soft-scan kernels (L): as
    few windows of at most ``nt * max_seg`` hours as cover ``t``, then the
    fewest hours a thread that still covers ``t`` in that many."""
    nw = -(-t // (nt * max_seg))
    return -(-t // (nw * nt))


def _seg_window(p: torch.Tensor, p_on, p_off, inv_tau, nt: int, seg: int):
    """One window p [B, n] (n <= nt * seg) laid out as the kernels'
    threads own its hours, [B, nt, seg] (zeros past n): the prices, their
    gates a, f and alpha, and which hours exist [nt, seg]."""
    b, n = p.shape
    pp = torch.nn.functional.pad(p, (0, nt * seg - n)).reshape(b, nt, seg)
    valid = (torch.arange(nt * seg, device=p.device) < n).reshape(nt, seg)
    a, f, alpha, _ = soft_gates(pp, p_on[:, None, None],
                                p_off[:, None, None], inv_tau)
    return pp, a, f, alpha, valid


def _seg_maps(a, alpha, valid):
    """Each thread's segment map s -> A s + B, composed in float64 in hour
    order."""
    wide = torch.float64
    m = torch.ones(a.shape[:2], dtype=wide, device=a.device)
    c = torch.zeros_like(m)
    for j in range(a.shape[2]):
        v, al = valid[:, j], alpha[..., j].to(wide)
        m, c = (torch.where(v, al * m, m),
                torch.where(v, al * c + a[..., j].to(wide), c))
    return m, c


def _block_scan(m, c, x, reverse: bool):
    """The kernels' block scan of the threads' maps [B, nt] from x [B]:
    Kogge-Stone within each warp of 32 (in lane order, or against it), the
    warp totals folded in order from x. Returns the value entering each
    thread's segment [B, nt] and the value after the window [B]."""
    b, nt = m.shape
    m, c = m.reshape(b, nt // 32, 32), c.reshape(b, nt // 32, 32)
    lane = torch.arange(32, device=m.device)
    d = 1
    while d < 32:
        if reverse:
            mp = torch.cat([m[..., d:], m[..., 32 - d:]], -1)
            cp = torch.cat([c[..., d:], c[..., 32 - d:]], -1)
            take = lane + d < 32
        else:
            mp = torch.cat([m[..., :d], m[..., :32 - d]], -1)
            cp = torch.cat([c[..., :d], c[..., :32 - d]], -1)
            take = lane >= d
        m, c = torch.where(take, m * mp, m), torch.where(take, m * cp + c, c)
        d *= 2
    # each lane's exclusive map (the identity at the warp's first lane)
    one, zero = torch.ones_like(m[..., :1]), torch.zeros_like(c[..., :1])
    if reverse:
        me = torch.cat([m[..., 1:], one], -1)
        ce = torch.cat([c[..., 1:], zero], -1)
        tm, tc, order = m[..., 0], c[..., 0], range(nt // 32 - 1, -1, -1)
    else:
        me = torch.cat([one, m[..., :-1]], -1)
        ce = torch.cat([zero, c[..., :-1]], -1)
        tm, tc, order = m[..., 31], c[..., 31], range(nt // 32)
    xw = torch.empty_like(tm)
    for k in order:
        xw[:, k] = x
        x = tm[:, k] * x + tc[:, k]
    return (me * xw[..., None] + ce).reshape(b, nt), x


def soft_scan_fwd_seg_ref(p: torch.Tensor, p_on: torch.Tensor,
                          p_off: torch.Tensor, inv_tau, block_t: int, *,
                          nt: int = SOFT_SCAN_THREADS,
                          seg: int | None = None):
    """`soft_scan_fwd_ref` as the CUDA kernel computes it (used by the
    tests and the chip check, never by the wrappers): windows of
    ``nt * seg`` hours (``seg`` defaults to `soft_scan_seg`), each thread's
    segment map composed in float64, one block scan a window from its
    entering state (s_{-1} = 1, then the last window's exit state, in
    float64), each segment rerun in the inputs' dtype from its entering
    state rounded once; the carries are the rerun states at the block
    ends. Returns ``(s [B, T], carries [B, ceil(T / block_t)])``."""
    b, t = p.shape
    seg = seg or soft_scan_seg(t, nt)
    w = nt * seg
    s_in = torch.ones(b, dtype=torch.float64, device=p.device)
    out = []
    for t0 in range(0, t, w):
        n = min(w, t - t0)
        _, a, _, alpha, valid = _seg_window(p[:, t0:t0 + n], p_on, p_off,
                                            inv_tau, nt, seg)
        x, s_in = _block_scan(*_seg_maps(a, alpha, valid), s_in, False)
        s = x.to(p.dtype)
        cols = []
        for j in range(seg):
            s = torch.where(valid[:, j], alpha[..., j] * s + a[..., j], s)
            cols.append(s)
        out.append(torch.stack(cols, -1).reshape(b, w)[:, :n])
    s_all = torch.cat(out, 1)
    nb = -(-t // block_t)
    ones = torch.ones((b, 1), dtype=p.dtype, device=p.device)
    idx = torch.arange(1, nb, device=p.device) * block_t - 1
    return s_all, torch.cat([ones, s_all[:, idx]], dim=1)


def soft_scan_bwd_seg_ref(p: torch.Tensor, p_on: torch.Tensor,
                          p_off: torch.Tensor, inv_tau, carries: torch.Tensor,
                          g: torch.Tensor, block_t: int, *,
                          nt: int = SOFT_SCAN_THREADS,
                          seg: int | None = None):
    """`soft_scan_bwd_ref` as the CUDA kernel computes it (used by the
    tests and the chip check, never by the wrappers): the windows of
    `soft_scan_fwd_seg_ref` from the last to the first. A window's
    entering state is its block's carry, swept forward (composed and
    scanned in pieces of one window) where the window starts inside the
    block; its forward maps are scanned from it and its adjoint maps
    w -> A w + Q (w = alpha_{t1} u_{t1}, composed backwards in float64)
    against the thread order from the later window's seed; each segment
    reruns its states and walks back through `soft_gate_grad` in the
    inputs' dtype, adding each thread's three sums in float64, which a
    tree over the ``nt`` threads then adds. Returns ``(d_p [B, T],
    d_p_on [B], d_p_off [B], d_inv_tau [])``."""
    b, t = p.shape
    seg = seg or soft_scan_seg(t, nt)
    w = nt * seg
    wide = torch.float64
    pon, poff = p_on[:, None], p_off[:, None]
    w_in = torch.zeros(b, dtype=wide, device=p.device)
    acc = [torch.zeros((b, nt), dtype=wide, device=p.device)
           for _ in range(3)]
    d_p = []
    for t0 in range(((t - 1) // w) * w, -1, -w):
        n = min(w, t - t0)
        c = t0 // block_t
        s_in = carries[:, c].to(wide)
        for h in range(c * block_t, t0, w):
            _, a, _, alpha, valid = _seg_window(p[:, h:min(h + w, t0)],
                                                p_on, p_off, inv_tau, nt,
                                                seg)
            s_in = _block_scan(*_seg_maps(a, alpha, valid), s_in, False)[1]
        pw, a, f, alpha, valid = _seg_window(p[:, t0:t0 + n], p_on, p_off,
                                             inv_tau, nt, seg)
        gw = torch.nn.functional.pad(g[:, t0:t0 + n], (0, w - n)) \
            .reshape(b, nt, seg)
        m_q = torch.ones((b, nt), dtype=wide, device=p.device)
        q = torch.zeros_like(m_q)
        for j in range(seg - 1, -1, -1):
            v, al = valid[:, j], alpha[..., j].to(wide)
            u = gw[..., j].to(wide) + q
            m_q, q = torch.where(v, al * m_q, m_q), torch.where(v, al * u, q)
        x, _ = _block_scan(*_seg_maps(a, alpha, valid), s_in, False)
        y, w_in = _block_scan(m_q, q, w_in, True)
        s = x.to(p.dtype)
        s_prev = []
        for j in range(seg):
            s_prev.append(s)
            s = torch.where(valid[:, j], alpha[..., j] * s + a[..., j], s)
        wt = y.to(p.dtype)
        cols = [None] * seg
        for j in range(seg - 1, -1, -1):
            v = valid[:, j]
            u = gw[..., j] + wt
            dp, don, doff, dit = soft_gate_grad(
                pw[..., j], s_prev[j], u, pon, poff, inv_tau,
                gates=(a[..., j], f[..., j]))
            acc = [torch.where(v, x_ + d.to(wide), x_)
                   for x_, d in zip(acc, (don, doff, dit))]
            wt = torch.where(v, alpha[..., j] * u, wt)
            cols[j] = dp
        d_p.insert(0, torch.stack(cols, -1).reshape(b, w)[:, :n])
    st = nt // 2
    while st > 0:
        acc = [x_[:, :st] + x_[:, st:2 * st] for x_ in acc]
        st //= 2
    sums = [x_[:, 0].to(p.dtype) for x_ in acc]
    return (torch.cat(d_p, 1), sums[0], sums[1],
            torch.sum(sums[2].double()).to(p.dtype))


DWELL_EVENT_MW = 1e-3  # allocation increase (MW) that counts as a fresh
                       # placement and rearms the dwell lock: far above
                       # float32 rounding, far below any real move


def dispatch_alloc_hour(prev: torch.Tensor, dwell: torch.Tensor,
                        avail: torch.Tensor, rank: torch.Tensor, demand, *,
                        min_dwell: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One hour of feasible cross-site dispatch (greedy water-fill).

    Each site offers three price-sorted capacity segments: ``locked``
    (load held < ``min_dwell`` hours, ranked below everything), ``retain``
    (the rest of the previous allocation, priced at p - migrate_cost) and
    ``fresh`` (unused capacity at the market price). ``rank`` is the
    inverse of the ascending sort permutation of the 3S segment keys
    (`repro_torch.dispatch.segment_rank`): scattering the widths to
    ``rank`` is the reference's gather by ``order``, so the permutation
    itself is not needed. The fill is scatter -> exclusive prefix ->
    gather back -> ``clip(demand - before, 0, width)``.

    The port's summation order, shared with the CUDA kernel
    (``csrc/dispatch_scan.cu``) bit for bit: the exclusive prefix is
    taken over the sorted widths sequentially in float64 and rounded to
    float32 once (PyTorch's CPU `cumsum` of a float64 tensor runs
    sequentially; a float32 one would accumulate in float64 on the CPU
    and in parallel float32 on CUDA, so it is never used here); the
    three fills add as ``(locked + retain) + fresh``; the dwell rearm
    compares in float32. Where every partial sum is exact in float32
    this equals the reference's ``jnp.cumsum(w) - w`` bit for bit;
    elsewhere the two differ in the last bits (XLA sums in its own
    order and rounds twice).

    prev/dwell/avail: [S] float32 (CPU); rank: [3S] int64; demand:
    a float32 scalar tensor. Returns ``(alloc [S], dwell' [S])``.
    Capacity loss breaks a dwell lock: locked width is capped at
    ``avail``.
    """
    s = prev.shape[0]
    held = torch.minimum(prev, avail)
    if min_dwell > 0:
        locked = torch.where(dwell > 0.0, held, torch.zeros_like(held))
    else:
        locked = torch.zeros_like(held)
    widths = torch.cat([locked, held - locked, avail - held])
    sw = torch.empty_like(widths)
    sw[rank] = widths                    # the widths in price order
    incl = torch.cumsum(sw.double(), 0)
    excl = torch.cat([incl.new_zeros(1), incl[:-1]]).to(torch.float32)
    before = excl[rank]                  # MW at strictly cheaper segments
    fill = torch.minimum(torch.clamp(demand - before, min=0.0), widths)
    alloc = (fill[:s] + fill[s:2 * s]) + fill[2 * s:]
    if min_dwell > 0:
        margin = prev + torch.tensor(DWELL_EVENT_MW, dtype=torch.float32)
        dwell = torch.where(alloc > margin,
                            torch.full_like(dwell, float(min_dwell)),
                            torch.clamp(dwell - 1.0, min=0.0))
    return alloc, dwell


WALK_STEP = 8   # sorted positions the kernel's walk sums between tests


def dispatch_alloc_hour_cut(prev: torch.Tensor, dwell: torch.Tensor,
                            avail: torch.Tensor, rank: torch.Tensor, demand,
                            *, min_dwell: int
                            ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """`dispatch_alloc_hour` as the CUDA kernel takes it since its walk
    stops at the demand (used by the tests and to count the walk).

    When every width is >= 0, the exclusive prefix over the sorted widths
    never decreases, and neither does its float32 rounding; so once the
    float64 prefix reaches the demand (and with it its rounding, the
    demand being a float32), every later segment fills ``min(max(demand
    - pre, 0), w) = 0``. The kernel's thread 0 sums the prefix in steps of
    `WALK_STEP` positions (sequentially in float64, as here) and tests the
    sum at the end of each step: it stops at the end of the first step
    whose sum reaches the demand (the cut). The fill takes +inf for the
    prefix at ranks at or past the cut, which gives the same 0 through the
    same operations; below the cut it reads the prefix, rounded once to
    float32. An hour with a negative (or NaN) width, or whose demand no
    step reaches before the last, has its cut at 3S: the walk goes to the
    end. The prefix is summed here over all positions; below the cut its
    values are the walk's.

    Arguments as `dispatch_alloc_hour`. Returns ``(alloc [S], dwell' [S],
    cut)``: the cut is the number of sorted positions the walk sums.
    """
    s = prev.shape[0]
    n3 = 3 * s
    held = torch.minimum(prev, avail)
    if min_dwell > 0:
        locked = torch.where(dwell > 0.0, held, torch.zeros_like(held))
    else:
        locked = torch.zeros_like(held)
    widths = torch.cat([locked, held - locked, avail - held])
    sw = torch.empty_like(widths)
    sw[rank] = widths
    incl = torch.cumsum(sw.double(), 0)
    excl = torch.cat([incl.new_zeros(1), incl[:-1]]).to(torch.float32)
    cut = n3
    if bool((widths >= 0.0).all()):
        # the ends of the steps that leave more to walk
        ends = torch.arange(WALK_STEP - 1, max(n3 - 1, WALK_STEP - 1),
                            WALK_STEP)
        hit = torch.nonzero(incl[ends] >= torch.as_tensor(demand).double())
        if hit.numel():
            cut = int(ends[hit[0, 0]]) + 1
    before = torch.where(rank < cut, excl[rank],
                         torch.tensor(float("inf"), dtype=torch.float32))
    fill = torch.minimum(torch.clamp(demand - before, min=0.0), widths)
    alloc = (fill[:s] + fill[s:2 * s]) + fill[2 * s:]
    if min_dwell > 0:
        margin = prev + torch.tensor(DWELL_EVENT_MW, dtype=torch.float32)
        dwell = torch.where(alloc > margin,
                            torch.full_like(dwell, float(min_dwell)),
                            torch.clamp(dwell - 1.0, min=0.0))
    return alloc, dwell, cut


def dispatch_cut_ref(avail: torch.Tensor, rank: torch.Tensor,
                     demand: torch.Tensor, *, min_dwell: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`dispatch_ref` through `dispatch_alloc_hour_cut`: the allocation
    [S, T] and the sorted positions the kernel's walk sums each hour [T]
    (int64), both on the CPU."""
    a = avail.to("cpu", torch.float32)
    r = rank.to("cpu", torch.int64)
    d = demand.to("cpu", torch.float32)
    s, t = a.shape
    a_t = a.T.contiguous()
    prev = torch.zeros(s, dtype=torch.float32)
    dwell = torch.zeros(s, dtype=torch.float32)
    out = torch.empty((t, s), dtype=torch.float32)
    walked = torch.empty(t, dtype=torch.int64)
    for h in range(t):
        prev, dwell, walked[h] = dispatch_alloc_hour_cut(
            prev, dwell, a_t[h], r[h], d[h], min_dwell=min_dwell)
        out[h] = prev
    return out.T.contiguous(), walked


def dispatch_ref(avail: torch.Tensor, rank: torch.Tensor,
                 demand: torch.Tensor, *, min_dwell: int = 0
                 ) -> torch.Tensor:
    """Sequential plain version of the hour-by-hour dispatch scan.

    avail: [S, T] available MW; rank: [T, 3S] segment sort ranks;
    demand: [T] MW. Returns the allocation [S, T] (float32) on the
    inputs' device. The loop runs on the CPU wherever the inputs lie, so
    its float64 prefix has one fixed (sequential) order; CUDA inputs are
    copied to the host and the result copied back. Starts empty: hour 0
    places the fleet's load.
    """
    cpu = torch.device("cpu")
    a = avail.to(cpu, torch.float32)
    r = rank.to(cpu, torch.int64)
    d = demand.to(cpu, torch.float32)
    s, t = a.shape
    a_t = a.T.contiguous()
    prev = torch.zeros(s, dtype=torch.float32)
    dwell = torch.zeros(s, dtype=torch.float32)
    out = torch.empty((t, s), dtype=torch.float32)
    for h in range(t):
        prev, dwell = dispatch_alloc_hour(prev, dwell, a_t[h], r[h], d[h],
                                          min_dwell=min_dwell)
        out[h] = prev
    return out.T.contiguous().to(avail.device)


# ---------------------------------------------------------------------------
# The relaxed (entropic) water-fill: plain versions of the three soft-dispatch
# kernels (``csrc/soft_dispatch.cu``).
#
# Arithmetic, shared with the kernels: every element-wise quantity is
# float32 (float64 for float64 inputs), each operation rounded once (the
# kernels are built without fused multiply-adds); exp and log1p are
# evaluated in float64 and rounded once to float32 (`_exp_rn`), so both
# sides get the correctly rounded value, where CUDA's expf and the host's
# exp differ in the last bit; every reduction over the 3S segments adds
# float32 terms in float64 and is rounded once where a float32 value is
# needed (the Newton residual ``demand - sum`` is then taken in float32, as
# the reference takes it); the hard-level prefix is summed sequentially in
# float64 in sorted order; the renormalisation factor and its adjoint are
# formed in float64 (an hour whose fill sum is tiny stays finite). The kernels add the other
# float64 sums in another fixed order, so they agree with these functions
# within a tolerance, not bit for bit. That matters: in an hour whose
# demand equals a prefix of the sorted widths (with dwell locks and a flat
# demand, every hour), the level lies in a gap between keys, the Newton
# step extrapolates a vanishing slope and is clipped at 40 tau, and a
# rounding-level change in the residual can move the allocation by O(1)
# MW, which the dwell ledger then carries forward.
# ---------------------------------------------------------------------------

_WL_TINY = 1e-30       # absolute floor for water-level denominators
_WL_SIGMA_SPAN = 40.0  # sigmoid(+-40) saturates in float32 and float64: the
                       # soft water level lives within +-40 tau of the hard
                       # one
_DWELL_CNT_SCALE = 0.05  # dwell-count temperature per price-unit tau


def _exp_rn(x: torch.Tensor) -> torch.Tensor:
    """exp(x) rounded once to x's dtype: a float32 x is exponentiated in
    float64 (under one float64 ulp of error) and rounded to float32, as
    the soft-dispatch kernels do."""
    if x.dtype == torch.float64:
        return torch.exp(x)
    return torch.exp(x.double()).to(x.dtype)


def _log1p_rn(x: torch.Tensor) -> torch.Tensor:
    """log1p(x) rounded once to x's dtype (see `_exp_rn`)."""
    if x.dtype == torch.float64:
        return torch.log1p(x)
    return torch.log1p(x.double()).to(x.dtype)


def _sig_rn(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) with the correctly rounded exp of `_exp_rn`."""
    return 1.0 / (1.0 + _exp_rn(-x))


def _softplus_rn(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) = max(x, 0) + log1p(exp(-|x|)), the value of
    `jax.nn.softplus`, with `_exp_rn` and `_log1p_rn`."""
    return torch.clamp(x, min=0.0) + _log1p_rn(_exp_rn(-torch.abs(x)))


class _Logistic(torch.autograd.Function):
    """`_sig_rn` with the backward ``g s (1 - s)`` from the forward's s
    (the VJP of `jax.nn.sigmoid`): autograd through ``1 / (1 + exp(-x))``
    would multiply 0 by an infinite ``exp(-x)`` where x is very negative."""

    @staticmethod
    def forward(ctx, x):
        s = _sig_rn(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * s * (1.0 - s)


class _Softplus(torch.autograd.Function):
    """`_softplus_rn` with the backward ``g sigmoid(x)`` everywhere, x = 0
    included (autograd through max and abs would give 1 there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _softplus_rn(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _sig_rn(x)


def _sum64(x: torch.Tensor) -> torch.Tensor:
    """Sum of all elements, accumulated in float64 (0-dim, float64)."""
    return x.double().sum()


def _bisect_level(keys: torch.Tensor, widths: torch.Tensor, demand, lam0,
                  inv_tau, *, n_bisect: int = 30) -> torch.Tensor:
    """The non-differentiable half of `soft_water_level`: fixed-count
    bisection of ``sum_j widths_j sigmoid((lam - keys_j) / tau) = demand``
    from the bracket ``lam0 +- 40 tau``, without gradient. Each step
    compares the float64 sum with the demand."""
    with torch.no_grad():
        span = _WL_SIGMA_SPAN / inv_tau
        lo, hi = lam0 - span, lam0 + span
        d64 = torch.as_tensor(demand).double()
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            below = _sum64(widths * _sig_rn((mid - keys) * inv_tau)) < d64
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        return 0.5 * (lo + hi)


def _bisect_level_tree(keys: torch.Tensor, widths: torch.Tensor, demand,
                       lam0, inv_tau, *, n_bisect: int = 30,
                       levels: int = 4) -> torch.Tensor:
    """`_bisect_level` as the forward kernel takes it, ``levels`` levels of
    the bisection tree a round (used by the tests): from the round's
    bracket, each of the 2^levels - 1 nodes of the round's tree forms its
    midpoint by replaying its path from the bracket with the same
    ``0.5 * (lo + hi)``, its comparison is taken, and then the decisions
    are walked down the tree to the next bracket. The last round takes the
    levels that remain. Every midpoint is the one the sequential bisection
    forms on that branch, so the result equals `_bisect_level`'s bit for
    bit."""
    with torch.no_grad():
        span = _WL_SIGMA_SPAN / inv_tau
        lo, hi = lam0 - span, lam0 + span
        d64 = torch.as_tensor(demand).double()
        b = 0
        while b < n_bisect:
            nl = min(levels, n_bisect - b)
            below = {}
            for node in range(1, 2 ** nl):
                lo_n, hi_n = lo, hi
                for d in range(node.bit_length() - 2, -1, -1):
                    mid = 0.5 * (lo_n + hi_n)
                    if (node >> d) & 1:
                        lo_n = mid
                    else:
                        hi_n = mid
                mid = 0.5 * (lo_n + hi_n)
                below[node] = bool(
                    _sum64(widths * _sig_rn((mid - keys) * inv_tau)) < d64)
            node = 1
            for _ in range(nl):
                mid = 0.5 * (lo + hi)
                if below[node]:
                    lo, node = mid, 2 * node + 1
                else:
                    hi, node = mid, 2 * node
            b += nl
        return 0.5 * (lo + hi)


def soft_water_level_fixed(keys: torch.Tensor, widths: torch.Tensor, demand,
                           lam_hat, inv_tau) -> torch.Tensor:
    """The differentiable half of `soft_water_level`: one Newton correction
    from an already solved ``lam_hat`` (no gradient), clipped to the
    bracket radius 40 tau. The Newton denominator carries no gradient
    either; the residual ``demand - sum_j w_j sigma_j`` does."""
    lam_hat = lam_hat.detach()
    span = _WL_SIGMA_SPAN / inv_tau
    sig = _Logistic.apply((lam_hat - keys) * inv_tau)
    ws = widths * sig
    denom = torch.clamp(_sum64(ws * (1.0 - sig)).to(ws.dtype) * inv_tau,
                        min=_WL_TINY).detach()
    step = (demand - _sum64(ws).to(ws.dtype)) / denom
    return lam_hat + torch.minimum(torch.maximum(step, -span), span)


def soft_water_level(keys: torch.Tensor, widths: torch.Tensor, demand, lam0,
                     inv_tau, *, n_bisect: int = 30) -> torch.Tensor:
    """Level of the entropic water-fill: the root of
    ``sum_j widths_j sigmoid((lam - keys_j) / tau) = demand``, found by
    bisection from the hard level ``lam0`` (without gradient), then one
    differentiable Newton step (`soft_water_level_fixed`)."""
    lam_hat = _bisect_level(keys, widths, demand, lam0, inv_tau,
                            n_bisect=n_bisect)
    return soft_water_level_fixed(keys, widths, demand, lam_hat, inv_tau)


def _hour_widths(prev: torch.Tensor, dwell: torch.Tensor, avail: torch.Tensor,
                 *, inv_tau, min_dwell: int) -> torch.Tensor:
    """[3S] locked / retain / fresh segment widths of one hour."""
    held = torch.minimum(prev, avail)
    if min_dwell > 0:
        inv_tau_cnt = inv_tau / _DWELL_CNT_SCALE
        locked = _Logistic.apply((dwell - 0.5) * inv_tau_cnt) * held
    else:
        locked = torch.zeros_like(held)
    return torch.cat([locked, held - locked, avail - held])


def soft_dispatch_hour_fixed(prev: torch.Tensor, dwell: torch.Tensor,
                             avail: torch.Tensor, keys: torch.Tensor, demand,
                             lam_hat, inv_tau, inv_tau_mw, *, min_dwell: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One soft-dispatch hour given an already bisected level ``lam_hat``:
    every operation that carries gradient (widths, Newton correction, fill,
    renormalisation to the demand, dwell dynamics). Returns
    ``(alloc [S], dwell' [S])``."""
    s = prev.shape[0]
    widths = _hour_widths(prev, dwell, avail, inv_tau=inv_tau,
                          min_dwell=min_dwell)
    lam = soft_water_level_fixed(keys, widths, demand, lam_hat, inv_tau)
    fill = widths * _Logistic.apply((lam - keys) * inv_tau)
    d64 = torch.as_tensor(demand).double()
    scale = d64 / torch.maximum(_sum64(fill), 1e-9 * d64 + _WL_TINY)
    fill = fill * scale.to(fill.dtype)
    alloc = (fill[:s] + fill[s:2 * s]) + fill[2 * s:]
    if min_dwell > 0:
        inv_tau_cnt = inv_tau / _DWELL_CNT_SCALE
        moved_in = _Logistic.apply((alloc - prev - DWELL_EVENT_MW)
                                   * inv_tau_mw)
        count_down = _Softplus.apply((dwell - 1.0) * inv_tau_cnt) \
            / inv_tau_cnt
        dwell = moved_in * min_dwell + (1.0 - moved_in) * count_down
    return alloc, dwell


def soft_dispatch_hour_parts(prev: torch.Tensor, dwell: torch.Tensor,
                             avail: torch.Tensor, keys: torch.Tensor,
                             order: torch.Tensor, demand, *, inv_tau,
                             inv_tau_mw, min_dwell: int, n_bisect: int = 30):
    """One hour of the temperature-tau softmin water-fill, the relaxation
    of `dispatch_alloc_hour`: returns ``(alloc [S], dwell' [S], lam_hat)``.

    The bracket is seeded at the hard level: the key of the first segment,
    in ``order`` (the ascending sort of ``keys``), at which the inclusive
    prefix of the sorted widths reaches the demand (the count of prefixes
    below it, clamped to 3S - 1), the prefix summed sequentially in float64
    (PyTorch's CPU `cumsum` of float64, and the kernels' walk). Widths are
    non-negative for avail >= 0, so the prefix only grows.
    prev/dwell/avail: [S]; keys: [3S]; order: [3S] (int)."""
    n3 = keys.shape[0]
    widths = _hour_widths(prev, dwell, avail, inv_tau=inv_tau,
                          min_dwell=min_dwell)
    order = order.long()
    with torch.no_grad():
        cums = torch.cumsum(widths[order].double(), 0)
        below = torch.sum(cums < torch.as_tensor(demand).double())
        lam0 = keys[order][torch.clamp(below, max=n3 - 1)].detach()
    lam_hat = _bisect_level(keys.detach(), widths.detach(), demand, lam0,
                            inv_tau, n_bisect=n_bisect)
    alloc, dwell = soft_dispatch_hour_fixed(
        prev, dwell, avail, keys, demand, lam_hat, inv_tau, inv_tau_mw,
        min_dwell=min_dwell)
    return alloc, dwell, lam_hat


def soft_dispatch_hour(prev, dwell, avail, keys, order, demand, *, inv_tau,
                       inv_tau_mw, min_dwell: int, n_bisect: int = 30):
    """`soft_dispatch_hour_parts` without the level: ``(alloc, dwell')``."""
    alloc, dwell, _ = soft_dispatch_hour_parts(
        prev, dwell, avail, keys, order, demand, inv_tau=inv_tau,
        inv_tau_mw=inv_tau_mw, min_dwell=min_dwell, n_bisect=n_bisect)
    return alloc, dwell


@torch.no_grad()
def soft_level_in_gap(prev: torch.Tensor, dwell: torch.Tensor,
                      avail: torch.Tensor, keys: torch.Tensor, demand, lam_a,
                      lam_b, inv_tau, *, min_dwell: int) -> bool:
    """Whether two bisected levels of one hour may differ by more than the
    bisection resolves: the hour's fill ``F(lam) = sum_j w_j sigmoid((lam -
    key_j) / tau)`` (float32 terms, float64 sum, as the bisection takes it)
    equals the demand to within rounding (1e-12 of the total width) at
    both ends of the middle half of the interval between them. F is
    monotone, so it is then flat at the demand there: a gap of the fill,
    where bisections whose sums differ only in their order may settle
    anywhere. Elsewhere a level is determined to the resolution."""
    widths = _hour_widths(prev, dwell, avail, inv_tau=inv_tau,
                          min_dwell=min_dwell)
    lo, hi = sorted((float(lam_a), float(lam_b)))
    q = 0.25 * (hi - lo)
    tol = 1e-12 * float(_sum64(widths)) + _WL_TINY
    for x in (lo + q, hi - q):
        lam = torch.tensor(x, dtype=keys.dtype)
        fill = float(_sum64(widths * _sig_rn((lam - keys) * inv_tau)))
        if abs(fill - float(demand)) > tol:
            return False
    return True


def _tie(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Share of the cotangent of ``minimum(a, b)`` that goes to ``a``: 1
    where a < b, 0 where a > b, 1/2 at a tie (as JAX and PyTorch split
    it)."""
    return torch.where(a < b, 1.0, torch.where(a > b, 0.0, 0.5)).to(a.dtype)


@torch.no_grad()
def soft_dispatch_hour_grad(prev: torch.Tensor, dwell: torch.Tensor,
                            avail: torch.Tensor, keys: torch.Tensor, demand,
                            lam_hat, inv_tau, inv_tau_mw,
                            u_alloc: torch.Tensor, u_dwell: torch.Tensor, *,
                            min_dwell: int):
    """Adjoint of one fixed-level hour, written out by hand: the exact
    transpose of `soft_dispatch_hour_fixed` under the output cotangents
    ``(u_alloc, u_dwell)``. The backward kernel computes the same, in the
    same order of operations. Returns ``(d_prev, d_dwell, d_avail,
    d_keys, d_demand, d_inv_tau, d_inv_tau_mw)``; the last two are float64
    0-dim tensors. Ties of ``minimum``, ``maximum`` and the clip split the
    cotangent in halves; every sigmoid's adjoint is ``s (1 - s)`` from its
    forward value."""
    dt = prev.dtype
    s = prev.shape[0]
    d64 = torch.as_tensor(demand).double()
    # ---- the forward, recomputed
    held = torch.minimum(prev, avail)
    if min_dwell > 0:
        itc = inv_tau / _DWELL_CNT_SCALE
        gate = _sig_rn((dwell - 0.5) * itc)
        locked = gate * held
    else:
        locked = torch.zeros_like(held)
    w = torch.cat([locked, held - locked, avail - held])
    span = _WL_SIGMA_SPAN / inv_tau
    s0 = _sig_rn((lam_hat - keys) * inv_tau)
    ws0 = w * s0
    denom = torch.clamp(_sum64(ws0 * (1.0 - s0)).to(dt) * inv_tau,
                        min=_WL_TINY)
    step = (demand - _sum64(ws0).to(dt)) / denom
    c1 = torch.maximum(step, -span)
    lam = lam_hat + torch.minimum(c1, span)
    sg = _sig_rn((lam - keys) * inv_tau)
    fill0 = w * sg
    f_sum = _sum64(fill0)
    floor = 1e-9 * d64 + _WL_TINY
    den = torch.maximum(f_sum, floor)
    r64 = d64 / den
    r = r64.to(dt)
    fill = fill0 * r
    alloc = (fill[:s] + fill[s:2 * s]) + fill[2 * s:]
    # ---- the reverse
    ua = u_alloc.to(dt)
    d_prev = torch.zeros_like(prev)
    d_dwell = u_dwell.to(dt)             # without locks dwell' = dwell
    d_itc = torch.zeros((), dtype=torch.float64, device=prev.device)
    d_itm = torch.zeros((), dtype=torch.float64, device=prev.device)
    if min_dwell > 0:
        xm = (alloc - prev) - DWELL_EVENT_MW
        mi = _sig_rn(xm * inv_tau_mw)
        zc = (dwell - 1.0) * itc
        cd = _softplus_rn(zc) / itc
        ud = u_dwell.to(dt)
        d_mi = ud * (min_dwell - cd)
        d_cd = ud * (1.0 - mi)
        d_zm = d_mi * mi * (1.0 - mi)
        ua = ua + d_zm * inv_tau_mw
        d_prev = -(d_zm * inv_tau_mw)
        d_itm = _sum64(d_zm * xm)
        d_zc = (d_cd / itc) * _sig_rn(zc)
        d_dwell = d_zc * itc
        d_itc = _sum64(-(d_cd * cd) / itc + d_zc * (dwell - 1.0))
    ua3 = torch.cat([ua, ua, ua])
    # the renormalisation, in float64
    dr = _sum64(ua3.double() * fill0.double())
    dd = dr / den
    d_den = -dr * r64 / den
    share = _tie(floor, f_sum).double()      # 1: the floor is below F
    dd = dd + 1e-9 * d_den * (1.0 - share)
    dfill0 = ua3 * r + (d_den * share).to(dt)
    d_w = dfill0 * sg
    d_z = dfill0 * w * sg * (1.0 - sg)
    d_lam = _sum64(d_z).to(dt) * inv_tau
    d_keys = -(d_z * inv_tau)
    d_it = _sum64(d_z * (lam - keys))
    # the clip: minimum(maximum(step, -span), span)
    to_c1 = _tie(c1, span)
    dc1 = d_lam * to_c1
    d_span = d_lam * (1.0 - to_c1)
    to_step = 1.0 - _tie(step, -span)
    d_step = dc1 * to_step
    d_span = d_span - dc1 * (1.0 - to_step)
    d_it = d_it + (d_span * (-span / inv_tau)).double()
    # the Newton step
    q = d_step / denom
    dd = dd + q.double()
    d_w = d_w + (-q) * s0
    d_z0 = (-q) * w * s0 * (1.0 - s0)
    d_keys = d_keys - d_z0 * inv_tau
    d_it = d_it + _sum64(d_z0 * (lam_hat - keys))
    # the widths
    dw0, dw1, dw2 = d_w[:s], d_w[s:2 * s], d_w[2 * s:]
    d_avail = dw2
    if min_dwell > 0:
        d_locked = dw0 - dw1
        d_held = (dw1 - dw2) + d_locked * gate
        d_zg = d_locked * held * gate * (1.0 - gate)
        d_dwell = d_dwell + d_zg * itc
        d_itc = d_itc + _sum64(d_zg * (dwell - 0.5))
    else:
        d_held = dw1 - dw2
    to_prev = _tie(prev, avail)
    d_prev = d_prev + d_held * to_prev
    d_avail = d_avail + d_held * (1.0 - to_prev)
    d_it = d_it + d_itc / _DWELL_CNT_SCALE
    return (d_prev, d_dwell, d_avail, d_keys, dd.to(dt), d_it, d_itm)


def _soft_dispatch_dtype(avail: torch.Tensor) -> torch.dtype:
    return torch.float64 if avail.dtype == torch.float64 else torch.float32


def _soft_dispatch_run(a: torch.Tensor, keys: torch.Tensor,
                       order: torch.Tensor, demand: torch.Tensor, it, itm, *,
                       min_dwell: int, n_bisect: int):
    """The hour loop of `soft_dispatch_ref` and `soft_dispatch_fwd_ref`:
    one Python step per hour over ``a`` [S, T], in its dtype and on its
    device. Returns ``(alloc [S, T], dwell_in [S, T], lam_hat [T])``, where
    ``dwell_in`` is each hour's entering dwell state and ``lam_hat`` its
    bisected level; the allocation carries autograd's graph when run with
    grad."""
    s, t = a.shape
    prev = torch.zeros(s, dtype=a.dtype, device=a.device)
    dwell = torch.zeros_like(prev)
    allocs, dwins, lams = [], [], []
    for h in range(t):
        dwins.append(dwell)
        prev, dwell, lam = soft_dispatch_hour_parts(
            prev, dwell, a[:, h], keys[h], order[h], demand[h], inv_tau=it,
            inv_tau_mw=itm, min_dwell=min_dwell, n_bisect=n_bisect)
        allocs.append(prev)
        lams.append(lam)
    return (torch.stack(allocs, dim=1), torch.stack(dwins, dim=1),
            torch.stack(lams))


@torch.no_grad()
def soft_dispatch_fwd_ref(avail: torch.Tensor, keys: torch.Tensor,
                          order: torch.Tensor, demand: torch.Tensor, inv_tau,
                          inv_tau_mw, *, min_dwell: int = 0,
                          n_bisect: int = 30):
    """Plain version of the residual-emitting forward kernel: ``(alloc
    [S, T], dwell_in [S, T], lam_hat [T])`` (see `_soft_dispatch_run`), in
    the inputs' dtype (float64 stays float64, anything else float32), on
    the inputs' device."""
    dt = _soft_dispatch_dtype(avail)
    it = torch.as_tensor(inv_tau, device=avail.device).to(dt).reshape(())
    itm = torch.as_tensor(inv_tau_mw, device=avail.device).to(dt).reshape(())
    return _soft_dispatch_run(avail.to(dt), keys.to(dt), order,
                              demand.to(dt), it, itm, min_dwell=min_dwell,
                              n_bisect=n_bisect)


@torch.no_grad()
def soft_dispatch_bwd_ref(avail: torch.Tensor, keys: torch.Tensor,
                          demand: torch.Tensor, inv_tau, inv_tau_mw,
                          alloc: torch.Tensor, dwin: torch.Tensor,
                          lam: torch.Tensor, g: torch.Tensor, *,
                          min_dwell: int = 0, want_dkeys: bool = True):
    """Plain version of the backward kernel: walks the hours in reverse
    from the forward's residuals (``alloc``, ``dwin``, ``lam``; the entering
    allocation is ``alloc`` shifted by one hour), carrying the adjoints of
    the (prev alloc, dwell) state and the two tau sums, and applies
    `soft_dispatch_hour_grad` with ``u_alloc = g_t + d prev_{t+1}``.
    Returns ``(d_avail [S, T], d_keys [T, 3S] or None, d_demand [T],
    sum d_inv_tau, sum d_inv_tau_mw)``, the sums in float64."""
    dt = _soft_dispatch_dtype(avail)
    a, al, dw, gg = (x.to(dt).T for x in (avail, alloc, dwin, g))
    keys, demand, lam = keys.to(dt), demand.to(dt), lam.to(dt)
    it = torch.as_tensor(inv_tau, device=a.device).to(dt).reshape(())
    itm = torch.as_tensor(inv_tau_mw, device=a.device).to(dt).reshape(())
    t, s = a.shape
    u_prev = torch.zeros(s, dtype=dt, device=a.device)
    u_dwell = torch.zeros_like(u_prev)
    acc_it = torch.zeros((), dtype=torch.float64, device=a.device)
    acc_itm = torch.zeros_like(acc_it)
    d_av = torch.empty((t, s), dtype=dt, device=a.device)
    d_ke = torch.empty((t, 3 * s), dtype=dt, device=a.device)
    d_de = torch.empty(t, dtype=dt, device=a.device)
    for h in range(t - 1, -1, -1):
        prev = al[h - 1] if h > 0 else torch.zeros_like(u_prev)
        u_prev, u_dwell, d_av[h], d_ke[h], d_de[h], d_it, d_itm = \
            soft_dispatch_hour_grad(prev, dw[h], a[h], keys[h], demand[h],
                                    lam[h], it, itm, gg[h] + u_prev, u_dwell,
                                    min_dwell=min_dwell)
        acc_it = acc_it + d_it
        acc_itm = acc_itm + d_itm
    return (d_av.T.contiguous(), d_ke if want_dkeys else None, d_de,
            acc_it, acc_itm)


@torch.no_grad()
def soft_dispatch_bwd_two_pass_ref(avail: torch.Tensor, keys: torch.Tensor,
                                   demand: torch.Tensor, inv_tau, inv_tau_mw,
                                   alloc: torch.Tensor, dwin: torch.Tensor,
                                   lam: torch.Tensor, g: torch.Tensor, *,
                                   min_dwell: int = 0,
                                   want_dkeys: bool = True):
    """`soft_dispatch_bwd_ref` in the backward kernels' two passes (used by
    the tests): first, for all hours at once, everything an hour's adjoint
    needs that depends on the forward's residuals alone -- the widths, the
    lock gate, the Newton step and the fill, the floor's and the clip's
    tie shares, the dwell factors; then the reversed chain over hours, with
    only what depends on the adjoint of (prev alloc, dwell): the two sums
    and the linear arithmetic around them. Every element-wise operation is
    `soft_dispatch_hour_grad`'s; the sums of the first pass run over all
    hours at once. Same returns as `soft_dispatch_bwd_ref`."""
    dt = _soft_dispatch_dtype(avail)
    a, al, dw, gg = (x.to(dt).T for x in (avail, alloc, dwin, g))   # [T, S]
    keys, demand, lam = keys.to(dt), demand.to(dt), lam.to(dt)
    it = torch.as_tensor(inv_tau, device=a.device).to(dt).reshape(())
    itm = torch.as_tensor(inv_tau_mw, device=a.device).to(dt).reshape(())
    t, s = a.shape
    itc = it / _DWELL_CNT_SCALE
    span = _WL_SIGMA_SPAN / it
    # ---- pass 1: the coefficients of every hour
    prev = torch.cat([torch.zeros_like(a[:1]), al[:-1]])
    held = torch.minimum(prev, a)
    if min_dwell > 0:
        gate = _sig_rn((dw - 0.5) * itc)
        locked = gate * held
    else:
        gate = locked = torch.zeros_like(held)
    w = torch.cat([locked, held - locked, a - held], dim=1)       # [T, 3S]
    lam_hat = lam[:, None]
    s0 = _sig_rn((lam_hat - keys) * it)
    ws0 = w * s0
    denom = torch.clamp((ws0 * (1.0 - s0)).double().sum(1).to(dt) * it,
                        min=_WL_TINY)                              # [T]
    step = (demand - ws0.double().sum(1).to(dt)) / denom
    c1 = torch.maximum(step, -span)
    lam_n = lam + torch.minimum(c1, span)
    sg = _sig_rn((lam_n[:, None] - keys) * it)
    fill0 = w * sg
    f_sum = fill0.double().sum(1)
    d64 = demand.double()
    floor = 1e-9 * d64 + _WL_TINY
    den = torch.maximum(f_sum, floor)
    r64 = d64 / den
    r = r64.to(dt)
    share = _tie(floor, f_sum).double()
    to_c1, to_step = _tie(c1, span), 1.0 - _tie(step, -span)
    to_prev = _tie(prev, a)
    lk, l0k = lam_n[:, None] - keys, lam_hat - keys
    if min_dwell > 0:
        fill = fill0 * r[:, None]
        alloc_h = (fill[:, :s] + fill[:, s:2 * s]) + fill[:, 2 * s:]
        xm = (alloc_h - prev) - DWELL_EVENT_MW
        mi = _sig_rn(xm * itm)
        zc = (dw - 1.0) * itc
        cd = _softplus_rn(zc) / itc
        sz = _sig_rn(zc)
    # ---- pass 2: the reversed chain
    u_prev = torch.zeros(s, dtype=dt, device=a.device)
    u_dwell = torch.zeros_like(u_prev)
    acc_it = torch.zeros((), dtype=torch.float64, device=a.device)
    acc_itm = torch.zeros_like(acc_it)
    d_av = torch.empty((t, s), dtype=dt, device=a.device)
    d_ke = torch.empty((t, 3 * s), dtype=dt, device=a.device)
    d_de = torch.empty(t, dtype=dt, device=a.device)
    for h in range(t - 1, -1, -1):
        ua = gg[h] + u_prev
        d_prev = torch.zeros_like(u_prev)
        d_dwell = u_dwell
        d_itc = torch.zeros((), dtype=torch.float64, device=a.device)
        if min_dwell > 0:
            d_mi = u_dwell * (min_dwell - cd[h])
            d_cd = u_dwell * (1.0 - mi[h])
            d_zm = d_mi * mi[h] * (1.0 - mi[h])
            ua = ua + d_zm * itm
            d_prev = -(d_zm * itm)
            acc_itm = acc_itm + _sum64(d_zm * xm[h])
            d_zc = (d_cd / itc) * sz[h]
            d_dwell = d_zc * itc
            d_itc = _sum64(-(d_cd * cd[h]) / itc + d_zc * (dw[h] - 1.0))
        ua3 = torch.cat([ua, ua, ua])
        dr = _sum64(ua3.double() * fill0[h].double())
        dd = dr / den[h]
        d_den = -dr * r64[h] / den[h]
        dd = dd + 1e-9 * d_den * (1.0 - share[h])
        dfill0 = ua3 * r[h] + (d_den * share[h]).to(dt)
        d_w = dfill0 * sg[h]
        d_z = dfill0 * w[h] * sg[h] * (1.0 - sg[h])
        d_lam = _sum64(d_z).to(dt) * it
        d_keys = -(d_z * it)
        d_it = _sum64(d_z * lk[h])
        dc1 = d_lam * to_c1[h]
        d_span = d_lam * (1.0 - to_c1[h])
        d_step = dc1 * to_step[h]
        d_span = d_span - dc1 * (1.0 - to_step[h])
        d_it = d_it + (d_span * (-span / it)).double()
        q = d_step / denom[h]
        dd = dd + q.double()
        d_w = d_w + (-q) * s0[h]
        d_z0 = (-q) * w[h] * s0[h] * (1.0 - s0[h])
        d_keys = d_keys - d_z0 * it
        d_it = d_it + _sum64(d_z0 * l0k[h])
        dw0, dw1, dw2 = d_w[:s], d_w[s:2 * s], d_w[2 * s:]
        d_avail = dw2
        if min_dwell > 0:
            d_locked = dw0 - dw1
            d_held = (dw1 - dw2) + d_locked * gate[h]
            d_zg = d_locked * held[h] * gate[h] * (1.0 - gate[h])
            d_dwell = d_dwell + d_zg * itc
            d_itc = d_itc + _sum64(d_zg * (dw[h] - 0.5))
        else:
            d_held = dw1 - dw2
        u_prev = d_prev + d_held * to_prev[h]
        d_av[h] = d_avail + d_held * (1.0 - to_prev[h])
        d_ke[h] = d_keys
        d_de[h] = dd.to(dt)
        u_dwell = d_dwell
        acc_it = acc_it + (d_it + d_itc / _DWELL_CNT_SCALE)
    return (d_av.T.contiguous(), d_ke if want_dkeys else None, d_de,
            acc_it, acc_itm)


def _soft_dispatch_args(avail, keys, demand, tau, mw_scale):
    dt = _soft_dispatch_dtype(avail)
    inv_tau = 1.0 / torch.as_tensor(tau, device=avail.device).to(dt)
    return (avail.to(dt), keys.to(dt), demand.to(dt), inv_tau,
            inv_tau / torch.tensor(mw_scale, dtype=dt))


def soft_dispatch_ref(avail: torch.Tensor, keys: torch.Tensor,
                      order: torch.Tensor, demand: torch.Tensor, *, tau,
                      min_dwell: int = 0, mw_scale: float = 0.05,
                      n_bisect: int = 30) -> torch.Tensor:
    """Sequential oracle of the soft (differentiable) dispatch scan, and
    the plain version of the forward kernel.

    avail: [S, T] available MW; keys/order: [T, 3S] segment keys
    (`repro_torch.dispatch.segment_keys`) and their ascending sort; demand:
    [T] MW. Returns the relaxed allocation [S, T], differentiable by
    autograd in ``avail``, ``keys``, ``demand`` and ``tau`` (the native
    baseline of the fused VJP), converging to `dispatch_ref`'s hard
    allocation as tau -> 0. ``mw_scale`` sets the MW temperature of the
    dwell reset gate as ``tau * mw_scale``. Float64 avail computes in
    float64, anything else in float32, on the inputs' device."""
    a, keys, demand, it, itm = _soft_dispatch_args(avail, keys, demand, tau,
                                                   mw_scale)
    return _soft_dispatch_run(a, keys, order, demand, it, itm,
                              min_dwell=min_dwell, n_bisect=n_bisect)[0]


def soft_dispatch_grad_ref(avail: torch.Tensor, keys: torch.Tensor,
                           order: torch.Tensor, demand: torch.Tensor,
                           g: torch.Tensor, *, tau, min_dwell: int = 0,
                           mw_scale: float = 0.05, n_bisect: int = 30):
    """Sequential oracle of the fused backward: the output cotangent ``g``
    [S, T] pulled back through the hour recurrence by
    `soft_dispatch_fwd_ref` then `soft_dispatch_bwd_ref`. Returns
    ``(d_avail [S, T], d_keys [T, 3S], d_demand [T], d_tau [])``, with
    d_tau = -itau^2 sum d_itau - itau itau_mw sum d_itau_mw."""
    a, keys, demand, it, itm = _soft_dispatch_args(avail, keys, demand, tau,
                                                   mw_scale)
    alloc, dwin, lam = soft_dispatch_fwd_ref(
        a, keys, order, demand, it, itm, min_dwell=min_dwell,
        n_bisect=n_bisect)
    d_av, d_ke, d_de, acc_it, acc_itm = soft_dispatch_bwd_ref(
        a, keys, demand, it, itm, alloc, dwin, lam, g, min_dwell=min_dwell)
    d_tau = (-(it.double() ** 2) * acc_it
             - it.double() * itm.double() * acc_itm).to(a.dtype)
    return d_av, d_ke, d_de, d_tau


# ---------------------------------------------------------------------------
# attention: the reference's oracles and the two kernels' plain versions
# ---------------------------------------------------------------------------

NEG_INF = -2.0 ** 30   # masked score: finite, so a fully masked online-
                       # softmax row never forms (-inf) - (-inf)
ATTN_TILE = 64         # query rows and keys per tile of both kernels
DECODE_SPLIT = 256     # cache slots per block of the decode kernel


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """Dense float32 softmax attention (`repro.kernels.ref.attention_ref`).
    q: [B,Sq,H,Dh]; k,v: [B,Skv,G,Dh]; GQA by head repetition."""
    b, sq, h, dh = q.shape
    skv, g = k.shape[1], k.shape[2]
    rep = h // g
    kh = k.repeat_interleave(rep, dim=2).float()
    vh = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * dh ** -0.5
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Dense float32 softmax over a cache
    (`repro.kernels.ref.decode_attention_ref`). q: [B,1,H,Dh];
    k,v: [B,W,G,Dh]; valid: [B,W] bool."""
    h, dh = q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    kh = k.repeat_interleave(rep, dim=2).float()
    vh = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * dh ** -0.5
    s = torch.where(valid.bool()[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.to(q.dtype)


def _online_step(m, l_, acc, s, v_tile, v_dtype):
    """One tile of the online softmax, with the kernels' casts: scores
    and the carry in float32, p rounded to V's type for p.v, the product
    accumulated in float32. s: [..., n, kc]; v_tile: [..., kc, Dh]."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l_ * alpha + p.sum(dim=-1)
    pv = torch.matmul(p.to(v_dtype).float(), v_tile.float())
    return m_new, l_new, acc * alpha[..., None] + pv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain version of the flash kernel (`csrc/attention.cu`):
    the same 64 x 64 tiles in the same order, the same skip of KV tiles
    that the masks empty for a whole query tile, the same casts and the
    same finite NEG_INF. q: [B,Sq,H,Dh]; k,v: [B,Skv,G,Dh]; returns
    [B,Sq,H,Dh] in q's dtype. Head h reads KV group h // (H // G)."""
    b, sq, h, dh = q.shape
    skv, g = k.shape[1], k.shape[2]
    r = h // g
    dev, t = q.device, ATTN_TILE
    qf = q.float().reshape(b, sq, g, r, dh).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)                   # [B,G,Skv,Dh]
    vt = v.permute(0, 2, 1, 3)[:, :, None]               # [B,G,1,Skv,Dh]
    qpos = q_offset + torch.arange(sq, device=dev)
    q_start = q_offset + (torch.arange(sq, device=dev) // t) * t
    m = torch.full((b, g, r, sq), NEG_INF, device=dev)
    l_ = torch.zeros((b, g, r, sq), device=dev)
    acc = torch.zeros((b, g, r, sq, dh), device=dev)
    def tile_relevant(k0, qs):
        """Whether KV tile ``k0`` has a key the query tile starting at
        position ``qs`` may see (the kernel's skip test)."""
        return ((not causal or k0 <= min(qs + t - 1, skv - 1))
                and (not window or k0 + t - 1 > qs - window))

    for k0 in range(0, skv, t):
        k1 = min(k0 + t, skv)
        # decided from Python integers, so the loop never waits on the card
        if not any(tile_relevant(k0, qs)
                   for qs in range(q_offset, q_offset + sq, t)):
            continue
        # relevance of this tile to each row's query tile (uniform per tile)
        relevant = torch.ones(sq, dtype=torch.bool, device=dev)
        if causal:
            relevant &= k0 <= torch.clamp(q_start + t - 1, max=skv - 1)
        if window:
            relevant &= (k0 + t - 1) > q_start - window
        kpos = torch.arange(k0, k1, device=dev)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf[:, :, k0:k1]) \
            * dh ** -0.5
        mask = torch.ones((sq, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        m_new, l_new, acc_new = _online_step(m, l_, acc, s,
                                             vt[..., k0:k1, :], v.dtype)
        m = torch.where(relevant, m_new, m)
        l_ = torch.where(relevant, l_new, l_)
        acc = torch.where(relevant[:, None], acc_new, acc)
    out = acc / torch.clamp(l_, min=1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor
                           ) -> torch.Tensor:
    """The plain version of the decode kernel (`csrc/attention.cu`): the
    cache cut into splits of ``DECODE_SPLIT`` slots, each split an online
    softmax over tiles of 64 slots in order that skips a tile with no
    valid slot (it would change no row that has one), the R = H // G heads
    of a group against their group's slots, invalid slots scored NEG_INF,
    the kernel's casts; then the splits folded in order (M = max m_j,
    w_j = exp(m_j - M), out = sum w_j acc_j / max(sum w_j l_j, 1e-37)).
    q: [B,1,H,Dh]; k,v: [B,W,G,Dh]; valid: [B,W] (int8 or bool, nonzero
    = valid); returns [B,1,H,Dh] in q's dtype."""
    b, _, h, dh = q.shape
    w, g = k.shape[1], k.shape[2]
    r = h // g
    dev, t, sp = q.device, ATTN_TILE, DECODE_SPLIT
    n = -(-w // sp)
    pad = n * sp - w
    ok = torch.nn.functional.pad(valid != 0, (0, pad))
    ks = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)) \
        .reshape(b, n, sp, g, dh)
    vs = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) \
        .reshape(b, n, sp, g, dh)
    ok = ok.reshape(b, n, sp)
    qg = q.float().reshape(b, 1, g, r, dh)
    m = torch.full((b, n, g, r), NEG_INF, device=dev)
    l_ = torch.zeros((b, n, g, r), device=dev)
    acc = torch.zeros((b, n, g, r, dh), device=dev)
    for k0 in range(0, min(sp, w), t):      # the splits walk in step
        tile_ok = ok[:, :, k0:k0 + t]
        live = tile_ok.any(dim=-1)[:, :, None, None]     # [B, n, 1, 1]
        s = torch.einsum("bngrd,bnkgd->bngrk", qg,
                         ks[:, :, k0:k0 + t].float()) * dh ** -0.5
        s = torch.where(tile_ok[:, :, None, None], s, NEG_INF)
        m_new, l_new, acc_new = _online_step(
            m, l_, acc, s, vs[:, :, k0:k0 + t].permute(0, 1, 3, 2, 4),
            v.dtype)
        m = torch.where(live, m_new, m)
        l_ = torch.where(live, l_new, l_)
        acc = torch.where(live[..., None], acc_new, acc)
    if n == 1:
        out = acc[:, 0] / torch.clamp(l_[:, 0], min=1e-37)[..., None]
    else:
        big_m = m.amax(dim=1)
        tot_l = torch.zeros_like(big_m)
        tot = torch.zeros_like(acc[:, 0])
        for j in range(n):
            wj = torch.exp(m[:, j] - big_m)
            tot_l = tot_l + l_[:, j] * wj
            tot = tot + acc[:, j] * wj[..., None]
        out = tot / torch.clamp(tot_l, min=1e-37)[..., None]
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# the Mamba2 SSD chunk scan: the reference's oracle and the kernel's plain
# version
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, h0=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential (unchunked) SSD recurrence in float32
    (`repro.kernels.ref.ssd_ref`), the ground-truth oracle.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus); a: [H] (negative);
    b, c: [B,S,G,N]; h0: [B,H,P,N] or None. Returns y [B,S,H,P] and
    h_last [B,H,P,N], float32:

        h_t = h_{t-1} exp(dt_t a) + dt_t x_t b_t^T ;  y_t = h_t c_t
    """
    bsz, s, nh, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = nh // g
    bh = b.repeat_interleave(rep, dim=2).float()
    ch = c.repeat_interleave(rep, dim=2).float()
    xf, dtf, af = x.float(), dt.float(), a.float()
    h = (torch.zeros((bsz, nh, p, n), device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])                 # [B,H]
        upd = torch.einsum("bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t],
                           bh[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    return torch.stack(ys, dim=1), h


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dimension 1 (the sequence) of ``t`` by ``pad`` at the end."""
    return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int, h0=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the SSD kernel (`csrc/ssd_scan.cu`), in its
    three passes and with its casts (every input to float32 first):

    1. per chunk of ``chunk`` positions: cum = cumsum(dt a), and the state
       the chunk adds, B^T (x dt exp(cum_last - cum)) [P, N];
    2. in chunk order, the state entering each chunk:
       h <- h exp(cum_last) + that chunk's state, from h0 (or zeros);
    3. per chunk: y = ((C B^T) o Lmat) (x dt) + (C h_in) exp(cum), with
       Lmat[i, j] = exp(cum_i - cum_j) taken only where j <= i (above the
       diagonal the exponent is positive and overflows) and 0 elsewhere;
       C B^T once per group, shared by its H // G heads.

    The sequence is zero-padded to a multiple of ``chunk`` (exact: a
    padded dt of 0 decays nothing and adds nothing). The state is carried
    as [B, H, P, N], the model's layout, as the kernel carries it.
    x: [B,S,H,P]; dt: [B,S,H]; a: [H]; b, c: [B,S,G,N]; h0: [B,H,P,N] or
    None. Returns y [B,S,H,P] and h_last [B,H,P,N], float32."""
    bsz, s, nh, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = nh // g
    pad = (-s) % chunk
    if pad:
        x, dt, b, c = (_pad_seq(t, pad) for t in (x, dt, b, c))
    nc, ln = (s + pad) // chunk, chunk
    xf = x.float().reshape(bsz, nc, ln, g, rep, p)
    dtf = dt.float().reshape(bsz, nc, ln, g, rep)
    bf = b.float().reshape(bsz, nc, ln, g, n)
    cf = c.float().reshape(bsz, nc, ln, g, n)
    cum = torch.cumsum(dtf * a.float().reshape(g, rep), dim=2)
    xdt = xf * dtf[..., None]                         # [B,nc,L,G,R,P]
    # 1. the state each chunk adds
    w = xdt * torch.exp(cum[:, :, -1:] - cum)[..., None]
    st = torch.einsum("bcjgn,bcjgrp->bcgrpn", bf, w)  # [B,nc,G,R,P,N]
    # 2. the state entering each chunk, in order
    h = (torch.zeros((bsz, g, rep, p, n), device=x.device) if h0 is None
         else h0.float().reshape(bsz, g, rep, p, n))
    h_in = torch.empty_like(st)
    for ci in range(nc):
        h_in[:, ci] = h
        h = h * torch.exp(cum[:, ci, -1])[..., None, None] + st[:, ci]
    # 3. the outputs
    tril = torch.ones((ln, ln), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None] - cum[:, :, None, :]    # [B,nc,Li,Lj,G,R]
    keep = tril[:, :, None, None]
    lmat = torch.exp(diff.masked_fill(~keep, 0.0)).masked_fill(~keep, 0.0)
    cb = torch.einsum("bcign,bcjgn->bcijg", cf, bf)   # [B,nc,Li,Lj,G]
    scores = cb[..., None] * lmat
    y = torch.einsum("bcijgr,bcjgrp->bcigrp", scores, xdt)
    y_off = torch.einsum("bcign,bcgrpn->bcigrp", cf, h_in)
    y = y + y_off * torch.exp(cum)[..., None]
    return (y.reshape(bsz, nc * ln, nh, p)[:, :s],
            h.reshape(bsz, nh, p, n))


# ---------------------------------------------------------------------------
# The work ledger: plain versions of `csrc/queue_scan.cu` (the reference
# runs the ledger as a `lax.scan`, `repro/kernels/queue_scan.py`)
# ---------------------------------------------------------------------------

QUEUE_MWH_SCALE = 0.05   # MWh smoothing width per price-unit of tau: the
                         # soft ledger's clip temperature co-anneals with
                         # the tuner's sigmoid temperature, so tau -> 0
                         # recovers the hard ledger


def smoothclip(z, w, tau):
    """Soft ``clip(z, 0, w)``: ``tau (softplus(z / tau) - softplus((z - w)
    / tau))``. Exactly 0 at w == 0, strictly in (0, w) for w > 0,
    monotone in z, its derivatives a sigmoid pair, and -> clip(z, 0, w)
    as tau -> 0. The softplus is `jax.nn.softplus`'s value (`_Softplus`),
    taken of both arguments in one stacked pass."""
    z, w = torch.broadcast_tensors(torch.as_tensor(z), torch.as_tensor(w))
    sp = _Softplus.apply(torch.stack([z, z - w]) / tau)
    return tau * (sp[0] - sp[1])


def _ledger_clip(z, w, tau):
    """clip(z, 0, w) (``tau`` None) or its `smoothclip` relaxation."""
    if tau is None:
        return torch.minimum(torch.clamp(z, min=0.0), w)
    return smoothclip(z, w, tau)


def queue_hour_step(q, a_t, cap_t, *, bound, tau=None):
    """One hour of the work ledger (hard, or soft when ``tau`` is set).

    q: [..., D] backlog by age (index 0 youngest = arrived last hour, D-1
    one hour from deadline expiry); a_t/cap_t: [...] arrivals and serving
    capacity in MWh (broadcastable against q's batch shape). Returns
    ``(q_new, served, dropped)``, served/dropped [...].

    The greedy oldest-first fill in the reference's parallel-cumsum idiom:
    line the work up oldest-first with the arrivals last, serve
    ``clip(cap - older_mass, 0, width)`` of each bucket; the unserved
    oldest bucket drops (deadline expiry), the survivors age one hour and
    re-queue under ``bound`` (oldest kept, youngest dropped)."""
    batch = q.shape[:-1]
    a = torch.broadcast_to(a_t, batch)[..., None]
    w = torch.cat([q.flip(-1), a], -1)             # oldest first
    excl = torch.cumsum(w, -1) - w
    room = torch.broadcast_to(cap_t, batch)[..., None] - excl
    serve = _ledger_clip(room, w, tau)
    served = torch.sum(serve, -1)
    u = w - serve
    aged = u[..., 1:]                     # survivors, still oldest-first
    excl_a = torch.cumsum(aged, -1) - aged
    keep = _ledger_clip(bound - excl_a, aged, tau)
    dropped = u[..., 0] + torch.sum(aged - keep, -1)
    return keep.flip(-1), served, dropped


class QueueScanOut(NamedTuple):
    """Ledger sufficient statistics over the horizon (batch-shaped)."""

    served: torch.Tensor       # total MWh served
    dropped: torch.Tensor      # total MWh dropped (expiry + overflow)
    backlog: torch.Tensor      # MWh-hours deferred (sum of hourly backlog)
    served_cost: torch.Tensor  # EUR: sum_t served_t p_t (0 without prices)
    q_final: torch.Tensor      # [..., D] end-of-run queue, youngest first


class QueueHourly(NamedTuple):
    """Per-hour ledger series ([..., T] each)."""

    served: torch.Tensor
    dropped: torch.Tensor
    backlog: torch.Tensor


def _ledger_dtype(*xs) -> torch.dtype:
    """The ledger's type: float64 if any input is float64, else float32
    (the reference's ``result_type``, integers computing in float32)."""
    return torch.float64 if any(
        isinstance(x, torch.Tensor) and x.dtype == torch.float64
        or isinstance(x, np.ndarray) and x.dtype == np.float64
        for x in xs) else torch.float32


def _ledger_loop(a, c, p, *, deadline: int, bound, tau, keep_hist: bool,
                 hourly: bool):
    """The hour loop of `queue_hour_step` over [..., T] inputs of one
    dtype. Returns ``(QueueScanOut, hist, hourly)``: ``hist`` the queue
    entering each hour [T, ..., D] (or None), ``hourly`` a `QueueHourly`
    (or None)."""
    batch, t_len = a.shape[:-1], a.shape[-1]
    zeros = torch.zeros(batch, dtype=a.dtype, device=a.device)
    q = torch.zeros(batch + (int(deadline),), dtype=a.dtype, device=a.device)
    bound = torch.as_tensor(bound, dtype=a.dtype, device=a.device)
    acc = [zeros] * 4
    hist, ys = [], []
    for t in range(t_len):
        if keep_hist:
            hist.append(q)
        q, served, dropped = queue_hour_step(q, a[..., t], c[..., t],
                                             bound=bound, tau=tau)
        bl = torch.sum(q, -1)
        acc = [acc[0] + served, acc[1] + dropped, acc[2] + bl,
               acc[3] + served * p[..., t]]
        if hourly:
            ys.append((served, dropped, bl))
    out = QueueScanOut(*acc, q)
    return (out, torch.stack(hist) if keep_hist else None,
            QueueHourly(*(torch.stack(y, -1) for y in zip(*ys)))
            if hourly else None)


def _ledger_inputs(arrivals, cap, prices=None):
    """Arrivals, capacity and prices broadcast to one [..., T] shape in
    the ledger's dtype, on the arrivals' device."""
    dtype = _ledger_dtype(arrivals, cap)
    dev = arrivals.device if isinstance(arrivals, torch.Tensor) else None
    a = torch.as_tensor(arrivals, device=dev).to(dtype)
    c = torch.as_tensor(cap, device=a.device).to(dtype)
    shape = torch.broadcast_shapes(a.shape, c.shape)
    a, c = torch.broadcast_to(a, shape), torch.broadcast_to(c, shape)
    p = torch.zeros(shape, dtype=dtype, device=a.device) if prices is None \
        else torch.broadcast_to(torch.as_tensor(prices, device=a.device)
                                .to(dtype), shape)
    return a, c, p


def queue_scan_ref(arrivals, cap, *, deadline: int, bound, tau=None,
                   prices=None, hourly: bool = False):
    """The work ledger over the horizon, a Python loop of
    `queue_hour_step` (the reference's `queue_scan` contract).

    arrivals/cap: [..., T] MWh per hour, mutually broadcastable;
    ``prices`` (optional, broadcastable) prices each served MWh at the
    hour it is actually served. ``tau=None`` is the hard ledger; a number
    or tensor runs the `smoothclip` relaxation (autograd flows through
    it). ``deadline`` is any integer >= 0 (0: serve or drop the same
    hour). Float64 inputs compute in float64, anything else in float32.
    With ``hourly=True`` returns ``(QueueScanOut, QueueHourly)``."""
    if int(deadline) < 0:
        raise ValueError(f"queue_scan: deadline must be >= 0, got "
                         f"{deadline}")
    a, c, p = _ledger_inputs(arrivals, cap, prices)
    out, _, ys = _ledger_loop(a, c, p, deadline=int(deadline), bound=bound,
                              tau=tau, keep_hist=False, hourly=hourly)
    return (out, ys) if hourly else out


def soft_ledger_fwd_ref(demand: torch.Tensor, cap: torch.Tensor,
                        tau: torch.Tensor, *, deadline: int, bound,
                        prices=None, hard: bool = False,
                        hourly: bool = False):
    """Plain version of the ledger's forward kernel (``soft_ledger_fwd``):
    demand/cap [B, T] MWh of one dtype, ``tau`` a [1] tensor (the MWh
    temperature; unread when ``hard``), prices [B, T] or None.

    Returns ``(sums [4, B], hist [T, B, D], q_final [B, D], hourly)``:
    the served, dropped, backlog (MWh-hours) and served-cost sums, the
    queue entering every hour (youngest first; the backward's residual;
    None when ``hard``), the end-of-run queue and, with ``hourly``, the
    [3, B, T] served / dropped / backlog series (else None)."""
    p = torch.zeros_like(demand) if prices is None else prices
    out, hist, ys = _ledger_loop(
        demand, cap, p, deadline=int(deadline), bound=bound,
        tau=None if hard else tau[0], keep_hist=not hard, hourly=hourly)
    sums = torch.stack([out.served, out.dropped, out.backlog,
                        out.served_cost])
    return sums, hist, out.q_final, (torch.stack(ys) if hourly else None)


def _rev_excl(x: torch.Tensor) -> torch.Tensor:
    """sum_{k > j} x_k along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), -1), (-1,)) - x


def soft_ledger_bwd_ref(demand: torch.Tensor, cap: torch.Tensor,
                        tau: torch.Tensor, hist: torch.Tensor,
                        g: torch.Tensor, *, deadline: int, bound,
                        prices=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ledger's backward kernel (``soft_ledger_bwd``):
    the VJP of `soft_ledger_fwd_ref`'s four sums for the cotangents ``g``
    [4, B] (served, dropped, backlog, served cost), from the queue
    entering each hour ``hist``. Returns ``(d_cap, d_demand)``, [B, T]
    each. Prices carry no gradient.

    Reverse time. Each hour recomputes its forward from the entering
    queue, then, with ``lam`` the adjoint of the queue it leaves (oldest
    first), ``gk = lam + g_backlog - g_dropped`` on each kept bucket:

        g_aged_j = g_dropped + gk_j dw2_j - sum_{k>j} gk_k dz2_k
        g_u      = [g_dropped, g_aged]
        g_room_i = (g_served' - g_u_i) dz1_i
        g_w_i    = g_u_i + (g_served' - g_u_i) dw1_i - sum_{k>i} g_room_k

    with g_served' = g_served + g_cost p_t, (dz, dw) the `smoothclip`
    derivatives ``sigma(z/tau) - sigma((z-w)/tau)`` and
    ``sigma((z-w)/tau)`` of the serve (1) and keep (2) clips; d cap_t is
    the sum of g_room, d demand_t the arrivals' g_w, and the entering
    queue's adjoint the rest of g_w."""
    b, t_len = demand.shape
    d = int(deadline)
    tau_ = tau[0]
    bound = torch.as_tensor(bound, dtype=demand.dtype, device=demand.device)
    g_s, g_d, g_b, g_c = (x[:, None] for x in g)
    lam = torch.zeros((b, d), dtype=demand.dtype, device=demand.device)
    d_cap = torch.empty_like(demand)
    d_dem = torch.empty_like(demand)
    for t in range(t_len - 1, -1, -1):
        w = torch.cat([hist[t].flip(-1), demand[:, t:t + 1]], -1)
        excl = torch.cumsum(w, -1) - w
        room = cap[:, t:t + 1] - excl
        u = w - smoothclip(room, w, tau_)
        aged = u[:, 1:]
        za = bound - (torch.cumsum(aged, -1) - aged)
        s1 = _sig_rn(torch.stack([room, room - w]) / tau_)
        dz1, dw1 = s1[0] - s1[1], s1[1]
        s2 = _sig_rn(torch.stack([za, za - aged]) / tau_)
        dz2, dw2 = s2[0] - s2[1], s2[1]
        g_serve_t = g_s if prices is None else g_s + g_c * prices[:, t:t + 1]
        gk = lam.flip(-1) + g_b - g_d
        g_aged = g_d + gk * dw2 - _rev_excl(gk * dz2)
        g_u = torch.cat([g_d, g_aged], -1)
        g_serve = g_serve_t - g_u
        g_room = g_serve * dz1
        g_w = g_u + g_serve * dw1 - _rev_excl(g_room)
        d_cap[:, t] = torch.sum(g_room, -1)
        d_dem[:, t] = g_w[:, d]
        lam = g_w[:, :d].flip(-1)
    return d_cap, d_dem


class WorkloadLedgerOut(NamedTuple):
    """Per-(row, draw) ledger sums of the fleet-coupled hard ledger
    ([B, G] each)."""

    served: torch.Tensor       # MWh
    dropped: torch.Tensor      # MWh
    backlog: torch.Tensor      # MWh-hours deferred
    served_cost: torch.Tensor  # EUR at the hour each MWh is served


def workload_ledger_ref(prices: torch.Tensor, p_on, p_off, off_level,
                        cap_mwh, demand: torch.Tensor, dt, *,
                        deadline: int, bound, market_idx=None,
                        hourly: bool = False):
    """Plain version of the hard ledger kernel (``workload_ledger_fwd``):
    every row's shutdown state machine (`hard_hour_step`'s comparisons,
    off tested first, starting on) inline, and its G demand draws served
    hour by hour with the hour's realised capacity ``cap_mwh * cap``.
    The reference's `workload_fleet_scan` without its fleet sums.

    prices: [B, T], or [N, T] with ``market_idx`` [B]; p_on/p_off/
    off_level/cap_mwh/dt: [B] or scalars; demand: [G, T] MW (row b's
    arrivals are ``dt_b * demand``). Float32 throughout. Returns
    ``(WorkloadLedgerOut, hourly)``; ``hourly`` is None, or with
    ``hourly=True`` the [4, B, T] per-row sums over the draws of each
    hour's arrivals, served, dropped and backlog MWh."""
    f32 = torch.float32
    p = prices.to(f32)
    rows = p if market_idx is None else p[market_idx]
    b, t_len = rows.shape
    dev = rows.device
    p_on, p_off, lvl, cmwh, dtb = (
        torch.as_tensor(v, device=dev).to(f32).expand(b)
        for v in (p_on, p_off, off_level, cap_mwh, dt))
    dem = demand.to(f32)
    g_n = dem.shape[0]
    bound = torch.as_tensor(bound, dtype=f32, device=dev)
    on = torch.ones(b, dtype=f32, device=dev)
    q = torch.zeros((b, g_n, int(deadline)), dtype=f32, device=dev)
    acc = [torch.zeros((b, g_n), dtype=f32, device=dev)] * 4
    ys = []
    for t in range(t_len):
        p_t = rows[:, t]
        on = torch.where(p_t > p_off, 0.0, torch.where(p_t <= p_on, 1.0, on))
        cap = lvl + (1.0 - lvl) * on
        a_bg = dtb[:, None] * dem[:, t][None, :]
        q, served, dropped = queue_hour_step(q, a_bg, (cmwh * cap)[:, None],
                                             bound=bound)
        bl = torch.sum(q, -1)
        acc = [acc[0] + served, acc[1] + dropped, acc[2] + bl,
               acc[3] + served * p_t[:, None]]
        if hourly:
            ys.append(torch.stack([x.sum(1) for x in (a_bg, served, dropped,
                                                      bl)]))
    return (WorkloadLedgerOut(*acc),
            torch.stack(ys, -1) if hourly else None)


def observed_prices(prices: torch.Tensor, price_ok: torch.Tensor):
    """The observed price series under feed gaps (rows x hours): the last
    arrived sample carried forward (the row's first true price before any
    arrives), and its staleness in hours — a cummax of the arrival hour,
    no hour loop."""
    hour = torch.arange(prices.shape[1], device=prices.device)
    last = torch.cummax(torch.where(price_ok, hour, -1), dim=1).values
    p_obs = torch.where(last >= 0,
                        prices.gather(1, torch.clamp(last, min=0)),
                        prices[:, :1])
    return p_obs, hour - last


def faulted_states_ref(prices: torch.Tensor, price_ok: torch.Tensor,
                       cap_mult: torch.Tensor, p_on, p_off, off_level,
                       idle_frac) -> FleetScanOut:
    """The fleet backtest's four sums under fault masks, without an hour
    loop. prices/price_ok/cap_mult: [B, T] (each row's market prices, its
    feed's arrivals, its capacity multiplier); parameters [B] or scalars.

    The reference steps `hard_hour_step` on the observed price through a
    `lax.scan` (`repro/faults/inject.py::_faulted_scan`). Here:

      * the observed price is the last arrived sample (`observed_prices`);
      * a row's state at hour t is that of its last decisive hour (the
        rule of `fleet_hourly_ref`): the observed price above p_off
        (off), else at or below p_on (on), or an outage (cap_mult <= 0:
        forced off, so recovery re-enters through a start);
      * capacity and draw scale by cap_mult (a partial derate), and costs
        settle at the true price.

    The states and start counts equal the reference's exactly; the float32
    sums over hours are reductions in another order."""
    p = prices.to(torch.float32)
    b, t_len = p.shape
    p_on, p_off, off_level, idle_frac = (
        torch.as_tensor(v, device=p.device).to(torch.float32)
        .expand(b)[:, None] for v in (p_on, p_off, off_level, idle_frac))
    m = cap_mult.to(torch.float32)
    hour = torch.arange(t_len, device=p.device)
    p_obs, _ = observed_prices(p, price_ok)
    off = p_obs > p_off
    turn_on = (p_obs <= p_on) & ~off
    forced = ~(m > 0.0)
    code = torch.where(off | turn_on | forced,
                       2 * hour + (turn_on & ~forced).long(), -1)
    last = torch.cummax(code, dim=1).values
    on = torch.where(last >= 0, (last & 1).to(torch.float32), 1.0)
    on_prev = torch.cat([torch.ones_like(on[:, :1]), on[:, :-1]], 1)
    start = torch.clamp(on - on_prev, min=0.0)
    cap = off_level + (1.0 - off_level) * on
    draw = cap + idle_frac * (1.0 - cap)
    return FleetScanOut(draw_price_sum=torch.sum(draw * m * p, 1),
                        up_units=torch.sum(cap * m, 1),
                        n_starts=torch.sum(start, 1),
                        restart_price_sum=torch.sum(start * p, 1))
