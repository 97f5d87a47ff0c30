"""Plain PyTorch versions of the port's kernels.

Each function here is the straightforward form of one hand-written
kernel: the CPU runs it, and on the card it is what the kernel is held
against. The per-hour math mirrors the reference package's oracles line
for line.
"""

from __future__ import annotations

from typing import NamedTuple

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
