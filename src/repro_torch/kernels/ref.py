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
