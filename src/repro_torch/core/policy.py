"""Executable shutdown policies over concrete price series.

Policies map a price series to an uptime mask, and cost accounting
evaluates any mask, which prices in shutdown/restart overheads and
hysteresis (beyond the paper's free, instantaneous shutdowns, §V-A).
"""

from __future__ import annotations

import torch

from repro_torch.core.tco import SystemCosts
from repro_torch.device import DeviceLike, as_tensor


def threshold_policy(prices, p_thresh, *,
                     device: DeviceLike = None) -> torch.Tensor:
    """Uptime mask: run (1.0) while price <= threshold, else shut down —
    the paper's WS policy on a concrete series."""
    return (as_tensor(prices, device) <= p_thresh).to(torch.float32)


def hysteresis_policy(prices, p_on, p_off, *,
                      device: DeviceLike = None) -> torch.Tensor:
    """Two-threshold policy: shut down when price rises above ``p_off``;
    resume only when it falls back below ``p_on`` (p_on <= p_off). Starts
    running. Time is the last axis; leading axes are a batch."""
    p = as_tensor(prices, device)
    running = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    one, zero = torch.ones_like(running), torch.zeros_like(running)
    mask = torch.empty_like(p)
    for t in range(p.shape[-1]):
        pt = p[..., t]
        running = torch.where(pt > p_off, zero,
                              torch.where(pt < p_on, one, running))
        mask[..., t] = running
    return mask


def policy_energy_cost(sys: SystemCosts, prices, uptime,
                       idle_power_frac: float = 0.0, *,
                       device: DeviceLike = None) -> torch.Tensor:
    """Energy cost of an arbitrary uptime mask:
    E = sum_i dt * C * (uptime_i + idle * (1-uptime_i)) * p_i."""
    p = as_tensor(prices, device)
    dt = sys.T / p.shape[0]
    draw = uptime + idle_power_frac * (1.0 - uptime)
    return torch.sum(dt * sys.C * draw * p)


def policy_cpc(sys: SystemCosts, prices, uptime,
               idle_power_frac: float = 0.0,
               restart_energy_mwh: float = 0.0,
               restart_time_h: float = 0.0,
               initial_uptime: float = 1.0, *,
               device: DeviceLike = None) -> torch.Tensor:
    """CPC of an arbitrary uptime mask, including restart overheads.

    Each 0->1 transition costs ``restart_energy_mwh`` (billed at that
    interval's price) and ``restart_time_h`` of lost uptime.
    ``initial_uptime`` is the state before the series begins (1.0 matches
    `hysteresis_policy`); starting off counts the boot at index 0 as a
    restart. With zero overheads and a threshold mask this is Eq. (13).
    """
    p = as_tensor(prices, device)
    uptime = torch.as_tensor(uptime, device=p.device)
    dt = sys.T / p.shape[0]
    e_run = policy_energy_cost(sys, p, uptime, idle_power_frac,
                               device=p.device)
    prev = torch.cat([uptime.new_full((1,), initial_uptime), uptime[:-1]])
    starts = torch.clamp(uptime - prev, min=0.0)
    e_restart = torch.sum(starts * restart_energy_mwh * p)
    up_hours = torch.sum(uptime) * dt - torch.sum(starts) * restart_time_h
    return (sys.F + e_run + e_restart) / torch.clamp(up_hours, min=1e-9)


def shutdown_cost_adjusted_viability(psi_val, k, restart_overhead_frac):
    """Eq. (19) with a restart overhead as a fraction of the energy saved
    per shutdown: k (1 - overhead) > Psi + 1."""
    return k * (1.0 - restart_overhead_frac) > psi_val + 1.0
