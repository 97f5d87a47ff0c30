"""Materialised per-site shutdown schedules.

The fleet scan (`repro_torch.kernels.fleet_scan`) never stores the
[S, T] on/off trajectory: every per-site cost is affine in four sums. The
dispatcher needs the hour-by-hour capacity each site offers, which is the
same two-threshold hysteresis state machine, materialised instead of
summed. The state is one bit that only a decisive hour changes, so the
trajectory needs no loop over T: each hour takes the state of the last
decisive hour at or before it (a `cummax` of decisive hour indices).
"""

from __future__ import annotations

import torch


def _rows(v, s: int, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(v, device=like.device).to(torch.float32)
    return t.expand(s)[:, None]


def on_state_series(prices: torch.Tensor, p_on, p_off) -> torch.Tensor:
    """[S, T] float32 on/off trajectory of the hysteresis state machine,
    on the prices' device. Same recurrence and initial state (running)
    as `repro_torch.kernels.ref.fleet_scan_ref`:

        on_t = 0 if p_t > p_off, 1 if p_t <= p_on, else on_{t-1}

    (off tested first). ``p_off = +inf`` rows never shut down.
    """
    p = torch.as_tensor(prices).to(torch.float32)
    s, t = p.shape
    off = p > _rows(p_off, s, p)
    decisive = off | (p <= _rows(p_on, s, p))
    hours = torch.arange(t, device=p.device).expand(s, t)
    last = torch.cummax(torch.where(decisive, hours, -1), dim=1).values
    state = torch.where(off, 0.0, 1.0)           # the state a decisive hour sets
    return torch.where(last >= 0, state.gather(1, last.clamp(min=0)), 1.0)


def capacity_series(prices: torch.Tensor, p_on, p_off,
                    off_level) -> torch.Tensor:
    """[S, T] capacity fraction each site offers per hour: 1 while on,
    ``off_level`` (partial shutdown, paper §V-C) while off."""
    on = on_state_series(prices, p_on, p_off)
    lvl = _rows(off_level, on.shape[0], on)
    return lvl + (1.0 - lvl) * on
