"""The hard policy backtest, plainly: Eq. (1)'s thresholds, the
two-threshold shutdown state machine hour by hour, and the cost
assembly of Eqs. (6)-(13).

A row starts on. At each hour it turns off when the price exceeds
``p_off``, else turns on when the price is at or below ``p_on``, else
keeps its state. While off it keeps ``off_level`` of its capacity and
draws ``idle_frac`` of the rest. A start (off -> on) costs
``restart_energy_mwh`` at that hour's price and ``restart_time_h`` of
lost compute.
"""

from __future__ import annotations

import torch


def policy_thresholds(prices: torch.Tensor, policies: list[dict],
                      dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, K] (p_on, p_off) in float32: a policy with a shutdown fraction
    ``x`` switches off above its market's m-th highest price, m =
    round(x T) clipped to [1, T - 1]; ``hysteresis`` h resumes below
    ``p_off - (1 - h) |p_off|``; a policy without ``x`` is always on
    (+inf). ``dtype`` is the precision the prices are sorted and the
    resume threshold is formed in (the comparison rounds once to float32
    at the end, as the thresholds are stated)."""
    n, t = prices.shape
    p = prices.to(dtype)
    sorted_desc = torch.sort(p, dim=1, descending=True).values
    offs, ons = [], []
    for pol in policies:
        x = pol.get("x")
        if x is not None and x > 0.0:
            m = min(max(int(round(x * t)), 1), t - 1)
            off = sorted_desc[:, m - 1]
        else:
            off = torch.full((n,), float("inf"), dtype=dtype,
                             device=p.device)
        back = torch.tensor(1.0 - pol.get("hysteresis", 1.0), dtype=dtype,
                            device=p.device)
        on = torch.where(torch.isfinite(off), off - back * off.abs(), off)
        offs.append(off)
        ons.append(on)
    return (torch.stack(ons, 1).to(torch.float32),
            torch.stack(offs, 1).to(torch.float32))


def hard_sums(prices: torch.Tensor, market_idx: torch.Tensor,
              p_on: torch.Tensor, p_off: torch.Tensor,
              off_level: torch.Tensor, idle_frac: torch.Tensor,
              dtype: torch.dtype) -> dict:
    """The state machine over every hour for R rows (row r reads market
    ``market_idx[r]`` of ``prices`` [N, T]), one step an hour over all
    rows; prices and thresholds are compared in float32, as stated (in
    ``dtype`` where that is lower), and the sums accumulate in ``dtype``.
    Returns [R] tensors: ``draw_price`` (sum draw_t p_t), ``up_units``
    (sum capacity_t), ``starts`` and ``restart_price`` (sum start_t
    p_t)."""
    # the comparison's precision: float32 as stated, lower for a control
    cmp = dtype if dtype.itemsize < 4 else torch.float32
    pt = prices.to(cmp).T.contiguous()                     # [T, N]
    p_on, p_off = p_on.to(cmp), p_off.to(cmp)
    lvl, idle = off_level.to(dtype), idle_frac.to(dtype)
    r = market_idx.shape[0]
    on = torch.ones(r, dtype=torch.bool, device=prices.device)
    acc = {k: torch.zeros(r, dtype=dtype, device=prices.device)
           for k in ("draw_price", "up_units", "starts", "restart_price")}
    for h in range(pt.shape[0]):
        p32 = pt[h][market_idx]
        new = torch.where(p32 > p_off, False, torch.where(p32 <= p_on, True,
                                                          on))
        start = (new & ~on).to(dtype)
        cap = lvl + (1.0 - lvl) * new.to(dtype)
        draw = cap + idle * (1.0 - cap)
        ph = p32.to(dtype)
        acc["draw_price"] += draw * ph
        acc["up_units"] += cap
        acc["starts"] += start
        acc["restart_price"] += start * ph
        on = new
    return acc


def costs(sums: dict, price_sum: torch.Tensor, fixed, power, period,
          restart_energy_mwh, restart_time_h, n_hours: int) -> dict:
    """Per-row CPC (Eq. 13 with restarts and idle draw), the always-on
    CPC (Eq. 11) and the reduction ``1 - cpc / cpc_ao``, in the sums'
    dtype; ``price_sum`` is each row's sum_t p_t."""
    dt = period / n_hours
    e_run = dt * power * sums["draw_price"]
    e_restart = restart_energy_mwh * sums["restart_price"]
    up = dt * sums["up_units"] - restart_time_h * sums["starts"]
    cpc = (fixed + e_run + e_restart) / torch.clamp(up, min=1e-9)
    cpc_ao = (fixed + dt * power * price_sum) / period
    return {"cpc": cpc, "cpc_ao": cpc_ao, "reduction": 1.0 - cpc / cpc_ao,
            "starts": sums["starts"]}
