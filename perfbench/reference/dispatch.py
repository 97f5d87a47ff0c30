"""The fleet term of dispatch-aware tuning, plainly: the sites' relaxed
availability, an entropic water-fill of the fleet's demand over it hour
by hour, and the dispatched fleet's CPC.

Candidate rows of a (market, system) site are blended by a softmax over
their own CPC ratios at temperature ``0.01 tau``. Each hour every site
offers three capacity segments: load locked by the minimum dwell, load
it already holds (priced ``p - migrate_cost``) and fresh capacity (priced
``p``; locked load sits below every price). The water level lam solves

    sum_j w_j sigmoid((lam - key_j) / tau) = demand

(found here by a search over candidate levels, then one Newton step that
carries the gradient), the fill is renormalised to the demand, and a
site that gains more than 1e-3 MW restarts its dwell count. The
dispatched cost is fixed + energy + migration on the matched inflow and
outflow, over the delivered MWh, against a constant O(fleet CPC)
normaliser; a shortfall of availability under 1.05 x demand is penalised
quadratically.
"""

from __future__ import annotations

import torch

from reference.soft import softplus

SEL_SCALE = 0.01          # candidate-selection temperature per unit tau
SIGMA_SPAN = 40.0         # the level lives within +-40 tau of the keys
DWELL_CNT_SCALE = 0.05    # dwell-count temperature per unit tau
DWELL_EVENT_MW = 1e-3     # a gain of more than this restarts the dwell
FEAS_MARGIN = 1.05
TINY = 1e-30


def segment_keys(prices_c: torch.Tensor, migrate_cost: float) -> torch.Tensor:
    """[T, 3C] keys: locked (below every price), retained, fresh."""
    p = prices_c.T                                           # [T, C]
    span = float(p.max() - p.min()) + abs(migrate_cost) + 1.0
    return torch.cat([p - span, p - migrate_cost, p], dim=1)


@torch.no_grad()
def _level(keys: torch.Tensor, widths: torch.Tensor, demand, inv_tau,
           rounds: int = 5, grid: int = 256) -> torch.Tensor:
    """The level where the filled widths reach the demand, by ``rounds``
    searches over ``grid`` candidate levels each."""
    span = SIGMA_SPAN / inv_tau
    lo, hi = keys.min() - span, keys.max() + span
    for _ in range(rounds):
        cand = lo + (hi - lo) * torch.arange(
            grid + 1, dtype=keys.dtype, device=keys.device) / grid
        filled = (widths[None, :] * torch.sigmoid(
            (cand[:, None] - keys[None, :]) * inv_tau)).sum(1)
        i = torch.clamp(torch.sum(filled < demand) - 1, 0, grid - 1)
        lo, hi = cand[i], cand[i + 1]
    return 0.5 * (lo + hi)


def water_fill(avail: torch.Tensor, keys: torch.Tensor, demand: torch.Tensor,
               tau, *, min_dwell: int, mw_scale: float) -> torch.Tensor:
    """[C, T] allocation of ``demand`` [T] over ``avail`` [C, T]."""
    c, t = avail.shape
    inv_tau = 1.0 / tau
    inv_mw = inv_tau / mw_scale
    inv_cnt = inv_tau / DWELL_CNT_SCALE
    prev = torch.zeros(c, dtype=avail.dtype, device=avail.device)
    dwell = torch.zeros_like(prev)
    span = SIGMA_SPAN / inv_tau
    out = []
    for h in range(t):
        a, k, d = avail[:, h], keys[h], demand[h]
        held = torch.minimum(prev, a)
        locked = (torch.sigmoid((dwell - 0.5) * inv_cnt) * held
                  if min_dwell > 0 else torch.zeros_like(held))
        w = torch.cat([locked, held - locked, a - held])
        lam_hat = _level(k, w.detach(), d, inv_tau)
        sig = torch.sigmoid((lam_hat - k) * inv_tau)
        ws = w * sig
        denom = torch.clamp((ws * (1.0 - sig)).sum() * inv_tau,
                            min=TINY).detach()
        step = (d - ws.sum()) / denom
        lam = lam_hat + torch.minimum(torch.maximum(step, -span), span)
        fill = w * torch.sigmoid((lam - k) * inv_tau)
        fill = fill * (d / torch.maximum(fill.sum(), 1e-9 * d + TINY))
        alloc = fill[:c] + fill[c:2 * c] + fill[2 * c:]
        if min_dwell > 0:
            moved_in = torch.sigmoid((alloc - prev - DWELL_EVENT_MW)
                                     * inv_mw)
            count_down = softplus((dwell - 1.0) * inv_cnt) / inv_cnt
            dwell = moved_in * min_dwell + (1.0 - moved_in) * count_down
        prev = alloc
        out.append(alloc)
    return torch.stack(out, dim=1)


def fleet_ratio(cap: torch.Tensor, ratio: torch.Tensor, site: dict, tau):
    """(dispatched fleet CPC / normaliser, availability shortfall) of the
    relaxed capacity ``cap`` [B, T] with per-row ratios ``ratio`` [B];
    ``site`` holds ``cell`` [B] (row -> site), ``power`` and ``fixed``
    [B], ``prices`` [C, T], ``demand`` [T], ``migrate_cost``,
    ``min_dwell``, ``mw_scale`` and ``cpc_ref``."""
    dt = cap.dtype
    cell = site["cell"]
    n_cells = site["prices"].shape[0]
    members = (cell[None, :] == torch.arange(
        n_cells, device=cap.device)[:, None]).to(dt)           # [C, B]
    score = -ratio / (tau * SEL_SCALE)
    peak = torch.stack([score.detach()[cell == j].max()
                        for j in range(n_cells)])
    e = torch.exp(score - peak[cell])
    sel = e / (members @ e)[cell]
    avail = members @ ((sel * site["power"].to(dt))[:, None] * cap)
    fixed_fleet = torch.sum(sel * site["fixed"].to(dt))
    prices = site["prices"].to(dt)
    demand = site["demand"].to(dt)
    keys = segment_keys(prices, site["migrate_cost"])
    alloc = water_fill(avail, keys, demand, tau,
                       min_dwell=site["min_dwell"],
                       mw_scale=site["mw_scale"])
    energy = torch.sum(alloc * prices)
    prev = torch.cat([torch.zeros_like(alloc[:, :1]), alloc[:, :-1]], 1)
    delta = alloc - prev
    inflow = torch.relu(delta).sum(0)
    outflow = torch.relu(-delta).sum(0)
    moved = 0.5 * (inflow + outflow - torch.abs(inflow - outflow))
    migration = site["migrate_cost"] * moved.sum()
    cpc_fleet = (fixed_fleet + energy + migration) / torch.clamp(
        alloc.sum(), min=1e-9)
    short = torch.relu(FEAS_MARGIN * demand - avail.sum(0)) / torch.clamp(
        demand, min=1e-9)
    return cpc_fleet / site["cpc_ref"], torch.sum(short ** 2)
