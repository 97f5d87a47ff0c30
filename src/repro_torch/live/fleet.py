"""Live cross-site dispatch: commit the first hour, plan the rest.

The offline dispatcher (`repro_torch.dispatch`) water-fills a *known*
[S, T] price block. The live loop instead, each hour: re-solves the
per-site shutdown thresholds against the forecast window (quantile
family, at the configured cadence), realizes each site's on/off state at
the TRUE current price (day-ahead — the current hour is always
published), commits one `dispatch_alloc_hour` fill on the true prices,
and plans the forecast horizon from the committed state to measure
*re-plan churn*: how much the committed allocation deviates from what the
previous hour's plan promised for this hour. Dwell locks and the
committed allocation carry across the horizon boundary, exactly like the
offline scan carry.

Two deliberate divergences from the offline path, both the reference's:

  * infeasibility does not raise mid-loop — demand above fleet
    availability is *shed* (the fill already caps at total width) and
    reported as ``shed_mwh`` instead of `DispatchInfeasible`;
  * the segment sort runs on the device each hour (`segment_keys_jnp`).
    The port builds the keys in float64 from the same span the host
    `segment_rank` uses, so its order is the host's exactly (the
    reference sorts float32 keys, equal to the host order whenever
    prices are distinct at float32): the never-re-solving loop equals
    `dispatch` bit for bit.

Re-plan churn reads only the first hour of each hour's plan. The
reference rolls the whole horizon (`plan_on_window` + `dispatch_window`)
and keeps ``plan[:, 0]``; the first output of a window depends only on
its first input and the carried state, so the port computes that hour
alone (`_first_planned_hour`, held bit for bit against the whole window
in the tests). The loop runs on the device, one Python iteration an
hour.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.energy.forecast import seasonal_naive_batch
from repro_torch.kernels.live_window import (segment_keys_jnp,
                                             segment_rank_jnp)
from repro_torch.kernels.queue_scan import queue_scan
from repro_torch.kernels.ref import dispatch_alloc_hour, hard_hour_step


class LiveFleetResult(NamedTuple):
    """Outcome of a live dispatch run over one fleet of S sites."""

    alloc_mw: torch.Tensor        # [S, hours] committed allocation
    cpc: torch.Tensor             # (fixed + energy + migration) / delivered
    energy_cost: torch.Tensor
    migration_cost: torch.Tensor
    migration_mw: torch.Tensor    # matched in/out flow, like summarize_alloc
    delivered_mwh: torch.Tensor
    shed_mwh: torch.Tensor        # demand the fleet could not place
    replan_mw: torch.Tensor       # sum_t |commit_t - plan_{t-1}(t)|
    p_off_final: torch.Tensor     # [S] last committed thresholds
    # work-ledger economics over sampled demand draws (None unless
    # `live_fleet_dispatch`'s ``workload``): {"served_mwh",
    # "dropped_mwh", "deferred_mwh_h", "cost"} ([G] numpy each) and
    # "cpc_p10/p50/p90" floats
    workload: Optional[dict] = None


def _first_planned_hour(on_new, alloc, dwell, fc, p_on, p_off, off_level,
                        idle_frac, power, d_next, migrate_cost, span, *,
                        min_dwell: int):
    """Hour 0 of the forecast-window plan from the committed state: what
    `plan_on_window` + `dispatch_window` give in ``[:, 0]`` when they roll
    the whole forecast ``fc [S, H]`` (the windows' later hours never feed
    back into their first)."""
    _, _, cap0, _ = hard_hour_step(on_new, fc[:, 0], p_on, p_off,
                                   off_level, idle_frac)
    _, rank0 = segment_rank_jnp(segment_keys_jnp(
        fc[:, 0].double(), migrate_cost, span))
    plan, _ = dispatch_alloc_hour(alloc, dwell, power * cap0, rank0, d_next,
                                  min_dwell=min_dwell)
    return plan


def _live_fleet_loop(prices, power, p_on0, p_off0, off_level, idle_frac,
                     x, demand, migrate_cost: float, span: float, *,
                     start: int, hours: int, horizon: int, cadence: int,
                     season: int, min_dwell: int):
    s, t_total = prices.shape
    dev = prices.device
    w = season + 1
    resolvable = x > 0.0
    hq = float(horizon)
    m_idx = torch.clamp(torch.round(x * hq), 1.0, hq - 1.0).long()
    # every hour's trailing window, gathered once: hour i reads columns
    # i .. i + w - 1 (its last column is the true price of hour start + i)
    cols = torch.arange(start - w + 1, start + hours, device=dev) % t_total
    block = prices[:, cols]                          # [S, hours + w - 1]

    on = torch.ones(s, dtype=torch.float32, device=dev)
    p_on_c, p_off_c = p_on0, p_off0
    prev = torch.zeros_like(on)
    dwell = torch.zeros_like(on)
    plan_next = torch.zeros_like(on)
    allocs, energy, shed, replan = [], [], [], []
    for i in range(hours):
        hist = block[:, i:i + w]                                 # [S, W]
        fc = seasonal_naive_batch(hist, horizon, season)         # [S, H]
        if i % cadence == 0:
            desc = torch.sort(fc, dim=1, descending=True).values
            q_thr = desc.gather(1, (m_idx - 1)[:, None])[:, 0]
            p_off_c = torch.where(resolvable, q_thr, p_off_c)
            p_on_c = torch.where(resolvable, q_thr, p_on_c)

        # realize site availability at the true (published) price
        p_t = hist[:, -1]
        on, _, cap, _ = hard_hour_step(on, p_t, p_on_c, p_off_c,
                                       off_level, idle_frac)
        d_t = demand[i]

        # commit this hour on true prices
        _, rank = segment_rank_jnp(segment_keys_jnp(p_t.double(),
                                                    migrate_cost, span))
        alloc, dwell = dispatch_alloc_hour(prev, dwell, power * cap, rank,
                                           d_t, min_dwell=min_dwell)
        if i > 0:
            replan.append(torch.sum(torch.abs(alloc - plan_next)))
        # the next hour of the plan from the committed state: planned
        # availability rolls the state machine over the forecast, planned
        # demand repeats the profile (wrapping the live window)
        plan_next = _first_planned_hour(
            on, alloc, dwell, fc, p_on_c, p_off_c, off_level, idle_frac,
            power, demand[(i + 1) % hours], migrate_cost, span,
            min_dwell=min_dwell)
        allocs.append(alloc)
        energy.append(torch.sum(alloc * p_t))
        shed.append(torch.clamp(d_t - torch.sum(alloc), min=0.0))
        prev = alloc
    replan_mw = torch.sum(torch.stack(replan)) if replan \
        else torch.zeros((), dtype=torch.float32, device=dev)
    return (torch.stack(allocs, 1), torch.stack(energy), torch.stack(shed),
            replan_mw, p_off_c)


def live_fleet_dispatch(prices, power, p_on, p_off, off_level, idle_frac,
                        x, demand=None, *, start: int = 0,
                        hours: int = 168,
                        horizon: int = 24, cadence: int = 1,
                        season: int = 168, migrate_cost: float = 0.0,
                        min_dwell: int = 0, fixed: float = 0.0,
                        workload=None, faults=None,
                        device: DeviceLike = None) -> LiveFleetResult:
    """Run the live dispatch loop over one fleet on ``device`` (default
    ``cuda``; raises without it).

    prices: [S, T] per-site market prices; power/p_on/p_off/off_level/
    idle_frac/x: [S] per-site policy state or scalars (``x <= 0``: the
    site keeps its offline thresholds — pass the full offline thresholds
    and ``x = 0`` everywhere with ``cadence >= hours`` to reproduce the
    offline `dispatch` path); demand: scalar MW or [hours] profile. Cost
    accounting mirrors `repro_torch.dispatch.summarize_alloc` (matched
    in/out migration flow; hour 0 placement is not a move).

    ``workload`` (a `repro_torch.workload.Workload`) makes ``demand``
    optional: the loop then plans against the workload's *mean* demand
    profile over the live window, and afterwards replays every sampled
    demand draw through the hard work ledger against the hour-by-hour
    *delivered* fleet allocation (`_replay_workload`) —
    `LiveFleetResult.workload` reports served/deferred/dropped totals per
    draw plus CPC p10/p50/p90 over the draws. ``faults`` (a demand-surge
    schedule, see `repro_torch.faults`) perturbs the arrival intensity of
    the live window, so live rows feel surges in the request process
    itself; without a workload it is not read.
    """
    dev = resolve_device(device)
    prices = torch.as_tensor(prices, dtype=torch.float32, device=dev)
    s, t_total = prices.shape
    if horizon < 2:
        raise ValueError("horizon must be >= 2")
    mult = None
    if workload is not None and faults is not None:
        from repro_torch.faults.inject import emit_fault_events, resolve_masks
        masks = resolve_masks(faults, s, s, int(start) + int(hours))
        emit_fault_events(faults, masks, scope="live.workload")
        m = np.asarray(masks.demand_mult, np.float64)
        mult = None if np.all(m == 1.0) else m
    if demand is None:
        if workload is None:
            raise ValueError("live_fleet_dispatch: pass demand= or a "
                             "workload= to derive it from")
        demand = workload.mean_demand_mw(int(start) + int(hours),
                                         mult)[start:start + hours]
    demand = np.asarray(demand, np.float32)
    if demand.ndim == 0:
        demand_h = np.broadcast_to(demand, (hours,))
    elif demand.shape == (hours,):
        demand_h = demand
    else:
        raise ValueError(f"demand must be a scalar or a length-{hours} "
                         f"profile, got shape {demand.shape}")
    # the host `segment_keys`' span, from the same float32 prices
    span = float(torch.amax(prices)) - float(torch.amin(prices)) \
        + abs(float(migrate_cost)) + 1.0

    def bcast(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev) \
            .expand(s).contiguous()

    alloc, energy_t, shed_t, replan_mw, p_off_f = _live_fleet_loop(
        prices, bcast(power), bcast(p_on), bcast(p_off), bcast(off_level),
        bcast(idle_frac), bcast(x),
        torch.as_tensor(np.ascontiguousarray(demand_h), device=dev),
        float(migrate_cost), span, start=int(start), hours=int(hours),
        horizon=int(horizon), cadence=int(cadence), season=int(season),
        min_dwell=int(min_dwell))

    a = alloc
    prev = torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)
    delta = a - prev
    moved = torch.minimum(torch.sum(torch.clamp(delta, min=0.0), 0),
                          torch.sum(torch.clamp(-delta, min=0.0), 0))
    migration_mw = torch.sum(moved)
    energy = torch.sum(energy_t)
    delivered = torch.sum(a)
    migration_cost = migrate_cost * migration_mw
    wl_stats = None
    if workload is not None:
        wl_stats = _replay_workload(
            workload, alloc, mult, start=int(start), hours=int(hours),
            fleet_cost=float(fixed + energy + migration_cost))
    return LiveFleetResult(
        alloc_mw=alloc,
        cpc=(fixed + energy + migration_cost)
        / torch.clamp(delivered, min=1e-9),
        energy_cost=energy, migration_cost=migration_cost,
        migration_mw=migration_mw, delivered_mwh=delivered,
        shed_mwh=torch.sum(shed_t), replan_mw=replan_mw,
        p_off_final=p_off_f, workload=wl_stats)


def _replay_workload(workload, alloc: torch.Tensor,
                     mult: Optional[np.ndarray], *, start: int, hours: int,
                     fleet_cost: float) -> dict:
    """Hard-ledger replay of every sampled demand draw against the
    committed hour-by-hour fleet allocation (after the loop, which it
    leaves untouched): the G draws are the rows of one float64
    `queue_scan` on the allocation's device (the ledger kernel on the
    card). Costing mirrors `repro_torch.workload.WorkloadResult`: fleet
    bill + SLO-priced backlog + VoLL-priced drops, per served MWh."""
    draws = workload.sample_demand_mw(start + hours, mult)[:, start:
                                                           start + hours]
    cap = torch.sum(alloc, 0).double()                 # MWh per hour
    out = queue_scan(torch.as_tensor(draws, device=alloc.device), cap,
                     deadline=int(workload.deadline_h),
                     bound=float(workload.queue_bound_mwh))
    served, dropped, backlog = (x.cpu().numpy() for x in (
        out.served, out.dropped, out.backlog))
    cost = (fleet_cost
            + float(workload.slo_penalty_eur_mwh) * backlog
            + float(workload.relief.voll_eur_mwh) * dropped)
    cpc = cost / np.maximum(served, 1e-9)
    p10, p50, p90 = np.quantile(cpc, [0.1, 0.5, 0.9])
    return {"served_mwh": served, "dropped_mwh": dropped,
            "deferred_mwh_h": backlog, "cost": cost,
            "cpc_p10": float(p10), "cpc_p50": float(p50),
            "cpc_p90": float(p90)}
