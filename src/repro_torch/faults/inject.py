"""Inject compiled fault masks into the engines.

`faulted_backtest` is the fleet backtest under faults, with three
arithmetic fault channels that are exact identities when healthy:

  * price-feed gaps — the state machine decides on the *observed* price
    (the last arrived sample, carried forward), while costs settle at the
    true market price (the exchange does not stop billing because a
    scraper died);
  * capacity outages — a zero multiplier forces the unit off (so recovery
    into a cheap hour re-enters through the normal start accounting and
    bills the restart overhead), a partial multiplier derates capacity and
    draw proportionally;
  * demand surges — consumed by `faulted_problem` on the dispatch side.

The reference steps `hard_hour_step` through a `lax.scan` with the masks
in its carry. The port computes the same states without an hour loop
(`repro_torch.kernels.ref.faulted_states_ref`: a cummax of the last
arrival for the observed price, a cummax of the last decisive hour for
the state, an outage hour one more decisive event), as a few [B, T]
tensor passes on the grid's device. Decisions and start counts equal the
reference's exactly; the float32 sums over hours are reductions in
another order. Trivial masks run `repro_torch.fleet.backtest` itself (the
`fleet_scan` kernel on the card), so a zero-fault run is the plain
backtest bit for bit.

`faulted_problem` lowers the same masks onto a `DispatchProblem` on the
host: derated availability, surged demand, and gap-filled observed prices
(with the sort precompute invalidated so `dispatch` recomputes it); pair
it with `repro_torch.dispatch.Relief` so storm-induced infeasible hours
shed instead of raising.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.energy.stream import ffill_with_staleness
from repro_torch.faults.trace import FaultMasks, FaultTrace
from repro_torch.fleet.engine import backtest, fleet_report
from repro_torch.fleet.grid import ScenarioGrid
from repro_torch.fleet.report import FleetReport
from repro_torch.kernels.ref import faulted_states_ref


def resolve_masks(faults: Union[FaultTrace, FaultMasks], n_sites: int,
                  n_markets: int, horizon: int) -> FaultMasks:
    """Compile a `FaultTrace` onto the scenario shape, or validate that
    pre-compiled `FaultMasks` already match it."""
    if isinstance(faults, FaultTrace):
        return faults.compile(n_sites, n_markets, horizon)
    m = faults
    if (m.cap_mult.shape != (n_sites, horizon)
            or m.price_ok.shape != (n_markets, horizon)):
        raise ValueError(
            f"FaultMasks compiled for cap{m.cap_mult.shape}/"
            f"price{m.price_ok.shape} do not fit a scenario with "
            f"{n_sites} sites x {n_markets} markets x {horizon} hours")
    return m


def emit_fault_events(faults: Union[FaultTrace, FaultMasks],
                      masks: FaultMasks, *, scope: str) -> None:
    """One ``fault.injected`` trace event per scheduled fault (or one
    aggregate event for hand-built masks), plus exposure counters — the
    raw material of the digest's Degradation section."""
    if not obs.enabled():
        return
    if isinstance(faults, FaultTrace) and len(faults):
        for ev in faults.events:
            obs.trace_event("fault.injected", {
                "fault": ev.kind, "target": int(ev.target),
                "start": int(ev.start), "duration": int(ev.duration),
                "magnitude": float(ev.magnitude), "scope": scope,
                "seed": faults.seed})
    elif not masks.is_trivial:
        counts = masks.counts()
        obs.trace_event("fault.injected", {
            "fault": "masks", "target": -1, "start": 0,
            "duration": int(masks.demand_mult.shape[0]),
            "magnitude": 1.0, "scope": scope, "seed": None, **counts})
    for k, v in masks.counts().items():
        if v:
            obs.counter(f"fault.{k}").inc(v)


def faulted_backtest(grid: ScenarioGrid,
                     faults: Union[FaultTrace, FaultMasks, None] = None,
                     *, _force_masked: bool = False,
                     device: DeviceLike = None) -> FleetReport:
    """`repro_torch.fleet.backtest` under a fault schedule, on ``device``
    (default ``cuda``; raises without it).

    ``faults`` is a `FaultTrace` (compiled here onto the grid's B rows x
    N markets x T hours; outage targets index backtest *rows*) or
    pre-compiled `FaultMasks`. None, an empty trace or trivial masks run
    ``backtest(grid)`` — the same report bit for bit, at no extra cost.
    ``_force_masked`` keeps the masked computation on trivial masks
    anyway: its decisions and start counts then equal the backtest's
    exactly and its sums agree to float32 rounding (another summation
    order; the tests hold them at rtol 1e-5).
    """
    dev = resolve_device(device)
    if faults is None:
        faults = FaultTrace()
    if (isinstance(faults, FaultTrace) and not len(faults)
            and not _force_masked):
        return backtest(grid, device=dev)
    masks = resolve_masks(faults, grid.n_rows, grid.n_markets,
                          grid.n_hours)
    emit_fault_events(faults, masks, scope="backtest")
    if masks.is_trivial and not _force_masked:
        return backtest(grid, device=dev)
    grid = grid.to(dev)
    rows = grid.prices[grid.market_idx]                     # [B, T]
    ok = torch.as_tensor(masks.price_ok, device=dev)[grid.market_idx]
    mult = torch.as_tensor(masks.cap_mult, dtype=torch.float32, device=dev)
    scan = faulted_states_ref(rows, ok, mult, grid.p_on, grid.p_off,
                              grid.off_level, grid.idle_frac)
    return fleet_report(grid, scan)


def faulted_problem(problem, faults: Union[FaultTrace, FaultMasks], *,
                    site_market_idx: Optional[np.ndarray] = None):
    """Lower a fault schedule onto a `repro_torch.dispatch.DispatchProblem`
    (host numpy, as the problem is).

    Availability is derated by the capacity mask, demand scaled by the
    surge profile, and each site's price row forward-filled over its
    market's feed gaps (`ffill_with_staleness` — the operator allocates on
    the last published price). ``site_market_idx`` maps sites to mask
    markets; omitted, the mask must carry one row per site (or a single
    shared row). The segment sort is invalidated so `dispatch` recomputes
    it from the observed prices. Trivial masks return the problem object
    unchanged.
    """
    s, t = np.asarray(problem.avail_mw).shape
    if isinstance(faults, FaultTrace):
        masks = faults.compile(s, s, t)
    else:
        masks = faults
        if masks.cap_mult.shape != (s, t):
            raise ValueError(
                f"FaultMasks.cap_mult{masks.cap_mult.shape} does not "
                f"fit a {s}-site x {t}-hour dispatch problem")
    if masks.is_trivial:
        return problem

    ok = np.asarray(masks.price_ok)
    if site_market_idx is not None:
        ok_rows = ok[np.asarray(site_market_idx)]
    elif ok.shape[0] == s:
        ok_rows = ok
    elif ok.shape[0] == 1:
        ok_rows = np.broadcast_to(ok, (s, t))
    else:
        raise ValueError(
            f"price_ok has {ok.shape[0]} markets for {s} sites — pass "
            "site_market_idx to map sites onto mask markets")

    prices = np.asarray(problem.prices, np.float64)
    if not ok_rows.all():
        filled = prices.copy()
        for i in range(s):
            if not ok_rows[i].all():
                filled[i], _ = ffill_with_staleness(
                    np.where(ok_rows[i], prices[i], np.nan))
        prices = filled
    avail = np.asarray(problem.avail_mw, np.float64) * masks.cap_mult
    demand = np.asarray(problem.demand_mw, np.float64) \
        * masks.demand_mult
    emit_fault_events(faults, masks, scope="dispatch")
    return problem._replace(
        prices=prices.astype(np.float32),
        avail_mw=avail.astype(np.float32),
        demand_mw=demand.astype(np.float32),
        order=None, rank=None)
