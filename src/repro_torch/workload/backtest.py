"""Workload-coupled fleet backtest: CPC as a distribution over demand.

`workload_backtest` is `repro_torch.fleet.backtest` with the work ledger
riding beside the scan: every scenario row serves all ``n_draws`` demand
draws with its hour-by-hour *realised* capacity, so a shutdown decision
defers real work into the bounded queue (priced at the SLO penalty per
MWh-hour, plus the energy price eventually paid when it is served) or
drops it (priced at the `repro_torch.dispatch.Relief` VoLL rate). The
result carries the plain `FleetReport` — the engine's own scan and cost
assembly, so it equals ``backtest(grid)`` bit for bit; the ledger feeds
nothing back — plus a `WorkloadResult` with served/deferred/dropped
totals and CPC p10/p50/p90 over the draws.

On the card the fleet half is the `fleet_scan` kernel and the ledger the
`workload_ledger_fwd` kernel (`repro_torch.kernels.queue_scan`), each
reading the rows' markets through the grid's index; the reference fuses
both into one `lax.scan`.

Zero-workload configs short-circuit to the plain ``backtest`` at zero
overhead, exactly like `repro_torch.faults.faulted_backtest`
(``_force_coupled`` runs the coupled path anyway).

A ``demand_surge`` fault schedule perturbs the *arrival intensity*
before sampling (`Workload.arrival_rate`), so surges reshape the request
process itself rather than scaling a finished profile.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.engine import backtest, fleet_report
from repro_torch.fleet.grid import ScenarioGrid
from repro_torch.fleet.report import FleetReport
from repro_torch.kernels.queue_scan import workload_fleet_scan
from repro_torch.workload.trace import Workload

_SERVED_FLOOR_MWH = 1e-9   # CPC denominator floor (a draw a row never
                           # serves is priced per this epsilon, like the
                           # up-hours floor in `fleet_costs`)


class WorkloadResult(NamedTuple):
    """Ledger economics of a workload-coupled backtest.

    Per-(row, draw) tensors are [B, G]; quantiles are per-row [B] over the
    G draws. ``cost`` is the full realized bill — fleet TCO (energy at
    true prices, restarts, fixed) + SLO deferral penalty + VoLL drops —
    and ``cpc`` prices it per *served* MWh.
    """

    served_mwh: torch.Tensor      # [B, G]
    dropped_mwh: torch.Tensor     # [B, G]
    deferred_mwh_h: torch.Tensor  # [B, G] MWh-hours of carried backlog
    served_cost: torch.Tensor     # [B, G] EUR at the hour each MWh served
    arrivals_mwh: torch.Tensor    # [B, G] total offered work
    cost: torch.Tensor            # [B, G] TCO + defer + drop EUR
    cpc: torch.Tensor             # [B, G] cost per served MWh
    cpc_p10: torch.Tensor         # [B]
    cpc_p50: torch.Tensor         # [B]
    cpc_p90: torch.Tensor         # [B]

    @property
    def n_draws(self) -> int:
        return int(self.served_mwh.shape[1])


class WorkloadBacktest(NamedTuple):
    """``report`` is the plain `FleetReport`; ``workload`` is None on the
    zero-workload short-circuit path."""

    report: FleetReport
    workload: Optional[WorkloadResult]


def _workload_stats(res, tco, demand_mw, dt, slo_rate,
                    voll) -> WorkloadResult:
    """[B, G] ledger economics + per-row CPC quantiles (linear
    interpolation, the reference's) from the ledger's sums."""
    arrivals_mwh = dt[:, None] * torch.sum(demand_mw, 1)[None, :]
    cost = tco[:, None] + slo_rate * res.backlog + voll * res.dropped
    cpc = cost / torch.clamp(res.served, min=_SERVED_FLOOR_MWH)
    q = torch.quantile(cpc, torch.tensor([0.1, 0.5, 0.9], dtype=cpc.dtype,
                                         device=cpc.device), dim=1)
    return WorkloadResult(
        served_mwh=res.served, dropped_mwh=res.dropped,
        deferred_mwh_h=res.backlog, served_cost=res.served_cost,
        arrivals_mwh=arrivals_mwh, cost=cost, cpc=cpc,
        cpc_p10=q[0], cpc_p50=q[1], cpc_p90=q[2])


def _demand_mult(grid: ScenarioGrid, faults) -> Optional[np.ndarray]:
    """Compile a fault schedule onto the grid shape and keep only the
    demand-surge channel (price/outage channels belong to
    `repro_torch.faults.faulted_backtest` — pair the two for the supply
    side)."""
    if faults is None:
        return None
    from repro_torch.faults.inject import emit_fault_events, resolve_masks
    masks = resolve_masks(faults, grid.n_rows, grid.n_markets,
                          grid.n_hours)
    emit_fault_events(faults, masks, scope="workload")
    mult = np.asarray(masks.demand_mult, np.float64)
    return None if np.all(mult == 1.0) else mult


def _ledger(grid: ScenarioGrid, p_on, p_off, off_level, wl: Workload,
            demand_mw, hourly: bool = False):
    """The fleet scan and ledger of ``grid``'s rows under the given
    policy, each reading its market through the index; returns
    ``(WorkloadFleetOut, hourly or None, dt, demand [G, T] tensor)``."""
    t = grid.n_hours
    dt = grid.period / t                              # [B] hours/sample
    dem = torch.as_tensor(np.asarray(demand_mw), dtype=torch.float32,
                          device=grid.prices.device).contiguous()
    res = workload_fleet_scan(
        grid.prices.contiguous(), p_on, p_off, off_level, grid.idle_frac,
        grid.power * dt, dem, dt, deadline=int(wl.deadline_h),
        bound=float(wl.queue_bound_mwh), hourly=hourly,
        market_idx=grid.market_idx)
    res, hr = res if hourly else (res, None)
    return res, hr, dt, dem


def workload_backtest(grid: ScenarioGrid,
                      workload: Optional[Workload] = None,
                      faults=None, *, _force_coupled: bool = False,
                      device: DeviceLike = None) -> WorkloadBacktest:
    """Backtest ``grid`` against a stochastic request workload on
    ``device`` (default ``cuda``; raises without it).

    ``workload`` defaults to ``grid.workload``; with neither set the call
    short-circuits to the plain ``backtest(grid)`` — no demand sampling.
    With a telemetry run active it drains one ``workload.hourly`` event
    (per-hour means over rows x draws, from the ledger kernel's per-row
    hourly sums) and emits ``workload.result``; the results are the same
    bit for bit.
    """
    dev = resolve_device(device)
    wl = workload if workload is not None \
        else getattr(grid, "workload", None)
    if wl is None and not _force_coupled:
        return WorkloadBacktest(backtest(grid, device=dev), None)
    if wl is None:
        wl = Workload()
    grid = grid.to(dev)
    t = grid.n_hours
    demand_mw = wl.sample_demand_mw(t, _demand_mult(grid, faults))
    telemetry = obs.enabled()
    res, hourly, dt, dem = _ledger(grid, grid.p_on, grid.p_off,
                                   grid.off_level, wl, demand_mw,
                                   hourly=telemetry)
    if telemetry:
        obs.drain("workload.hourly", demand_mwh=hourly.demand_mwh,
                  served_mwh=hourly.served_mwh,
                  dropped_mwh=hourly.dropped_mwh,
                  backlog_mwh=hourly.backlog_mwh)
    report = fleet_report(grid, res.fleet)
    result = _workload_stats(res, report.tco, dem, dt,
                             float(wl.slo_penalty_eur_mwh),
                             float(wl.relief.voll_eur_mwh))
    if telemetry:
        obs.counter("workload.backtests").inc()
        stats = torch.stack([
            x.double().mean() for x in (
                result.served_mwh, result.dropped_mwh,
                result.deferred_mwh_h, result.cpc_p10, result.cpc_p50,
                result.cpc_p90)]).tolist()
        served, dropped = stats[0], stats[1]
        obs.trace_event("workload.result", {
            "rows": int(grid.n_rows), "hours": t,
            "n_draws": result.n_draws,
            "served_mwh": served, "dropped_mwh": dropped,
            "deferred_mwh_h": stats[2],
            "drop_frac": dropped / max(served + dropped, 1e-30),
            "cpc_p10_mean": stats[3], "cpc_p50_mean": stats[4],
            "cpc_p90_mean": stats[5]})
    return WorkloadBacktest(report, result)


def realized_cost(grid: ScenarioGrid, p_on, p_off, off_level,
                  workload: Workload,
                  demand_mw: Optional[np.ndarray] = None) -> torch.Tensor:
    """Mean-over-draws realized workload cost (energy + deferral + drop),
    [B] EUR on the grid's device, of candidate policies ``(p_on, p_off,
    off_level)`` on ``grid``'s markets/systems. The hard yardstick
    `repro_torch.tune.optimize` selects candidates by when a workload is
    configured — sample ``demand_mw`` once and share it across candidates
    so the comparison is paired."""
    if demand_mw is None:
        demand_mw = workload.sample_demand_mw(grid.n_hours)
    f32 = lambda v: torch.as_tensor(  # noqa: E731
        v, dtype=torch.float32, device=grid.prices.device)
    res, _, _, _ = _ledger(grid, f32(p_on), f32(p_off), f32(off_level),
                           workload, demand_mw)
    cost = fleet_report(grid, res.fleet).tco[:, None] \
        + float(workload.slo_penalty_eur_mwh) * res.backlog \
        + float(workload.relief.voll_eur_mwh) * res.dropped
    return torch.mean(cost, 1)                        # [B] EUR
