"""Fleet backtest: every scenario row, every hour, one pass.

The stateful hysteresis/partial-capacity scan runs batched over all B
rows, each reading its market's row of the [N, T] price block through
the grid's ``market_idx`` (the CUDA `fleet_scan` kernel on the card; the
plain `fleet_scan_ref` on the gathered rows on the CPU),
and cost accounting — restart overheads, idle draw, lost restart time
included — is a handful of [B] vector ops.

Row semantics match `repro_torch.core.policy.policy_cpc`. The row state
machine resumes on ``p <= p_on``, so a degenerate ``p_on == p_off`` row is
exactly `threshold_policy`; a proper hysteresis row differs from
`hysteresis_policy` (strict ``p < p_on``) only at samples exactly equal
to p_on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.execution import ExecutionPlan
from repro_torch.fleet.grid import ScenarioGrid, concat_rows, row_chunks
from repro_torch.fleet.report import FleetReport
from repro_torch.kernels.fleet_scan import fleet_scan
from repro_torch.kernels.ref import FleetScanOut, fleet_hourly_ref


class FleetCosts(NamedTuple):
    """Per-row cost assembly over a `FleetScanOut` (all [B])."""

    cpc: torch.Tensor          # realized cost-per-compute
    cpc_ao: torch.Tensor       # always-on baseline (Eq. 11)
    tco: torch.Tensor          # fixed + energy + restart cost
    energy_cost: torch.Tensor  # running + idle draw energy cost
    restart_cost: torch.Tensor
    up_hours: torch.Tensor


def fleet_costs(scan: FleetScanOut, *, price_sum, fixed, power, period,
                restart_energy_mwh, restart_time_h, n_samples: int
                ) -> FleetCosts:
    """Cost accounting, affine in the four scan sums — shared by the hard
    backtest and the tuner's soft objective (`repro_torch.tune`), which
    feeds it the relaxed sums. ``price_sum`` is sum_t p_t per row;
    ``n_samples`` the series length."""
    dt = period / n_samples                           # [B] hours per sample
    e_ao = dt * power * price_sum                     # E_AO (Eq. 6)
    e_run = dt * power * scan.draw_price_sum
    e_restart = restart_energy_mwh * scan.restart_price_sum
    up_hours = dt * scan.up_units - restart_time_h * scan.n_starts
    tco = fixed + e_run + e_restart
    cpc = tco / torch.clamp(up_hours, min=1e-9)
    cpc_ao = (fixed + e_ao) / period                  # Eq. (11)
    return FleetCosts(cpc=cpc, cpc_ao=cpc_ao, tco=tco, energy_cost=e_run,
                      restart_cost=e_restart, up_hours=up_hours)


def fleet_report(grid: ScenarioGrid, scan: FleetScanOut) -> FleetReport:
    """The `FleetReport` of ``grid``'s rows from their four scan sums: the
    cost assembly every backtest shares (plain, faulted, workload-coupled),
    costs settling at the true prices."""
    t = grid.n_hours
    price_sum = grid.prices.sum(1)[grid.market_idx]   # [B] sum_t p_t
    costs = fleet_costs(scan, price_sum=price_sum, fixed=grid.fixed,
                        power=grid.power, period=grid.period,
                        restart_energy_mwh=grid.restart_energy_mwh,
                        restart_time_h=grid.restart_time_h, n_samples=t)
    return FleetReport(
        cpc=costs.cpc, cpc_ao=costs.cpc_ao,
        cpc_reduction=1.0 - costs.cpc / costs.cpc_ao,
        tco=costs.tco, energy_cost=costs.energy_cost,
        restart_cost=costs.restart_cost,
        up_hours=costs.up_hours, n_starts=scan.n_starts,
        x_realized=1.0 - scan.up_units / t,
        market_idx=grid.market_idx, system_idx=grid.system_idx,
        policy_idx=grid.policy_idx)


def _backtest_rows(grid: ScenarioGrid,
                   use_kernel: Optional[bool]) -> FleetReport:
    # each row reads its market's prices through the index: no [B, T]
    # block is gathered on the card
    scan = fleet_scan(grid.prices.contiguous(), grid.p_on, grid.p_off,
                      grid.off_level, grid.idle_frac,
                      market_idx=grid.market_idx, use_kernel=use_kernel)
    if obs.enabled():
        # per-hour decision records: a companion of the same state machine
        # (`fleet_hourly_ref`, no hour loop), reduced to [T] on the device
        # and drained once a call — it reads the report's inputs and feeds
        # nothing back, so the FleetReport bits and the scan's route cannot
        # change
        hourly = fleet_hourly_ref(grid.prices[grid.market_idx], grid.p_on,
                                  grid.p_off, grid.off_level,
                                  grid.idle_frac, grid.power)
        obs.drain("fleet.hourly", on_mw=hourly.on_mw,
                  draw_price=hourly.draw_price, starts=hourly.starts,
                  stops=hourly.stops)
    return fleet_report(grid, scan)


def backtest(grid: ScenarioGrid, *, use_kernel: Optional[bool] = None,
             plan: Optional[ExecutionPlan] = None,
             device: DeviceLike = None) -> FleetReport:
    """Backtest every scenario row of ``grid`` on ``device``.

    ``use_kernel=None`` launches the CUDA `fleet_scan` kernel on the card
    and runs the plain `fleet_scan_ref` on the CPU; ``False`` runs the
    plain version on the card too (the comparison the chip check makes);
    ``True`` on the CPU raises.

    ``plan`` (`repro_torch.execution.ExecutionPlan`) chooses the layout.
    A chunked plan evaluates fixed-size row slices (via
    `ScenarioGrid.take_rows`), bounding the [chunk, T] rows the plain
    version gathers;
    per-row results are identical. ``mode='sharded'`` raises: the
    backtest is an uncoupled per-row map, so chunking covers its memory
    story.

    With a telemetry run active (`repro_torch.obs`) each call drains a
    ``fleet.hourly`` event (per-hour fleet aggregates) and emits one
    ``fleet.backtest`` event; the report is the same bit for bit.
    """
    if plan is not None and plan.mode == "sharded":
        raise ValueError(
            "backtest does not shard: the hard backtest is an uncoupled "
            "per-row map, so use ExecutionPlan(mode='chunked') for the "
            "memory bound (bitwise-identical results) instead")
    grid = grid.to(resolve_device(device))
    chunk = plan.chunk_rows if plan is not None else 0
    if chunk and grid.n_rows > chunk:
        parts = [_backtest_rows(grid.take_rows(sl), use_kernel)
                 for sl in row_chunks(grid.n_rows, chunk)]
        report = concat_rows(parts, grid.n_rows)
    else:
        report = _backtest_rows(grid, use_kernel)
    if obs.enabled():
        obs.counter("fleet.backtests").inc()
        # the reference's field name: whether the hand-written kernel ran
        kernel = grid.prices.is_cuda and use_kernel is not False
        stats = torch.stack([report.n_starts.sum(), report.cpc.mean(),
                             report.cpc_reduction.mean()]).tolist()
        obs.trace_event("fleet.backtest", {
            "rows": int(grid.n_rows), "hours": int(grid.n_hours),
            "use_pallas": bool(kernel), "n_starts_total": stats[0],
            "cpc_mean": stats[1], "reduction_mean": stats[2]})
    return report
