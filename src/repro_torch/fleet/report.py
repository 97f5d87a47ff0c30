"""Fleet aggregation: per-row results -> fleet-level decisions.

`FleetReport` is the raw per-row output of the engine. `summarize` folds
it back onto the (market, system, policy) cube — keyed by the report's own
index columns, so it is invariant to any row permutation — and answers the
operator questions: which policy wins at each site, how far each policy is
from the closed-form oracle (`repro_torch.core.optimizer.optimal_shutdown`'s
reduction, Eqs. 21-29), and what the whole fleet spends in total.

With ``dispatch_cfg=`` the feasible cross-site dispatcher
(`repro_torch.dispatch`) runs over one site per covered (market, system)
cell. Workload-coupled ledgers (``workload=``) come with their own slice;
until then they raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.tco import cpc_reduction
from repro_torch.dispatch import DispatchConfig, build_problem, dispatch


class FleetReport(NamedTuple):
    """Per-scenario-row backtest results (all tensors of shape [B])."""

    cpc: torch.Tensor            # realized cost-per-compute under the policy
    cpc_ao: torch.Tensor         # always-on baseline CPC (Eq. 11)
    cpc_reduction: torch.Tensor  # 1 - cpc / cpc_ao
    tco: torch.Tensor            # F + energy + restart cost over the period
    energy_cost: torch.Tensor    # running + idle draw energy cost
    restart_cost: torch.Tensor   # energy cost of restarts
    up_hours: torch.Tensor       # operational hours (restart time deducted)
    n_starts: torch.Tensor       # off->on transitions
    x_realized: torch.Tensor     # realized average shutdown fraction
    market_idx: torch.Tensor     # [B] int64
    system_idx: torch.Tensor     # [B] int64
    policy_idx: torch.Tensor     # [B] int64


class FleetSummary(NamedTuple):
    """Fleet-level aggregates on the (N markets, M systems, K policies)
    cube. Cube cells never covered by a report row are NaN."""

    reduction: np.ndarray          # [N, M, K] CPC reduction per cell
    best_policy: np.ndarray        # [N, M] int argmax_k reduction
    best_reduction: np.ndarray     # [N, M]
    oracle_reduction: np.ndarray   # [N, M] closed-form optimum (Eqs. 21-29)
    regret: np.ndarray             # [N, M, K] oracle - realized
    energy_by_policy: np.ndarray   # [K] energy+restart cost across sites
    up_hours_by_policy: np.ndarray # [K] compute-hours across sites
    total_cost: float              # sum of TCO over the fleet
    total_up_hours: float
    # the feasible dispatch over the best-policy sites (None without a
    # dispatch_cfg) and the report rows it operated
    dispatch: Optional[object] = None
    dispatch_rows: Optional[np.ndarray] = None
    workload: Optional[object] = None    # filled by the workload slice


def oracle_reduction_grid(prices: torch.Tensor,
                          psi_nm: torch.Tensor) -> torch.Tensor:
    """Best theoretical CPC reduction per (market, system): the Eq. (26)
    maximum over each market's full PV set — `optimal_shutdown`'s
    ``cpc_reduction`` for the whole [N, M] grid, from one batched sort
    over [N, T]."""
    p = torch.sort(prices, dim=1, descending=True).values       # [N, T]
    n = p.shape[1]
    m = torch.arange(1, n, device=p.device)
    k = (torch.cumsum(p, 1)[:, :-1] / m) / p.mean(1, keepdim=True)
    red = cpc_reduction(psi_nm[:, :, None], k[:, None, :], (m / n)[None, None])
    return torch.clamp(red.amax(-1), min=0.0)


def dispatch_sites(grid, report: FleetReport,
                   best_policy: np.ndarray) -> np.ndarray:
    """Report-row index of each covered (market, system) cell's best
    policy, in canonical cube order — the site set the fleet dispatcher
    operates. Cube-ordered, so it is invariant to row permutations."""
    mi = report.market_idx.cpu().numpy()
    si = report.system_idx.cpu().numpy()
    pi = report.policy_idx.cpu().numpy()
    rows = []
    for n in range(grid.n_markets):
        for m in range(grid.n_systems):
            if best_policy[n, m] < 0:
                continue
            rows.append(int(np.flatnonzero(
                (mi == n) & (si == m) & (pi == best_policy[n, m]))[0]))
    return np.asarray(rows, np.int64)


def summarize(grid, report: FleetReport, *,
              dispatch_cfg: Optional[DispatchConfig] = None,
              workload=None) -> FleetSummary:
    """Aggregate a `FleetReport` over the scenario cube of ``grid`` (a
    `repro_torch.fleet.grid.ScenarioGrid`). Row order never matters: cells
    are addressed by the report's index columns.

    With ``dispatch_cfg``, the feasible cross-site dispatcher runs on the
    grid's device over one site per covered (market, system) cell — each
    operating its best swept policy — and the result lands in
    `FleetSummary.dispatch`, with the operated rows in
    `FleetSummary.dispatch_rows` (raises
    `repro_torch.dispatch.DispatchInfeasible` when the configured demand
    cannot be met; hard constraints are never clipped)."""
    if workload is not None:
        raise NotImplementedError("summarize(workload=...) needs the "
                                  "workload slice, which is not ported yet")
    n, m, k = grid.n_markets, grid.n_systems, grid.n_policies
    mi = report.market_idx.cpu().numpy()
    si = report.system_idx.cpu().numpy()
    pi = report.policy_idx.cpu().numpy()

    def cube(values):
        # non-finite rows (zero delivered compute) enter the cube as NaN
        # and drop out of the nan-aggregates
        c = np.full((n, m, k), np.nan, np.float64)
        v = values.cpu().numpy().astype(np.float64)
        c[mi, si, pi] = np.where(np.isfinite(v), v, np.nan)
        return c

    red = cube(report.cpc_reduction)
    cost = cube(report.energy_cost) + cube(report.restart_cost)
    hours = cube(report.up_hours)

    # (market, system) cells with no rows at all stay NaN / -1
    covered = ~np.all(np.isnan(red), axis=-1)
    best_policy = np.full((n, m), -1, np.int64)
    best_reduction = np.full((n, m), np.nan)
    if covered.any():
        best_policy[covered] = np.nanargmax(red[covered], axis=-1)
        best_reduction[covered] = np.nanmax(red[covered], axis=-1)

    # Psi per (market, system) from the per-row cost structure (Eq. 18)
    prices = grid.prices.cpu().numpy()
    g_mi = grid.market_idx.cpu().numpy()
    g_si = grid.system_idx.cpu().numpy()
    p_avg = prices.mean(axis=1)
    psi_rows = (grid.fixed.cpu().numpy()
                / (grid.period.cpu().numpy() * grid.power.cpu().numpy()
                   * p_avg[g_mi]))
    psi_nm = np.full((n, m), np.nan)
    psi_nm[g_mi, g_si] = psi_rows
    oracle = oracle_reduction_grid(
        grid.prices, torch.as_tensor(psi_nm, dtype=torch.float32,
                                     device=grid.prices.device))
    oracle = oracle.cpu().numpy()

    disp = None
    rows = None
    if dispatch_cfg is not None:
        rows = dispatch_sites(grid, report, best_policy)
        markets = g_mi[rows]
        systems = g_si[rows]
        names = tuple(f"{grid.market_names[n]}/{grid.system_names[m]}"
                      for n, m in zip(markets, systems)) \
            if grid.market_names and grid.system_names else ()
        dev = grid.prices.device
        r = torch.as_tensor(rows, device=dev)
        disp = dispatch(build_problem(
            grid.prices[grid.market_idx[r]], grid.p_on[r], grid.p_off[r],
            grid.off_level[r], grid.power[r], dispatch_cfg,
            fixed=grid.fixed[r], site_names=names, device=dev), device=dev)

    summary = FleetSummary(
        reduction=red,
        best_policy=best_policy,
        best_reduction=best_reduction,
        oracle_reduction=oracle,
        regret=oracle[:, :, None] - red,
        energy_by_policy=np.nansum(cost, axis=(0, 1)),
        up_hours_by_policy=np.nansum(hours, axis=(0, 1)),
        total_cost=float(np.nansum(cube(report.tco))),
        total_up_hours=float(np.nansum(hours)),
        dispatch=disp,
        dispatch_rows=rows,
    )
    if obs.enabled():
        obs.trace_event("fleet.summary", {
            "total_cost": summary.total_cost,
            "total_up_hours": summary.total_up_hours,
            "best_reduction": np.where(np.isfinite(best_reduction),
                                       best_reduction, None).tolist(),
            "top_regret": _top_regret(grid, summary, k=10)})
        obs.gauge("fleet.total_cost").set(summary.total_cost)
    return summary


def _top_regret(grid, summary: FleetSummary, k: int) -> list:
    """Worst-regret covered cube cells, largest first — the "where is
    this fleet leaving money on the table" rows of the operator digest
    (``fleet.summary`` event / `repro_torch.obs.report`)."""
    regret = summary.regret
    flat = regret.ravel()
    idx = np.flatnonzero(np.isfinite(flat))
    idx = idx[np.argsort(-flat[idx], kind="stable")][:k]
    rows = []
    for i in idx:
        n, m, p = np.unravel_index(i, regret.shape)
        rows.append({
            "market": (grid.market_names[n] if grid.market_names
                       else int(n)),
            "system": (grid.system_names[m] if grid.system_names
                       else int(m)),
            "policy": (grid.policy_names[p] if grid.policy_names
                       else int(p)),
            "regret": float(regret[n, m, p]),
            "reduction": float(summary.reduction[n, m, p])})
    return rows
