"""Differentiable per-row CPC/TCO objectives over a scenario grid.

The fleet engine *evaluates* policies; this module makes them
*parameters*. Each scenario row gets three unconstrained raw variables
(`PolicyParams`) that deterministic transforms map onto the feasible
policy set:

    p_off     = raw_off                           (price units, free)
    p_on      = p_off - softplus(raw_gap)         (p_on <= p_off always)
    off_level = (1 - 1e-6) sigmoid(raw_lvl)       (in [0, 1) always)

so gradient steps in raw space never produce an inverted hysteresis band
or an infeasible capacity level.

`soft_objective` prices every row with the temperature-``tau`` relaxed
scan (`repro_torch.kernels.soft_scan`) and the *same* cost assembly the
hard backtest uses (`repro_torch.fleet.engine.fleet_costs`), returning
the dimensionless CPC ratio (CPC/CPC_AO, Eq. 28's measured analogue)
plus optional fleet-coupling penalties:

  * ``power_cap_mw`` — soft cap on total instantaneous fleet draw;
  * ``min_up_hours`` — minimum aggregate compute delivered by the fleet.

Both penalties are quadratic in the *relative* violation and weight each
row by 1 / |its (market, system) cell|, so a grid carrying K candidate
policies per site charges the site's mean once rather than K copies.

Later slices: the dispatch-aware term (``dispatch=``, the reference's
`DispatchCoupling`) comes with dispatch-aware tuning, ``workload=`` with
the workload slice, and ``axis_name=`` / ``scale_rows=`` (sharded coupled
objectives) with the multi-GPU slice; each raises `NotImplementedError`
until then.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.fleet.engine import fleet_costs
from repro_torch.kernels.soft_scan import soft_scan_parts


class PolicyParams(NamedTuple):
    """Unconstrained per-row policy parameters (all [B])."""

    raw_off: torch.Tensor   # shutdown threshold, price units (identity)
    raw_gap: torch.Tensor   # softplus -> hysteresis band width p_off - p_on
    raw_lvl: torch.Tensor   # sigmoid -> off-capacity level


class PhysicalPolicy(NamedTuple):
    """Feasible policy variables (all [B]): p_on <= p_off, lvl in [0, 1)."""

    p_on: torch.Tensor
    p_off: torch.Tensor
    off_level: torch.Tensor


class TuneProblem(NamedTuple):
    """The static (non-tuned) data of a tuning run (from a ScenarioGrid).

    ``prices`` stays [N, T] shared across rows, like `ScenarioGrid.prices`;
    `row_prices` gathers the per-row [B, T] block. Everything else is [B].
    ``idle_frac`` and the restart costs stay fixed (hardware, not policy).
    ``site_weight`` is 1 / (number of rows sharing the row's (market,
    system) cell), so coupling penalties charge each physical site once.
    """

    prices: torch.Tensor        # [N, T]
    market_idx: torch.Tensor    # [B] int64 row -> market
    price_sum: torch.Tensor     # [B] sum_t p_t of the row's market
    fixed: torch.Tensor
    power: torch.Tensor
    period: torch.Tensor
    idle_frac: torch.Tensor
    restart_energy_mwh: torch.Tensor
    restart_time_h: torch.Tensor
    site_weight: torch.Tensor

    def row_prices(self) -> torch.Tensor:
        """[B, T] per-row gather of the market prices."""
        return self.prices[self.market_idx]


_DISPATCH_SLICE = ("dispatch-aware tuning comes to the port with its own "
                   "slice (ROADMAP queue 1 item 8)")


def dispatch_coupling_from_grid(grid, dcfg):
    """Not yet ported (ROADMAP queue 1 item 8)."""
    raise NotImplementedError(_DISPATCH_SLICE)


def soft_dispatch_ratio(*args, **kwargs):
    """Not yet ported (ROADMAP queue 1 item 8)."""
    raise NotImplementedError(_DISPATCH_SLICE)


_LVL_SCALE = 1.0 - 1e-6   # keeps off_level < 1 even when the float32
                          # sigmoid saturates to exactly 1.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference evaluates it (logaddexp(x, 0)),
    from position-independent CPU functions (see `ref._sigmoid`)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def transform(raw: PolicyParams) -> PhysicalPolicy:
    """Raw -> feasible policy variables (smooth, surjective onto the
    interior of the feasible set)."""
    p_off = raw.raw_off
    p_on = p_off - _softplus(raw.raw_gap)
    return PhysicalPolicy(p_on=p_on, p_off=p_off,
                          off_level=_LVL_SCALE
                          * (1.0 / (1.0 + torch.exp(-raw.raw_lvl))))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def inverse_transform(phys: PhysicalPolicy, *, gap_min: float = 1e-3,
                      lvl_eps: float = 1e-4, device=None) -> PolicyParams:
    """Feasible -> raw, the right inverse of `transform` (used to seed
    tuning at a swept `PolicySpec`), computed in float64 numpy and rounded
    once to float32. Degenerate values are nudged inside the open feasible
    set: a zero hysteresis gap to ``gap_min``, an off_level of exactly 0
    (or 1) to ``lvl_eps`` from the boundary. The result lands on
    ``device`` (default: the device of ``phys.p_off``, else the CPU)."""
    if device is None:
        device = phys.p_off.device if isinstance(phys.p_off, torch.Tensor) \
            else "cpu"
    p_off = _np(phys.p_off).astype(np.float64)
    gap = np.maximum(p_off - _np(phys.p_on).astype(np.float64), gap_min)
    # stable softplus^-1: log(e^y - 1) = y + log1p(-e^-y)
    raw_gap = np.where(gap > 20.0, gap, np.log(np.expm1(gap)))
    raw_gap = raw_gap + np.where(gap > 20.0, np.log1p(-np.exp(-gap)), 0.0)
    lvl = np.clip(_np(phys.off_level).astype(np.float64),
                  lvl_eps, 1.0 - lvl_eps)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return PolicyParams(raw_off=f32(p_off), raw_gap=f32(raw_gap),
                        raw_lvl=f32(np.log(lvl / (1.0 - lvl))))


def cell_index(grid) -> np.ndarray:
    """[B] int64 key of each row's (market, system) cell — the physical
    site a row's candidate policy would run at."""
    mi = _np(grid.market_idx).astype(np.int64)
    si = _np(grid.system_idx).astype(np.int64)
    return mi * max(grid.n_systems, 1) + si


def problem_from_grid(grid) -> TuneProblem:
    """Extract the static tuning data from a `ScenarioGrid` (on the
    grid's device)."""
    _, inverse, counts = np.unique(cell_index(grid), return_inverse=True,
                                   return_counts=True)
    return TuneProblem(
        prices=grid.prices, market_idx=grid.market_idx,
        price_sum=torch.sum(grid.prices, dim=1)[grid.market_idx],
        fixed=grid.fixed, power=grid.power, period=grid.period,
        idle_frac=grid.idle_frac,
        restart_energy_mwh=grid.restart_energy_mwh,
        restart_time_h=grid.restart_time_h,
        site_weight=torch.as_tensor(1.0 / counts[inverse],
                                    dtype=torch.float32,
                                    device=grid.prices.device))


def init_from_grid(grid) -> PolicyParams:
    """Seed raw parameters at the grid's own swept policies.

    Always-on rows (p_off = +inf) are seeded at their market's maximum
    price — operationally identical (no sample exceeds it) but finite, so
    gradients can pull the threshold into the price range.
    """
    p_off = _np(grid.p_off).astype(np.float64)
    p_on = _np(grid.p_on).astype(np.float64)
    p_max = _np(torch.max(grid.prices, dim=1).values).astype(
        np.float64)[_np(grid.market_idx)]
    inf = ~np.isfinite(p_off)
    p_off = np.where(inf, p_max, p_off)
    p_on = np.where(inf, p_max, p_on)
    return inverse_transform(
        PhysicalPolicy(p_on=p_on, p_off=p_off,
                       off_level=_np(grid.off_level)),
        device=grid.prices.device)


def soft_costs(raw: PolicyParams, problem: TuneProblem, tau, *,
               fused: bool = True, block_t: int = 256,
               row_prices: Optional[torch.Tensor] = None):
    """(FleetCosts, per-sample draw [B, T], capacity [B, T]) of the
    relaxed scan at ``tau`` — the engine's cost assembly over the soft
    sums. ``fused`` selects the hand-written forward/backward
    (`repro_torch.kernels.soft_scan_vjp`) over autograd through the
    doubling scan. ``row_prices`` passes the [B, T] gather when the
    caller already holds it (the tuner gathers once per loop)."""
    phys = transform(raw)
    p = problem.row_prices() if row_prices is None else row_prices
    scan, draw, cap = soft_scan_parts(p, phys.p_on, phys.p_off,
                                      phys.off_level, problem.idle_frac,
                                      tau=tau, fused=fused,
                                      block_t=block_t)
    costs = fleet_costs(
        scan, price_sum=problem.price_sum, fixed=problem.fixed,
        power=problem.power, period=problem.period,
        restart_energy_mwh=problem.restart_energy_mwh,
        restart_time_h=problem.restart_time_h, n_samples=p.shape[1])
    return costs, draw, cap


def soft_objective(raw: PolicyParams, problem: TuneProblem, tau, *,
                   power_cap_mw: Optional[float] = None,
                   min_up_hours: Optional[float] = None,
                   penalty_weight: float = 10.0,
                   dispatch=None,
                   workload=None,
                   fused: bool = True, block_t: int = 256,
                   reduction: str = "mean",
                   axis_name: Optional[str] = None,
                   scale_rows: Optional[int] = None,
                   row_prices: Optional[torch.Tensor] = None):
    """Scalar tuning loss at temperature ``tau`` (lower is better).

    loss = mean_b CPC_b / CPC_AO_b  (+ fleet-coupling penalties)

    The CPC ratio is dimensionless (Eq. 28), so rows with very different
    absolute costs contribute comparably and one learning rate serves the
    whole grid. Returns ``(loss, aux)`` with per-row diagnostics.

    ``reduction="sum"`` (the tuner's setting) sums the per-row ratios
    instead of averaging and scales the coupling penalties by B to
    compensate: without coupling terms every per-row gradient is then
    independent of which other rows share the batch, which is what lets
    the chunked tuner reproduce the single program row for row.
    ``dispatch``, ``workload``, ``axis_name`` and ``scale_rows`` come with
    later slices and raise `NotImplementedError`.
    """
    if dispatch is not None:
        raise NotImplementedError(_DISPATCH_SLICE)
    if workload is not None:
        raise NotImplementedError(
            "soft_objective(workload=) comes to the port with the workload "
            "slice (ROADMAP queue 1 item 12)")
    if axis_name is not None or scale_rows is not None:
        raise NotImplementedError(
            "soft_objective(axis_name=, scale_rows=): sharded coupled "
            "objectives come to the port with torch.distributed (ROADMAP "
            "queue 1 item 13)")
    costs, draw, _ = soft_costs(raw, problem, tau, fused=fused,
                                block_t=block_t, row_prices=row_prices)
    ratio = costs.cpc / costs.cpc_ao
    loss = torch.sum(ratio) if reduction == "sum" else torch.mean(ratio)
    scale = ratio.shape[0] if reduction == "sum" else 1.0

    # coupling terms weight each row by 1/|cell| so a K-policy grid
    # charges each physical site once (per-site candidate mean)
    penalty = torch.zeros((), dtype=ratio.dtype, device=ratio.device)
    w = problem.site_weight.to(ratio.dtype)
    if power_cap_mw is not None:
        fleet_mw = torch.sum((problem.power * w)[:, None] * draw,
                             dim=0)                                 # [T]
        excess = torch.relu(fleet_mw - power_cap_mw) / power_cap_mw
        penalty = penalty + torch.mean(excess ** 2)
    if min_up_hours is not None:
        total_up = torch.sum(w * costs.up_hours)
        deficit = torch.relu(min_up_hours - total_up) / min_up_hours
        penalty = penalty + deficit ** 2

    zero = torch.zeros((), dtype=ratio.dtype, device=ratio.device)
    coupled = scale * penalty_weight * penalty
    aux = {"ratio": ratio, "cpc": costs.cpc, "up_hours": costs.up_hours,
           "penalty": penalty, "dispatch_ratio": zero, "base": loss,
           "coupled": coupled, "workload": torch.zeros_like(ratio)}
    return loss + coupled, aux
