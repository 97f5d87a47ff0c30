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

Dispatch-aware tuning goes further than penalties: with a
`DispatchCoupling` (built by `dispatch_coupling_from_grid` from a
`repro_torch.dispatch.DispatchConfig`), the soft objective blends in the
fleet CPC of the *dispatched* load — the relaxed schedules offer soft
availability, the softmin water-fill (`repro_torch.kernels.soft_dispatch`,
hand-written CUDA kernels on the card) places the demand over it at the
same annealed temperature, and the gradient of the dispatched cost flows
back into every site's thresholds.

With a workload (``workload=`` and its ``workload_demand=`` profile) each
row also pays a soft work-ledger bill — SLO-priced backlog and VoLL-priced
drops of the mean demand served with the row's relaxed capacity
(`repro_torch.kernels.queue_scan.SoftLedger`, the ledger kernel pair on
the card), so tuning learns SLO-aware thresholds.

With ``axis_name`` (each rank of a `repro_torch.parallel.row_mesh`
holding a shard of the rows) the fleet aggregates reduce across ranks
(`repro_torch.parallel.axes.psum_id`), so every rank's loss carries the
coupled terms of the whole fleet: see `soft_objective`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.dispatch import (DispatchConfig, resolve_demand,
                                  segment_keys, segment_rank)
from repro_torch.fleet.engine import fleet_costs
from repro_torch.kernels.queue_scan import QUEUE_MWH_SCALE, queue_scan
from repro_torch.kernels.soft_dispatch import soft_dispatch, soft_shed
from repro_torch.kernels.soft_scan import soft_scan_parts
from repro_torch.parallel.axes import pmax, psum, psum_id


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


_FEAS_MARGIN_SCALE = 1.05  # the soft feasibility term defends demand plus
                           # 5%: the annealed capacity slightly overstates
                           # the hard schedules near the thresholds

_SHED_FLOOR_FRAC = 1e-3   # relief: the soft water-fill always dispatches
                          # at least this fraction of the demand (a ~zero
                          # effective demand parks the level off the
                          # sigmoid tails, and the implicit backward
                          # divides by the vanished occupancy slope)

_SUM_DTYPE = torch.float64   # sums over rows of the coupled terms: a
                             # sharded run's partial sums then add up to
                             # the single program's (see soft_dispatch_ratio)

_SEL_SCALE = 0.01   # per-cell candidate-selection temperature per unit
                    # tau: candidate rows of a (market, system) cell are
                    # blended by a softmax over their own soft CPC ratio
                    # at tau * this, converging to the hard re-scoring's
                    # per-cell argmin as tau anneals


class DispatchCoupling(NamedTuple):
    """Static (non-tuned) data of the soft fleet-dispatch term, on the
    tuner's device.

    The dispatched fleet deploys one policy per (market, system) cell, the
    physical site; candidate rows of a cell are blended by a soft
    selection (see `soft_dispatch_ratio`). ``keys``/``order`` are the
    host-precomputed `repro_torch.dispatch.segment_keys` sort the softmin
    water-fill reuses; ``cpc_ref`` is a constant O(fleet-CPC) normaliser
    that makes the dispatch term dimensionless. The float fields stay
    float64 as the host computed them; the objective casts them to its
    own dtype.
    """

    cell_id: torch.Tensor       # [B] int64 row -> covered cell (site)
    prices: torch.Tensor        # [C, T] site prices
    keys: torch.Tensor          # [T, 3C] segment keys
    order: torch.Tensor         # [T, 3C] int32 ascending key sort
    demand: torch.Tensor        # [T] fleet demand profile (MW)
    fixed: torch.Tensor         # [B] per-row fixed cost
    power: torch.Tensor         # [B] per-row site rating (MW)
    migrate_cost: torch.Tensor  # [] EUR per MW moved
    cpc_ref: torch.Tensor       # [] constant fleet-CPC normaliser


def dispatch_coupling_from_numpy(fields, device=None) -> DispatchCoupling:
    """A `DispatchCoupling` from arrays: a mapping of the field names, or
    any record with those attributes (the reference package's coupling
    converted with ``np.asarray``). Integers keep their meaning (cell_id
    int64, order int32), floats land as float64, on ``device`` (default
    the CPU)."""
    get = (fields.__getitem__ if isinstance(fields, dict)
           else lambda k: getattr(fields, k))
    dev = torch.device("cpu") if device is None else torch.device(device)
    out = {}
    for name in DispatchCoupling._fields:
        a = np.array(get(name))
        dtype = (torch.int64 if name == "cell_id" else
                 torch.int32 if name == "order" else torch.float64)
        out[name] = torch.as_tensor(a, device=dev).to(dtype)
    return DispatchCoupling(**out)


def dispatch_coupling_from_grid(grid, dcfg: DispatchConfig
                                ) -> DispatchCoupling:
    """Build the soft-dispatch coupling data for a `ScenarioGrid` under a
    `repro_torch.dispatch.DispatchConfig` (same demand semantics as
    `build_problem`: scalar, [T] profile, or ``demand_frac`` of the summed
    per-site ratings). Host numpy, as in the reference; the result lands on
    the grid's device."""
    _, inverse, counts = np.unique(cell_index(grid), return_inverse=True,
                                   return_counts=True)
    c = len(counts)
    t = grid.n_hours
    cell_market = np.zeros(c, np.int64)
    cell_market[inverse] = _np(grid.market_idx).astype(np.int64)
    prices_c = _np(grid.prices).astype(np.float64)[cell_market]  # [C, T]

    # per-site rating for the demand_frac default: candidate rows of a
    # cell share the site, so average their (normally equal) ratings
    w = 1.0 / counts[inverse]                                    # [B]
    power_c = np.zeros(c)
    np.add.at(power_c, inverse, w * _np(grid.power).astype(np.float64))

    demand = np.asarray(resolve_demand(dcfg, power_c, t), np.float64)
    keys = segment_keys(prices_c, float(dcfg.migrate_cost))
    order, _ = segment_rank(prices_c, float(dcfg.migrate_cost), keys=keys)
    fixed_c = np.zeros(c)
    np.add.at(fixed_c, inverse, w * _np(grid.fixed).astype(np.float64))
    cpc_ref = (fixed_c.sum()
               + float((demand * prices_c.mean(axis=0)).sum())) \
        / max(float(demand.sum()), 1e-9)
    return dispatch_coupling_from_numpy(dict(
        cell_id=inverse, prices=prices_c, keys=keys, order=order,
        demand=demand, fixed=_np(grid.fixed), power=_np(grid.power),
        migrate_cost=float(dcfg.migrate_cost), cpc_ref=cpc_ref),
        device=grid.prices.device)


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


def soft_dispatch_ratio(cap: torch.Tensor, row_ratio: torch.Tensor,
                        coupling: DispatchCoupling, tau, *,
                        min_dwell: int = 0, mw_scale: float = 0.05,
                        fused: bool = False,
                        axis_name: Optional[str] = None,
                        relief=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fleet-level dispatched-CPC ratio of the relaxed schedules.

    ``cap`` is the [B, T] soft capacity trajectory and ``row_ratio`` the
    per-row soft CPC ratio (both from `soft_costs`). Candidate rows are
    blended onto their sites by a per-cell softmax over ``-row_ratio`` at
    temperature ``tau * _SEL_SCALE``; the softmin water-fill
    (`repro_torch.kernels.soft_dispatch`) places the demand profile over
    the resulting soft availability at the same temperature as the scan
    relaxation; and the realised fleet cost (selected fixed + energy at
    the allocation + matched migration flow) is normalised by
    ``coupling.cpc_ref``. Returns ``(ratio, shortfall)``, ``shortfall``
    being the sum over hours of the squared relative availability deficit
    of the selected fleet against a 5%-margined demand.

    ``relief`` (a duck-typed `repro_torch.dispatch.Relief`) prices
    infeasibility instead: the smoothed shortfall (`soft_shed`) is shed
    from the demand the water-fill places, its cost enters the fleet
    numerator at the value-of-lost-load price, and the shortfall penalty
    is zero.

    The per-cell reductions are a [C, B] one-hot matrix applied by matrix
    products (deterministic on the card, unlike ``index_add_``'s float
    atomics). They, and the fixed-cost sum, accumulate in float64
    (``_SUM_DTYPE``) and round once, and the softmax shift carries no
    gradient: a sharded run's partial sums then add up to the single
    program's values, where float32 sums in another order differ in the
    last place and 200 annealed Adam steps grow that into other
    thresholds (`row_mesh_probe.py`).

    With ``axis_name`` each rank holds only its shard of the rows: the
    per-cell selection and the [C, T] availability / fixed-cost
    aggregates reduce across the ranks before the water-fill, so every
    rank dispatches the *whole* fleet and the term is the same on all of
    them. The softmax shift is the global per-cell max (`pmax`, no
    gradient: shift invariance makes it zero); its normaliser reduces
    with the raw `psum`, whose backward sums each rank's own rows'
    cotangents as a cell split across ranks needs; the aggregates reduce
    with `psum_id` (their cotangent is already replicated). The cells
    gain one dummy segment, ``C``, where padded rows (zero power and
    fixed cost) drop out of the fleet.
    """
    dtype, dev = cap.dtype, cap.device
    acc = _SUM_DTYPE
    c = coupling.prices.shape[0]
    cseg = c if axis_name is None else c + 1
    onehot = (coupling.cell_id[None, :]
              == torch.arange(cseg, device=dev)[:, None])         # [C, B]
    members = onehot.to(acc)

    # per-cell soft selection over candidates (stabilised softmax)
    tau_t = torch.as_tensor(tau, device=dev).to(dtype)
    score = -row_ratio / torch.clamp(tau_t * _SEL_SCALE, min=1e-12)
    peak = torch.where(onehot, score[None, :].detach(),
                       torch.tensor(float("-inf"), dtype=dtype,
                                    device=dev)).amax(dim=1)      # [C]
    if axis_name is not None:
        # a cell with no rows on any rank (the dummy without padding)
        # maxes to -inf: shift by 0 there
        peak = pmax(peak, axis_name)
        peak = torch.where(torch.isfinite(peak), peak,
                           torch.zeros_like(peak))
    expw = torch.exp(score - peak[coupling.cell_id]).to(acc)
    norm = members @ expw
    if axis_name is not None:
        norm = psum(norm, axis_name)
    sel = (expw / norm[coupling.cell_id]).to(dtype)               # [B]

    avail = (sel * coupling.power.to(dtype))[:, None] * cap
    avail_c = members @ avail.to(acc)                             # [C, T]
    fixed_fleet = torch.sum(sel.to(acc) * coupling.fixed.to(acc))
    if axis_name is not None:
        avail_c = psum_id(avail_c, axis_name)[:c]
        fixed_fleet = psum_id(fixed_fleet, axis_name)
    avail_c, fixed_fleet = avail_c.to(dtype), fixed_fleet.to(dtype)
    demand = coupling.demand.to(dtype)
    if relief is None:
        d_eff = demand
    else:
        # shed >= the exact shortfall, so the dispatched demand never
        # exceeds total availability; floor it so the water level stays on
        # the sigmoid tails (the VoLL charge keeps the unclamped shed)
        shed = soft_shed(torch.sum(avail_c, dim=0), demand, tau_t,
                         mw_scale=mw_scale)                       # [T]
        d_eff = torch.maximum(demand - shed, _SHED_FLOOR_FRAC * demand)
    alloc = soft_dispatch(avail_c, coupling.keys.to(dtype), coupling.order,
                          d_eff, tau=tau_t, min_dwell=min_dwell,
                          mw_scale=mw_scale, fused=fused)         # [C, T]

    energy = torch.sum(alloc * coupling.prices.to(dtype))
    prev = torch.cat([torch.zeros_like(alloc[:, :1]), alloc[:, :-1]], dim=1)
    delta = alloc - prev
    inflow = torch.sum(torch.relu(delta), dim=0)                  # [T]
    outflow = torch.sum(torch.relu(-delta), dim=0)
    # matched cross-site flow min(in, out): demand ramps are not moves
    moved = 0.5 * (inflow + outflow - torch.abs(inflow - outflow))
    migration = coupling.migrate_cost.to(dtype) * torch.sum(moved)
    delivered = torch.clamp(torch.sum(alloc), min=1e-9)
    cpc_ref = coupling.cpc_ref.to(dtype)
    if relief is None:
        cpc_fleet = (fixed_fleet + energy + migration) / delivered
        short = torch.relu(_FEAS_MARGIN_SCALE * demand
                           - torch.sum(avail_c, dim=0)) \
            / torch.clamp(demand, min=1e-9)
        return cpc_fleet / cpc_ref, torch.sum(short ** 2)
    shed_cost = float(relief.voll_eur_mwh) * torch.sum(shed)
    cpc_fleet = (fixed_fleet + energy + migration + shed_cost) / delivered
    return cpc_fleet / cpc_ref, torch.zeros((), dtype=dtype, device=dev)


def soft_objective(raw: PolicyParams, problem: TuneProblem, tau, *,
                   power_cap_mw: Optional[float] = None,
                   min_up_hours: Optional[float] = None,
                   penalty_weight: float = 10.0,
                   dispatch: Optional[DispatchCoupling] = None,
                   dispatch_blend: float = 0.5,
                   dispatch_min_dwell: int = 0,
                   dispatch_mw_scale: float = 0.05,
                   dispatch_fused: bool = False,
                   relief=None,
                   workload=None, workload_demand=None,
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

    With ``workload`` (a `repro_torch.workload.Workload`) and
    ``workload_demand`` (its [T] mean demand profile, MW), each row also
    pays a soft work-ledger bill — SLO-rate-priced backlog plus
    VoLL-priced drops of the profile served with the row's relaxed
    capacity (`SoftLedger`) at the co-annealed MWh temperature ``tau *
    QUEUE_MWH_SCALE`` — normalised by its always-on bill so tuning learns
    SLO-aware shutdown thresholds. The term is per-row separable (each
    row serves the profile on its own), so the chunked tuner's per-row
    contract holds; ``aux["workload"]`` carries the per-row term (zeros
    when off).

    With ``dispatch`` (a `DispatchCoupling`) the isolated-site term is
    blended with the fleet-level dispatched-CPC ratio of the relaxed
    schedules (`soft_dispatch_ratio`, co-annealed at the same ``tau``):

        loss = (1 - blend) mean_b ratio_b + blend ratio_fleet + ...

    plus an availability-shortfall penalty under ``penalty_weight``
    (``relief`` replaces it with priced soft shed). ``dispatch_fused``
    differentiates the water-fill through its fused VJP (the CUDA kernels
    on the card); ``False`` is autograd through the plain per-hour
    operations, which only the CPU runs. The dispatch term couples every
    row through the shared water level, so the objective is then not
    batch-separable (the chunked tuner refuses it).

    ``reduction="sum"`` (the tuner's setting) sums the per-row ratios
    instead of averaging and scales the coupling penalties (and the
    dispatch term) by B to compensate: without coupling terms every
    per-row gradient is then independent of which other rows share the
    batch, which is what lets the chunked tuner reproduce the single
    program row for row. ``aux["base"]`` / ``aux["coupled"]`` split the
    loss into its separable and fleet-coupled parts.

    With ``axis_name`` (each rank holding a shard of the rows of a
    `repro_torch.parallel.row_mesh`) the fleet aggregates — total
    instantaneous draw, aggregate up-hours, and everything inside
    `soft_dispatch_ratio` — reduce across the ranks through `psum_id`
    before the penalties are formed, so each rank's loss carries the
    coupled terms of the whole fleet (the same on every rank) while the
    separable ratio sum stays the rank's own. `psum_id`'s backward is the
    identity, so each rank's gradient of its loss equals the single
    program's per-row gradient. ``scale_rows`` then fixes the coupled
    terms' B-scale at the real global row count (shard widths and padding
    must not change the objective). The global loss is the sum over
    ranks of ``aux["base"]`` plus one ``aux["coupled"]``.
    """
    costs, draw, cap = soft_costs(raw, problem, tau, fused=fused,
                                  block_t=block_t, row_prices=row_prices)
    ratio = costs.cpc / costs.cpc_ao
    loss = torch.sum(ratio) if reduction == "sum" else torch.mean(ratio)
    wl_ratio = torch.zeros_like(ratio)
    if workload is not None and workload_demand is not None:
        # the profile through the soft ledger against each row's relaxed
        # capacity, its backlog and drops priced and normalised by the
        # row's always-on bill (cpc_ao * period = F + E_AO): dimensionless
        # like ``ratio``, and per-row separable
        dtp = ratio.dtype
        dt = problem.period.to(dtp) / cap.shape[1]                  # [B]
        cap_mwh = (problem.power.to(dtp) * dt)[:, None] * cap
        dem = dt[:, None] * torch.as_tensor(workload_demand, dtype=dtp,
                                            device=cap.device)[None, :]
        tau_mwh = (tau.to(dtp) if isinstance(tau, torch.Tensor)
                   else torch.tensor(float(tau), dtype=dtp,
                                     device=cap.device)) * QUEUE_MWH_SCALE
        led = queue_scan(dem, cap_mwh, deadline=int(workload.deadline_h),
                         bound=float(workload.queue_bound_mwh), tau=tau_mwh)
        wl_cost = (float(workload.slo_penalty_eur_mwh) * led.backlog
                   + float(workload.relief.voll_eur_mwh) * led.dropped)  # [B]
        wl_ratio = wl_cost / (costs.cpc_ao * problem.period.to(dtp))
        loss = loss + (torch.sum(wl_ratio) if reduction == "sum"
                       else torch.mean(wl_ratio))
    rows = scale_rows if scale_rows is not None else ratio.shape[0]
    scale = rows if reduction == "sum" else 1.0

    # coupling terms weight each row by 1/|cell| so a K-policy grid
    # charges each physical site once (per-site candidate mean)
    penalty = torch.zeros((), dtype=ratio.dtype, device=ratio.device)
    w = problem.site_weight.to(ratio.dtype)
    if power_cap_mw is not None:
        # sums over rows in _SUM_DTYPE, rounded once
        fleet_mw = torch.sum(((problem.power * w)[:, None] * draw).to(
            _SUM_DTYPE), dim=0)                                     # [T]
        if axis_name is not None:
            fleet_mw = psum_id(fleet_mw, axis_name)
        fleet_mw = fleet_mw.to(ratio.dtype)
        excess = torch.relu(fleet_mw - power_cap_mw) / power_cap_mw
        penalty = penalty + torch.mean(excess ** 2)
    if min_up_hours is not None:
        total_up = torch.sum((w * costs.up_hours).to(_SUM_DTYPE))
        if axis_name is not None:
            total_up = psum_id(total_up, axis_name)
        total_up = total_up.to(ratio.dtype)
        deficit = torch.relu(min_up_hours - total_up) / min_up_hours
        penalty = penalty + deficit ** 2

    zero = torch.zeros((), dtype=ratio.dtype, device=ratio.device)
    dratio = zero
    base = loss
    coupled = zero
    if dispatch is not None:
        dratio, shortfall = soft_dispatch_ratio(
            cap, ratio, dispatch, tau, min_dwell=dispatch_min_dwell,
            mw_scale=dispatch_mw_scale, fused=dispatch_fused,
            axis_name=axis_name, relief=relief)
        base = (1.0 - dispatch_blend) * loss
        coupled = dispatch_blend * scale * dratio
        loss = base + coupled
        penalty = penalty + shortfall
    coupled = coupled + scale * penalty_weight * penalty
    loss = loss + scale * penalty_weight * penalty
    aux = {"ratio": ratio, "cpc": costs.cpc, "up_hours": costs.up_hours,
           "penalty": penalty, "dispatch_ratio": dratio, "base": base,
           "coupled": coupled, "workload": wl_ratio}
    return loss, aux
