"""Feasible cross-site dispatch: hard constraints, not penalty terms.

Every hour, a fleet-wide compute demand ``D_t`` (MW) is placed across S
sites. Site s offers ``avail[s, t]`` MW (its policy's on/off state times
its rating — `repro_torch.dispatch.schedule`). Placement is a greedy
water-fill over price-sorted capacity segments: load already at a site
is priced at ``p - migrate_cost`` (leaving must pay the one-time
migration fee), load placed less than ``min_dwell_h`` hours ago is locked
(ranked below everything), and fresh capacity pays the plain market
price. With ``migrate_cost = 0`` and ``min_dwell_h = 0`` this reduces
exactly to filling the cheapest available sites each hour.

Infeasibility is loud: demand above the power cap, demand above fleet
availability in any hour, or a total demand below the compute floor
raises `DispatchInfeasible` — hard constraints are never silently
clipped — unless a `Relief` prices the unmet demand as shed.

The segment sort and the accounting are host numpy, as in the reference
(`repro.dispatch.allocate`, whose numpy helpers are copied here
verbatim). The hot loop is `repro_torch.kernels.dispatch_scan`: the
hand-written CUDA kernel on the card, the plain
`repro_torch.kernels.ref.dispatch_ref` on the CPU, bit for bit equal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dispatch.schedule import capacity_series
from repro_torch.execution import ExecutionPlan
from repro_torch.kernels.dispatch_scan import dispatch_scan

_MOVE_TOL = 1e-6     # MW below which an hour's net move is not an event
_NEAR_FRAC = 0.05    # capacity slack below this fraction of demand is
                     # "near-infeasible" in the telemetry margin count


class DispatchInfeasible(ValueError):
    """A hard dispatch constraint cannot be met (never silently clipped)."""


class Relief(NamedTuple):
    """Graceful-degradation pricing for infeasible dispatch hours.

    With a ``Relief`` attached (``DispatchConfig.relief`` /
    ``DispatchProblem.relief``), an hour whose demand exceeds fleet
    availability (or the power cap) no longer raises
    `DispatchInfeasible`: every available MW is still placed by the same
    water-fill, and the unmet remainder is *shed* at the value-of-lost-
    load price ``voll_eur_mwh`` (default 3000 EUR/MWh, the order of
    European market price caps). Hashable.
    """

    voll_eur_mwh: float = 3000.0


class _DispatchConfigFields(NamedTuple):
    demand_mw: Optional[Union[float, tuple]] = None
    demand_frac: float = 0.5
    power_cap_mw: float = float("inf")
    migrate_cost: float = 0.0
    min_dwell_h: int = 0
    compute_floor_mwh: float = 0.0
    plan: Optional[ExecutionPlan] = None
    relief: Optional[Relief] = None
    workload: Optional[object] = None


class DispatchConfig(_DispatchConfigFields):
    """Operator-side dispatch constraints (hashable — nested in
    `repro_torch.execution.Coupling` as the re-scoring config).

    ``demand_mw`` is the fleet-wide compute demand: a scalar (same MW
    every hour) or a length-[T] profile — pass a tuple (e.g. from
    `diurnal_demand`) so the config stays hashable; any other length
    raises in `build_problem`. When None it defaults to ``demand_frac``
    of the summed site ratings. ``migrate_cost`` is EUR per MW moved
    between sites (charged on the matched in/out flow, and the retention
    premium of the greedy fill). ``min_dwell_h`` locks newly placed load
    for that many hours. ``compute_floor_mwh`` is the aggregate compute
    the fleet must deliver over the period. ``plan`` pins the execution
    layout `dispatch` solves under. ``relief`` (a `Relief`) converts
    infeasible hours into priced shed instead of raising. ``workload``
    (demand derived from a request-arrival model) comes to the port with
    the workload slice and raises `NotImplementedError` until then.
    """

    __slots__ = ()

    def __new__(cls, *args, **kwargs):
        return _no_workload(super().__new__(cls, *args, **kwargs))


def _no_workload(cfg):
    if getattr(cfg, "workload", None) is not None:
        raise NotImplementedError(
            "DispatchConfig(workload=) comes to the port with the "
            "workload slice (ROADMAP queue 1)")
    return cfg


class DispatchProblem(NamedTuple):
    """One concrete dispatch instance (all arrays host-side numpy)."""

    prices: np.ndarray      # [S, T] EUR/MWh
    avail_mw: np.ndarray    # [S, T] available MW (schedule x rating)
    demand_mw: np.ndarray   # [T] fleet demand
    power_cap_mw: float
    migrate_cost: float     # EUR per MW moved
    min_dwell_h: int
    compute_floor_mwh: float
    fixed_cost: float       # summed per-period fixed cost of the sites
    site_names: tuple = ()
    # precomputed segment sort data ([T, 3S] int32 each, from
    # `segment_rank`); None -> computed on first dispatch. The port's
    # allocation reads only ``rank``; ``order`` is kept as the reference
    # keeps it
    order: Optional[np.ndarray] = None
    rank: Optional[np.ndarray] = None
    relief: Optional[Relief] = None   # None -> infeasibility raises


class DispatchResult(NamedTuple):
    """Feasible dispatch outcome (the `FleetSummary.dispatch` block)."""

    alloc_mw: np.ndarray      # [S, T] hourly allocation
    cpc: float                # (fixed + energy + migration) / delivered
    energy_cost: float        # sum_t sum_s alloc * price
    migration_cost: float     # migrate_cost x MW moved
    migration_mw: float       # total MW moved between sites
    n_migrations: int         # hours with a net cross-site move
    delivered_mwh: float
    site_mwh: np.ndarray      # [S] compute delivered per site
    slack_power_mw: float     # min_t (power cap - demand)
    slack_capacity_mw: float  # min_t (fleet availability - demand)
    slack_floor_mwh: float    # delivered - compute floor
    # relief accounting (all zero when relief is None / nothing shed)
    shed_mwh: float = 0.0     # demand the fleet could not serve
    shed_cost: float = 0.0    # shed_mwh x value of lost load
    n_shed_hours: int = 0     # hours with shed above _MOVE_TOL


def segment_keys(prices: np.ndarray, migrate_cost: float) -> np.ndarray:
    """[T, 3S] float64 sort keys of every site's three capacity segments.

    Locked segments sit below everything (offset by more than the price
    span, price-ordered among themselves), retained load is priced at
    ``p - migrate_cost``, fresh capacity at ``p``. Keys depend only on
    prices and the premium — never on the running state — which is what
    lets the kernel run sort-free.
    """
    p = np.asarray(prices, np.float64).T                      # [T, S]
    span = float(np.max(p) - np.min(p)) + abs(migrate_cost) + 1.0
    return np.concatenate([p - span, p - migrate_cost, p], axis=1)


def segment_rank(prices: np.ndarray, migrate_cost: float, *,
                 keys: Optional[np.ndarray] = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Ascending sort permutation and rank ([T, 3S] int32 each) of the
    `segment_keys` (float64, so a class offset cannot swallow price
    differences). A caller that already computed the keys passes them.

    Ties (equal keys) resolve by segment position — stable argsort — so
    a site's retained load wins over its own fresh capacity at
    ``migrate_cost = 0``; cross-site ties follow site order.
    """
    if keys is None:
        keys = segment_keys(prices, migrate_cost)
    order = np.argsort(keys, axis=1, kind="stable").astype(np.int32)
    rank = np.empty_like(order)
    np.put_along_axis(rank, order,
                      np.broadcast_to(np.arange(order.shape[1],
                                                dtype=np.int32),
                                      order.shape), axis=1)
    return order, rank


def diurnal_demand(t: int, *, base_mw: float, swing_mw: float,
                   peak_hour: float = 17.0) -> tuple:
    """Length-``t`` diurnal demand profile as a hashable tuple (so it can
    sit in `DispatchConfig.demand_mw`): ``base + swing * cos(2 pi (h -
    peak) / 24)`` — load peaks at ``peak_hour`` and bottoms out 12 h
    later.
    """
    if swing_mw < 0 or swing_mw > base_mw:
        raise ValueError("diurnal_demand needs 0 <= swing_mw <= base_mw "
                         "(negative demand is not dispatchable)")
    h = np.arange(t, dtype=np.float64) % 24.0
    prof = base_mw + swing_mw * np.cos((h - peak_hour) * (2.0 * np.pi / 24.0))
    return tuple(float(x) for x in prof)


def resolve_demand(cfg: DispatchConfig, power: np.ndarray,
                   t: int) -> np.ndarray:
    """[T] demand profile of a `DispatchConfig`: a scalar ``demand_mw``
    broadcasts, a sequence must have exactly ``t`` entries (anything else
    raises — a profile built for the wrong horizon is a bug, not a
    broadcast), and None defaults to ``demand_frac`` of the summed site
    ratings."""
    _no_workload(cfg)
    if cfg.demand_mw is None:
        demand = np.asarray(cfg.demand_frac
                            * float(np.asarray(power, np.float64).sum()))
    else:
        demand = np.asarray(cfg.demand_mw, np.float64)
    if demand.ndim == 0:
        return np.broadcast_to(demand.astype(np.float32), (t,))
    if demand.shape != (t,):
        raise ValueError(
            f"DispatchConfig.demand_mw profile has {demand.shape[0]} "
            f"entries but the problem spans {t} hours — pass a scalar "
            "or a length-T profile (e.g. repro_torch.dispatch."
            "diurnal_demand)")
    return demand.astype(np.float32)


def _numpy(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def build_problem(prices, p_on, p_off, off_level, power,
                  cfg: DispatchConfig, *, fixed=None,
                  site_names: Sequence[str] = (),
                  device: DeviceLike = None) -> DispatchProblem:
    """Assemble a `DispatchProblem` from per-site policy variables.

    prices: [S, T]; p_on/p_off/off_level/power (MW rating): [S] (numpy
    arrays or tensors). Availability is each site's materialised shutdown
    schedule (`capacity_series`, run on ``device``) times its rating; the
    problem holds host numpy arrays, as the reference's does.
    """
    dev = resolve_device(device)
    prices = _numpy(prices, np.float32)
    s, t = prices.shape
    power = np.broadcast_to(_numpy(power, np.float32), (s,))
    cap = capacity_series(
        *(torch.tensor(_numpy(v, np.float32), device=dev)
          for v in (prices, p_on, p_off, off_level))).cpu().numpy()
    order, rank = segment_rank(prices, float(cfg.migrate_cost))
    return DispatchProblem(
        prices=prices,
        avail_mw=power[:, None] * cap,
        demand_mw=resolve_demand(cfg, power, t),
        power_cap_mw=float(cfg.power_cap_mw),
        migrate_cost=float(cfg.migrate_cost),
        min_dwell_h=int(cfg.min_dwell_h),
        compute_floor_mwh=float(cfg.compute_floor_mwh),
        fixed_cost=float(np.sum(_numpy(fixed)))
        if fixed is not None else 0.0,
        site_names=tuple(site_names),
        order=order, rank=rank, relief=cfg.relief)


def _infeasible(reason: str, **detail) -> DispatchInfeasible:
    obs.trace_event("dispatch.infeasible", {"reason": reason, **detail})
    obs.counter("dispatch.infeasible").inc()
    return DispatchInfeasible(reason)


def _check_feasible(problem: DispatchProblem) -> None:
    d = np.asarray(problem.demand_mw, np.float64)
    cap = problem.power_cap_mw
    if float(d.max()) > cap:
        worst = int(d.argmax())
        raise _infeasible(
            f"fleet power cap {cap:.3f} MW is below the demand "
            f"{d.max():.3f} MW (first binding hour {worst}) — the cap "
            "can never be met by reallocating; raise it or shed demand",
            constraint="power_cap", hour=worst)
    avail = np.asarray(problem.avail_mw, np.float64).sum(axis=0)   # [T]
    short = d - avail
    if float(short.max()) > 1e-6:
        worst = int(short.argmax())
        n_bad = int((short > 1e-6).sum())
        raise _infeasible(
            f"fleet availability covers demand in only {len(d) - n_bad}/"
            f"{len(d)} hours: worst hour {worst} offers {avail[worst]:.3f} "
            f"MW against {d[worst]:.3f} MW demanded — site schedules shut "
            "down too much capacity for this demand",
            constraint="capacity", hour=worst, n_short_hours=n_bad)
    if float(d.sum()) < problem.compute_floor_mwh:
        raise _infeasible(
            f"aggregate compute floor {problem.compute_floor_mwh:.3f} MWh "
            f"exceeds the total demanded {d.sum():.3f} MWh — the floor "
            "cannot be reached even at full delivery",
            constraint="compute_floor")


def dispatch(problem: DispatchProblem, *,
             plan: Optional[ExecutionPlan] = None,
             device: DeviceLike = None) -> DispatchResult:
    """Solve one dispatch instance on ``device``; raises
    `DispatchInfeasible` when a hard constraint cannot hold.

    The allocation runs through `repro_torch.kernels.dispatch_scan`: the
    CUDA kernel on the card, the plain `dispatch_ref` on the CPU.

    ``plan``: chunked and sharded plans raise — a dispatch instance has
    no row axis to split (its sites are coupled through the shared water
    level every hour). ``single`` and ``auto`` both run the kernel on the
    card: the kernel is one program (the reference's ``single`` selects
    its jitted sequential path instead).
    """
    if plan is not None and plan.mode in ("chunked", "sharded"):
        raise ValueError(
            f"dispatch: ExecutionPlan(mode={plan.mode!r}) has no meaning "
            "here — a dispatch instance has no row axis to chunk or shard "
            "(sites are coupled through the shared water level); use "
            "mode='single' or 'auto'")
    dev = resolve_device(device)
    if problem.relief is None:
        demand = problem.demand_mw
        _check_feasible(problem)
    else:
        # graceful degradation: cap demand at the power ceiling (a
        # bitwise no-op whenever the cap is slack) and let the
        # width-clipped fill place every available MW; the remainder is
        # priced as shed by `summarize_alloc` against the original demand
        demand = np.minimum(np.asarray(problem.demand_mw),
                            problem.power_cap_mw
                            ).astype(problem.demand_mw.dtype)
    rank = problem.rank if problem.rank is not None \
        else segment_rank(problem.prices, problem.migrate_cost)[1]

    def on_dev(x, dtype):
        # resolve_demand may hand over a stride-0 broadcast view
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=dev)

    alloc = dispatch_scan(on_dev(problem.avail_mw, np.float32),
                          on_dev(rank, np.int32), on_dev(demand, np.float32),
                          min_dwell=problem.min_dwell_h)
    return summarize_alloc(problem, alloc.cpu().numpy())


def summarize_alloc(problem: DispatchProblem,
                    alloc: np.ndarray) -> DispatchResult:
    """Cost/migration/slack accounting over a [S, T] allocation (shared by
    both scan paths, so identical allocations give identical stats).

    Hour 0 places the fleet's load from empty; migration counts only the
    matched in/out flow (load that left one site and arrived at another),
    so demand ramps are not billed as moves. All totals are sums of
    float64 per-hour [T] aggregates — the same aggregates a telemetry run
    receives as ``dispatch.hourly``, from which
    `repro_torch.obs.report.reconstruct_dispatch` reproduces ``cpc`` and
    ``n_migrations`` bit for bit.
    """
    alloc = np.asarray(alloc, np.float64)
    prices = np.asarray(problem.prices, np.float64)
    demand = np.asarray(problem.demand_mw, np.float64)

    energy_t = (alloc * prices).sum(axis=0)               # [T]
    delivered_t = alloc.sum(axis=0)                       # [T]
    prev = np.concatenate([np.zeros_like(alloc[:, :1]), alloc[:, :-1]],
                          axis=1)
    delta = alloc - prev
    inflow = np.clip(delta, 0.0, None).sum(axis=0)        # [T]
    outflow = np.clip(-delta, 0.0, None).sum(axis=0)
    moved = np.minimum(inflow, outflow)
    energy_cost = float(energy_t.sum())
    migration_mw = float(moved.sum())
    migration_cost = problem.migrate_cost * migration_mw
    delivered = float(delivered_t.sum())

    avail_total = np.asarray(problem.avail_mw, np.float64).sum(axis=0)
    slack_cap_t = avail_total - demand                    # [T]
    if problem.relief is not None:
        # unmet demand, priced at the value of lost load: the exact
        # float64 shortfall against availability and the power cap (not
        # against the float32 allocation, whose rounding residue would
        # price phantom micro-shed), with the 1e-6 MW tolerance of
        # `_check_feasible`, so relief sheds exactly where the hard path
        # would have raised
        served_t = np.minimum(demand,
                              np.minimum(problem.power_cap_mw,
                                         avail_total))
        shed_t = np.clip(demand - served_t, 0.0, None)    # [T]
        shed_t = np.where(shed_t > 1e-6, shed_t, 0.0)
        shed_mwh = float(shed_t.sum())
        shed_cost = float(problem.relief.voll_eur_mwh) * shed_mwh
        n_shed_hours = int((shed_t > 0.0).sum())
        cpc = (problem.fixed_cost + energy_cost + migration_cost
               + shed_cost) / max(delivered, 1e-9)
    else:
        shed_mwh = shed_cost = 0.0
        n_shed_hours = 0
        cpc = (problem.fixed_cost + energy_cost + migration_cost) \
            / max(delivered, 1e-9)
    result = DispatchResult(
        alloc_mw=alloc,
        cpc=cpc,
        energy_cost=energy_cost,
        migration_cost=migration_cost,
        migration_mw=migration_mw,
        n_migrations=int((moved > _MOVE_TOL).sum()),
        delivered_mwh=delivered,
        site_mwh=alloc.sum(axis=1),
        slack_power_mw=float(problem.power_cap_mw - demand.max()),
        slack_capacity_mw=float(slack_cap_t.min()),
        slack_floor_mwh=delivered - problem.compute_floor_mwh,
        shed_mwh=shed_mwh,
        shed_cost=shed_cost,
        n_shed_hours=n_shed_hours,
    )
    if obs.enabled():
        _emit_dispatch_events(problem, result, demand, delivered_t,
                              energy_t, moved, slack_cap_t)
    return result


def _emit_dispatch_events(problem: DispatchProblem, result: DispatchResult,
                          demand, delivered_t, energy_t, moved,
                          slack_cap_t) -> None:
    """``dispatch.hourly`` (the float64 [T] aggregates the totals came
    from), ``dispatch.result``, ``dispatch.shed`` under relief, and the
    dispatch counters and gauges."""
    near = int((slack_cap_t < _NEAR_FRAC * demand).sum())
    obs.trace_event("dispatch.hourly", {
        "delivered_mwh": delivered_t, "energy_cost": energy_t,
        "moved_mw": moved, "slack_capacity_mw": slack_cap_t,
        "demand_mw": demand, "move_tol": _MOVE_TOL,
        "fixed_cost": problem.fixed_cost,
        "migrate_cost": problem.migrate_cost,
    })
    obs.trace_event("dispatch.result", {
        "cpc": result.cpc, "energy_cost": result.energy_cost,
        "migration_cost": result.migration_cost,
        "migration_mw": result.migration_mw,
        "n_migrations": result.n_migrations,
        "delivered_mwh": result.delivered_mwh,
        "slack_power_mw": result.slack_power_mw,
        "slack_capacity_mw": result.slack_capacity_mw,
        "slack_floor_mwh": result.slack_floor_mwh,
        "near_infeasible_hours": near, "near_frac": _NEAR_FRAC,
        "n_sites": int(result.alloc_mw.shape[0]),
        "hours": int(result.alloc_mw.shape[1]),
        "site_names": list(problem.site_names),
    })
    if problem.relief is not None:
        obs.trace_event("dispatch.shed", {
            "shed_mwh": result.shed_mwh, "shed_cost": result.shed_cost,
            "n_shed_hours": result.n_shed_hours,
            "voll_eur_mwh": float(problem.relief.voll_eur_mwh),
            "demand_mwh": float(demand.sum()),
            "delivered_mwh": result.delivered_mwh,
        })
        obs.counter("dispatch.shed_mwh").inc(result.shed_mwh)
        obs.counter("dispatch.shed_hours").inc(result.n_shed_hours)
    obs.counter("dispatch.calls").inc()
    obs.counter("dispatch.moves").inc(result.n_migrations)
    obs.gauge("dispatch.slack_capacity_mw").set(result.slack_capacity_mw)
    obs.gauge("dispatch.slack_power_mw").set(result.slack_power_mw)
    obs.gauge("dispatch.cpc").set(result.cpc)
