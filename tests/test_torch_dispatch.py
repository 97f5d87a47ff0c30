"""The dispatch slice: the port's segment sort, schedules, hard water-fill
(`dispatch_ref`, the plain version of the CUDA `dispatch_scan` kernel),
`dispatch`, `summarize(dispatch_cfg=)` and the tuner's hard re-scoring
against the JAX reference on the same numpy inputs, plus the port's own
refusals. Everything runs on the CPU (`device="cpu"`), where
`dispatch_scan` runs its plain version.

Tolerances, and why:
- The numpy helpers, the schedules (discrete, multiples of 1/4 x rating),
  the segment order and rank (ties included) are held to equality.
- The water-fill takes an exclusive prefix over the sorted widths. The
  port sums it sequentially in float64 and rounds once (the order its
  CUDA kernel shares); the reference forms ``jnp.cumsum(w) - w`` in
  float32, which XLA's CPU backend sums sequentially in float32 for up
  to 16 segments and in its own blocked order beyond. Where every partial
  sum is exact in float32 (widths and demand on a dyadic grid) the two
  are bitwise equal, and so are the dwell ledgers and every
  `DispatchResult` field.
- Elsewhere the prefixes differ in the last bits, and so do the
  allocations: within 1e-6 of the hour's total availability (about 8x
  the largest difference seen at S = 64). The operator's problem is such
  a case although its widths are multiples of 1/4 MW: its demand (0.35
  of the fleet's rating) is not, so the marginal site's partial fill and
  every sum after it round (1-2 ulps on a few of 2880 entries). There the
  discrete results (`n_migrations`, shed hours) and the slacks, which
  depend only on availability and demand, are equal, and the cost totals
  within rtol 1e-6. On arbitrary float32 widths the CPC is held within
  rtol 1e-5 and `n_migrations` is not compared: it counts hours whose net
  move exceeds 1e-6 MW, a threshold that last-bit differences can cross.
- The tuner's re-scoring runs from the same selected policies on both
  sides: operated rows, choice and site names equal, CPCs within rtol
  1e-5 (non-dyadic off levels make the prefix sums inexact).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.tco import make_system as jax_make_system  # noqa: E402
from repro.dispatch import DispatchConfig as JaxDispatchConfig  # noqa: E402
from repro.dispatch import DispatchInfeasible as JaxInfeasible  # noqa: E402
from repro.dispatch import DispatchProblem as JaxDispatchProblem  # noqa: E402
from repro.dispatch import Relief as JaxRelief  # noqa: E402
from repro.dispatch import build_problem as jax_build_problem  # noqa: E402
from repro.dispatch import capacity_series as jax_capacity_series  # noqa: E402
from repro.dispatch import dispatch as jax_dispatch  # noqa: E402
from repro.dispatch import diurnal_demand as jax_diurnal_demand  # noqa: E402
from repro.dispatch import on_state_series as jax_on_state_series  # noqa: E402
from repro.dispatch import resolve_demand as jax_resolve_demand  # noqa: E402
from repro.dispatch import segment_keys as jax_segment_keys  # noqa: E402
from repro.dispatch import segment_rank as jax_segment_rank  # noqa: E402
from repro.energy.markets import MarketParams as JaxMarketParams  # noqa: E402
from repro.energy.presets import region_params as jax_region_params  # noqa: E402
from repro.fleet import PolicySpec as JaxPolicySpec  # noqa: E402
from repro.fleet import backtest as jax_backtest  # noqa: E402
from repro.fleet import build_grid as jax_build_grid  # noqa: E402
from repro.fleet import elastic_policy as jax_elastic_policy  # noqa: E402
from repro.fleet import summarize as jax_summarize  # noqa: E402
from repro.kernels.dispatch_scan import dispatch_scan as jax_dispatch_scan  # noqa: E402
from repro.kernels.ref import dispatch_alloc_hour as jax_alloc_hour  # noqa: E402
from repro.kernels.ref import dispatch_ref as jax_dispatch_ref  # noqa: E402
from repro.tune.objective import PhysicalPolicy as JaxPhysicalPolicy  # noqa: E402
from repro.tune.optimizer import _dispatch_reeval as jax_dispatch_reeval  # noqa: E402
from _dispatch_cases import cut_case  # noqa: E402
from repro_torch.core.tco import make_system  # noqa: E402
from repro_torch.dispatch import (DispatchConfig,  # noqa: E402
                                  DispatchInfeasible, DispatchProblem,
                                  Relief, build_problem, capacity_series,
                                  dispatch, diurnal_demand, on_state_series,
                                  resolve_demand, segment_keys, segment_rank)
from repro_torch.examples import fleet_dispatch  # noqa: E402
from repro_torch.execution import Coupling, ExecutionPlan  # noqa: E402
from repro_torch.fleet import (backtest, build_grid,  # noqa: E402
                               grid_from_numpy, summarize)
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.kernels.dispatch_scan import dispatch_scan  # noqa: E402
from repro_torch.kernels.ref import (dispatch_alloc_hour,  # noqa: E402
                                     dispatch_alloc_hour_cut,
                                     dispatch_cut_ref, dispatch_ref)
from repro_torch.tune import PhysicalPolicy, TuneConfig, optimize  # noqa: E402
from repro_torch.tune.optimizer import (_dispatch_reeval,  # noqa: E402
                                        cell_best_rows)

CPU = "cpu"


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# numpy helpers and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("migrate_cost", [0.0, 5.0])
def test_segment_keys_and_rank_match_reference(migrate_cost):
    # integer prices: many ties within and across the segment classes
    prices = np.random.default_rng(3).integers(20, 30, (6, 50)) \
        .astype(np.float32)
    np.testing.assert_array_equal(segment_keys(prices, migrate_cost),
                                  jax_segment_keys(prices, migrate_cost))
    order, rank = segment_rank(prices, migrate_cost)
    j_order, j_rank = jax_segment_rank(prices, migrate_cost)
    assert order.dtype == rank.dtype == np.int32
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(rank, j_rank)
    np.testing.assert_array_equal(
        np.take_along_axis(rank, order, axis=1),
        np.broadcast_to(np.arange(18), order.shape))


def test_demand_helpers_match_reference():
    assert diurnal_demand(50, base_mw=3.0, swing_mw=1.5, peak_hour=18.0) \
        == jax_diurnal_demand(50, base_mw=3.0, swing_mw=1.5, peak_hour=18.0)
    with pytest.raises(ValueError, match="swing"):
        diurnal_demand(5, base_mw=1.0, swing_mw=2.0)
    power = np.array([1.0, 2.5, 0.75], np.float32)
    prof = diurnal_demand(40, base_mw=2.0, swing_mw=1.0)
    for kw in (dict(demand_frac=0.37), dict(demand_mw=1.3),
               dict(demand_mw=prof)):
        got = resolve_demand(DispatchConfig(**kw), power, 40)
        want = jax_resolve_demand(JaxDispatchConfig(**kw), power, 40)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for mod, cfg in ((resolve_demand, DispatchConfig),
                     (jax_resolve_demand, JaxDispatchConfig)):
        with pytest.raises(ValueError, match="39 entries"):
            mod(cfg(demand_mw=prof[:39]), power, 40)


@pytest.mark.parametrize("off_level", [0.0, 0.25, 0.6])
def test_schedules_equal_reference(off_level):
    rng = np.random.default_rng(int(off_level * 100))
    s, t = 8, 300
    prices = rng.normal(80, 40, (s, t)).astype(np.float32)
    p_off = rng.uniform(40, 160, s).astype(np.float32)
    p_on = (p_off * rng.uniform(0.7, 1.0, s)).astype(np.float32)
    p_off[2] = np.inf                         # an always-on row
    p_on[5] = p_off[5]                        # a band of zero width
    prices[3, 10:20] = p_on[3]                # exactly on the thresholds
    prices[3, 30:40] = p_off[3]
    prices[4, 5] = p_off[4]
    lvl = np.full(s, off_level, np.float32)
    on = on_state_series(_t(prices), _t(p_on), _t(p_off)).numpy()
    np.testing.assert_array_equal(
        on, np.asarray(jax_on_state_series(prices, p_on, p_off)))
    assert on[2].min() == 1.0 and 0.0 in on
    cap = capacity_series(_t(prices), _t(p_on), _t(p_off), _t(lvl)).numpy()
    assert cap.dtype == np.float32
    np.testing.assert_array_equal(
        cap, np.asarray(jax_capacity_series(prices, p_on, p_off, lvl)))


# ---------------------------------------------------------------------------
# the water-fill: the port's plain version against the reference's
# ---------------------------------------------------------------------------

# the reference's DISPATCH_CASES (S, T, migrate_cost, min_dwell), T cut
DISPATCH_CASES = [(1, 64, 0.0, 0), (5, 333, 5.0, 0), (16, 500, 5.0, 6),
                  (64, 200, 0.0, 3)]


def _exact_case(s, t, seed):
    """Widths and demand on a 1/64 MW grid below 2^10 MW: every partial
    sum of an hour's widths is exact in float32."""
    rng = np.random.default_rng(seed)
    prices = rng.normal(80, 40, (s, t)).astype(np.float32)
    avail = (rng.integers(0, 64 * 1024 // max(s, 1), (s, t)) / 64.0) \
        .astype(np.float32)
    # a constant level, hours of rising and falling demand, and a few
    # hours above the fleet's availability (the fill saturates)
    total = avail.sum(axis=0)
    demand = np.floor(64 * rng.uniform(0.2, 1.05, t) * total) / 64.0
    return prices, avail, demand.astype(np.float32)


def _jax_ledger(avail, order, rank, demand, min_dwell):
    """[S, T] allocation and dwell ledger of the reference's per-hour math,
    chained by a jitted scan."""
    def step(carry, inp):
        alloc, dwell = jax_alloc_hour(*carry, *inp, min_dwell=min_dwell)
        return (alloc, dwell), (alloc, dwell)

    zeros = jnp.zeros(avail.shape[0], jnp.float32)
    _, (a, d) = jax.jit(lambda *x: jax.lax.scan(step, (zeros, zeros), x))(
        jnp.asarray(avail.T), jnp.asarray(order), jnp.asarray(rank),
        jnp.asarray(demand))
    return np.asarray(a).T, np.asarray(d).T


def _port_ledger(avail, rank, demand, min_dwell):
    prev = torch.zeros(avail.shape[0])
    dwell = torch.zeros(avail.shape[0])
    allocs, dwells = [], []
    for h in range(avail.shape[1]):
        prev, dwell = dispatch_alloc_hour(
            prev, dwell, _t(avail[:, h]), _t(rank[h]).long(),
            _t(demand[h]), min_dwell=min_dwell)
        allocs.append(prev)
        dwells.append(dwell)
    return torch.stack(allocs, 1).numpy(), torch.stack(dwells, 1).numpy()


def _problem(pkg, prices, avail, demand, mc, dwell, **kw):
    order, rank = segment_rank(prices, mc)
    cls = DispatchProblem if pkg == "port" else JaxDispatchProblem
    return cls(prices=prices, avail_mw=avail, demand_mw=demand,
               power_cap_mw=kw.pop("power_cap", float("inf")),
               migrate_cost=mc, min_dwell_h=dwell,
               compute_floor_mwh=kw.pop("floor", 0.0),
               fixed_cost=kw.pop("fixed", 1000.0), order=order, rank=rank,
               **kw)


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_dispatch_ref_bitwise_equal_on_exact_inputs(case):
    s, t, mc, dwell = case
    prices, avail, demand = _exact_case(s, t, seed=s * 1000 + t)
    order, rank = segment_rank(prices, mc)
    # the port reads only rank (scattering by rank is gathering by order)
    got = dispatch_ref(_t(avail), _t(rank), _t(demand), min_dwell=dwell)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, t)
    want = np.asarray(jax_dispatch_ref(avail, order, rank, demand,
                                       min_dwell=dwell))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(
        dispatch_scan(_t(avail), _t(rank), _t(demand),
                      min_dwell=dwell).numpy(), want)
    # the per-hour ledgers: allocations and dwell counters
    a_p, d_p = _port_ledger(avail, rank, demand, dwell)
    a_j, d_j = _jax_ledger(avail, order, rank, demand, dwell)
    np.testing.assert_array_equal(a_p, a_j)
    np.testing.assert_array_equal(d_p, d_j)
    if dwell:
        assert d_p.max() == dwell
    # the whole DispatchResult, n_migrations included
    res = dispatch(_problem("port", prices, avail, demand, mc, dwell,
                            relief=Relief()), device=CPU)
    ref = jax_dispatch(_problem("jax", prices, avail, demand, mc, dwell,
                                relief=JaxRelief()), use_pallas=False)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(res, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_dispatch_ref_equals_pallas_kernel_in_interpret_mode():
    s, t, mc, dwell = 5, 96, 5.0, 3
    prices, avail, demand = _exact_case(s, t, seed=7)
    order, rank = segment_rank(prices, mc)
    want = np.asarray(jax_dispatch_scan(avail, order, rank, demand,
                                        min_dwell=dwell, block_t=32,
                                        interpret=True))
    got = dispatch_ref(_t(avail), _t(rank), _t(demand),
                       min_dwell=dwell).numpy()
    np.testing.assert_array_equal(got, want)


def _assert_close_to_reference(res, ref, avail, err_msg=""):
    """The operator-problem tolerance of the module docstring."""
    tol = 1e-6 * np.asarray(avail, np.float64).sum(axis=0)       # [T]
    diff = np.abs(res.alloc_mw - ref.alloc_mw)
    assert np.all(diff <= tol[None, :]), (err_msg, float((diff / tol).max()))
    for f in ("n_migrations", "n_shed_hours", "slack_power_mw",
              "slack_capacity_mw"):
        assert getattr(res, f) == getattr(ref, f), (err_msg, f)
    for f in ("cpc", "energy_cost", "migration_cost", "migration_mw",
              "delivered_mwh", "site_mwh", "slack_floor_mwh", "shed_mwh",
              "shed_cost"):
        np.testing.assert_allclose(getattr(res, f), getattr(ref, f),
                                   rtol=1e-6, atol=0.0,
                                   err_msg=f"{err_msg} {f}")


@pytest.mark.parametrize("case", [(16, 300, 5.0, 0), (16, 300, 5.0, 4),
                                  (64, 120, 0.0, 3)])
def test_dispatch_close_on_arbitrary_float32_inputs(case):
    s, t, mc, dwell = case
    rng = np.random.default_rng(s + t + dwell)
    prices = rng.normal(80, 40, (s, t)).astype(np.float32)
    avail = rng.uniform(0.0, 400.0 / s, (s, t)).astype(np.float32)
    demand = (rng.uniform(0.3, 0.9, t) * avail.sum(axis=0)) \
        .astype(np.float32)
    res = dispatch(_problem("port", prices, avail, demand, mc, dwell),
                   device=CPU)
    ref = jax_dispatch(_problem("jax", prices, avail, demand, mc, dwell),
                       use_pallas=False)
    tol = 1e-6 * avail.astype(np.float64).sum(axis=0)          # [T]
    diff = np.abs(res.alloc_mw - ref.alloc_mw)
    assert np.all(diff <= tol[None, :]), float((diff / tol).max())
    assert res.cpc == pytest.approx(ref.cpc, rel=1e-5)
    assert res.delivered_mwh == pytest.approx(ref.delivered_mwh, rel=1e-6)


# ---------------------------------------------------------------------------
# the operator's problem: the fleet_dispatch example, 4 sites x 720 h
# ---------------------------------------------------------------------------

HOURS = 720
N_SITES = 4


def _jax_policies():
    """The reference example's policy table (`examples/fleet_dispatch.py`)."""
    return [
        JaxPolicySpec("always_on"),
        JaxPolicySpec("x5_part", x=0.05, off_level=0.25),
        JaxPolicySpec("x10_part", x=0.10, off_level=0.25, hysteresis=0.9),
        jax_elastic_policy("x10_half_dp", level=0.5, dp_total=16, x=0.10),
    ]


@pytest.fixture(scope="module")
def operator_fleet():
    markets = [jax_region_params("germany", seed=s).replace(n_hours=HOURS)
               for s in range(N_SITES)]
    p_avg = markets[0].p_avg
    names = dict(market_names=[f"de-seed{s}" for s in range(N_SITES)],
                 system_names=["psi2.0"])
    fixed = 2.0 * HOURS * 1.0 * p_avg
    jgrid = jax_build_grid(
        markets, [jax_make_system(fixed, 1.0, float(HOURS))],
        _jax_policies(), **names)
    prices = np.array(jgrid.prices)          # a writable copy for torch
    grid = build_grid(prices, [make_system(fixed, 1.0, float(HOURS),
                                           device=CPU)],
                      list(fleet_dispatch.POLICIES), **names, device=CPU)
    return jgrid, jax_backtest(jgrid, use_pallas=False), grid, \
        backtest(grid, device=CPU)


def _configs(n_mw):
    cfgs = [dict(demand_frac=fleet_dispatch.DEMAND_FRAC, migrate_cost=fee,
                 min_dwell_h=dwell) for fee, dwell in fleet_dispatch.SWEEP]
    prof = diurnal_demand(HOURS, base_mw=0.35 * n_mw, swing_mw=0.15 * n_mw,
                          peak_hour=18.0)
    return cfgs + [dict(demand_mw=prof, migrate_cost=5.0, min_dwell_h=4)]


def test_operator_problem_equals_reference(operator_fleet):
    jgrid, _, grid, _ = operator_fleet
    for f in TENSOR_FIELDS:              # the example's table, bit for bit
        np.testing.assert_array_equal(getattr(grid, f).numpy(),
                                      np.asarray(getattr(jgrid, f)),
                                      err_msg=f)
    # one site per market, each under another policy: widths of 1, 1/2 and
    # 1/4 MW
    rows = np.arange(N_SITES) * grid.n_policies + np.arange(N_SITES) % 4
    fields = {f: np.asarray(getattr(jgrid, f))[rows]
              for f in ("p_on", "p_off", "off_level", "power", "fixed")}
    prices = np.asarray(jgrid.prices)
    assert np.unique(fields["off_level"]).size == 3
    for kw in _configs(float(fields["power"].sum())):
        prob = build_problem(prices, fields["p_on"], fields["p_off"],
                             fields["off_level"], fields["power"],
                             DispatchConfig(**kw), fixed=fields["fixed"],
                             device=CPU)
        jprob = jax_build_problem(prices, fields["p_on"], fields["p_off"],
                                  fields["off_level"], fields["power"],
                                  JaxDispatchConfig(**kw),
                                  fixed=fields["fixed"])
        for f in ("prices", "avail_mw", "demand_mw", "order", "rank"):
            np.testing.assert_array_equal(getattr(prob, f),
                                          getattr(jprob, f), err_msg=f)
        assert prob.fixed_cost == jprob.fixed_cost
        res, ref = dispatch(prob, device=CPU), \
            jax_dispatch(jprob, use_pallas=False)
        _assert_close_to_reference(res, ref, prob.avail_mw, str(kw))
        assert res.n_migrations > 0


def test_summarize_dispatch_equals_reference(operator_fleet):
    jgrid, jrep, grid, rep = operator_fleet
    n_mw = float(grid.power.numpy()[::grid.n_policies].sum())
    for kw in _configs(n_mw):
        got = summarize(grid, rep, dispatch_cfg=DispatchConfig(**kw))
        want = jax_summarize(jgrid, jrep, dispatch_cfg=JaxDispatchConfig(**kw))
        np.testing.assert_array_equal(got.dispatch_rows, want.dispatch_rows)
        assert got.dispatch.site_mwh.shape == (N_SITES,)
        rows = torch.as_tensor(got.dispatch_rows)
        avail = capacity_series(grid.prices[grid.market_idx[rows]],
                                grid.p_on[rows], grid.p_off[rows],
                                grid.off_level[rows]) * grid.power[rows, None]
        _assert_close_to_reference(got.dispatch, want.dispatch,
                                   avail.numpy(), str(kw))


def test_example_runs_and_records_a_trace(capsys, tmp_path, monkeypatch):
    fleet_dispatch.run(device=CPU, hours=HOURS)
    out = capsys.readouterr().out
    assert "fleet CPC" in out and "diurnal demand" in out
    run = tmp_path / "trace"
    full = fleet_dispatch.run
    monkeypatch.setattr(fleet_dispatch, "run",
                        lambda device: full(device, hours=HOURS))
    assert fleet_dispatch.main(["--device", CPU, "--trace", str(run)]) == 0
    traced = capsys.readouterr().out
    # the same printout with the run recorded, and a valid run
    assert traced.startswith(out)
    from repro_torch.obs import report
    assert report.main([str(run), "--validate"]) == 0
    assert "(matches emitted result exactly)" in (run / "digest.md") \
        .read_text()


# ---------------------------------------------------------------------------
# infeasibility and relief
# ---------------------------------------------------------------------------

def _feasible_case():
    prices, avail, demand = _exact_case(4, 100, seed=41)
    demand = np.minimum(demand, avail.sum(axis=0) * 0.5).astype(np.float32)
    return prices, avail, demand


@pytest.mark.parametrize("breach", ["power_cap", "capacity",
                                    "compute_floor"])
def test_infeasible_constraints_raise_like_reference(breach):
    prices, avail, demand = _feasible_case()
    kw = {}
    if breach == "power_cap":
        kw["power_cap"] = float(demand.max()) * 0.5
    elif breach == "capacity":
        avail = avail.copy()
        avail[:, 42] = 0.0
        demand = np.maximum(demand, 1.0).astype(np.float32)
    else:
        kw["floor"] = float(demand.sum()) * 1.5
    with pytest.raises(JaxInfeasible) as want:
        jax_dispatch(_problem("jax", prices, avail, demand, 3.0, 2, **kw),
                     use_pallas=False)
    with pytest.raises(DispatchInfeasible) as got:
        dispatch(_problem("port", prices, avail, demand, 3.0, 2, **kw),
                 device=CPU)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("breach", ["power_cap", "capacity"])
def test_relief_sheds_like_reference(breach):
    prices, avail, demand = _feasible_case()
    kw = {"relief": Relief(voll_eur_mwh=2500.0)}
    if breach == "power_cap":
        kw["power_cap"] = float(np.sort(demand)[70])   # on the 1/64 grid
    else:
        avail = avail.copy()
        avail[:, 10:14] *= 0.25
        demand = np.maximum(demand, 2.0).astype(np.float32)
    res = dispatch(_problem("port", prices, avail, demand, 3.0, 2, **kw),
                   device=CPU)
    kw["relief"] = JaxRelief(voll_eur_mwh=2500.0)
    ref = jax_dispatch(_problem("jax", prices, avail, demand, 3.0, 2, **kw),
                       use_pallas=False)
    assert res.n_shed_hours > 0
    for f in ("shed_mwh", "shed_cost", "n_shed_hours", "cpc",
              "delivered_mwh"):
        assert getattr(res, f) == getattr(ref, f), f
    np.testing.assert_array_equal(res.alloc_mw, ref.alloc_mw)


# ---------------------------------------------------------------------------
# surfaces: summarize and the tuner's hard re-scoring
# ---------------------------------------------------------------------------

T = 400
CFG = dict(demand_frac=0.3, migrate_cost=4.0, min_dwell_h=3)


@pytest.fixture(scope="module")
def small_fleet():
    """The reference's dispatch test fleet: 3 markets x 1 system x 3
    policies x 400 h, carried across with `grid_from_numpy`."""
    markets = [JaxMarketParams(n_hours=T, seed=s) for s in range(3)]
    sys_ = jax_make_system(fixed=0.5 * T * 80.0, power=1.0, period=float(T))
    jgrid = jax_build_grid(markets, [sys_],
                           [JaxPolicySpec("ao"),
                            JaxPolicySpec("x5", x=0.05, off_level=0.3),
                            JaxPolicySpec("x10", x=0.10, off_level=0.3)],
                           market_names=("a", "b", "c"),
                           system_names=("s",))
    grid = grid_from_numpy({f: np.asarray(getattr(jgrid, f))
                            for f in TENSOR_FIELDS},
                           market_names=jgrid.market_names,
                           system_names=jgrid.system_names,
                           policy_names=jgrid.policy_names, device=CPU)
    return jgrid, jax_backtest(jgrid, use_pallas=False), grid, \
        backtest(grid, device=CPU)


def test_summarize_dispatch_rows_and_permutation_invariance(small_fleet):
    jgrid, jrep, grid, rep = small_fleet
    base = summarize(grid, rep, dispatch_cfg=DispatchConfig(**CFG))
    want = jax_summarize(jgrid, jrep, dispatch_cfg=JaxDispatchConfig(**CFG))
    np.testing.assert_array_equal(base.dispatch_rows, want.dispatch_rows)
    assert base.dispatch.alloc_mw.shape == (3, T)
    assert summarize(grid, rep).dispatch is None
    order = np.random.default_rng(5).permutation(grid.n_rows)
    grid_p = grid.take_rows(order)
    perm = summarize(grid_p, backtest(grid_p, device=CPU),
                     dispatch_cfg=DispatchConfig(**CFG)).dispatch
    for f in base.dispatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(base.dispatch, f)),
                                      np.asarray(getattr(perm, f)),
                                      err_msg=f)
    with pytest.raises(DispatchInfeasible):
        summarize(grid, rep, dispatch_cfg=DispatchConfig(**CFG,
                                                         power_cap_mw=0.1))


@pytest.mark.parametrize("relief", [False, True])
def test_dispatch_reeval_matches_reference(small_fleet, relief):
    jgrid, jrep, grid, rep = small_fleet
    cpc_swept = np.asarray(jrep.cpc, np.float64)
    best_row = cell_best_rows(grid, cpc_swept)
    # a "tuned" set: the swept policies with thresholds moved, selecting
    # the partial-shutdown policy x10 in every cell
    rng = np.random.default_rng(9)
    p_on = np.asarray(jgrid.p_on) * rng.uniform(0.9, 1.0, grid.n_rows)
    p_off = np.where(np.isinf(np.asarray(jgrid.p_off)), np.inf,
                     np.asarray(jgrid.p_off) * 1.05)
    lvl = np.asarray(jgrid.off_level)
    cpc = np.where(np.asarray(jgrid.policy_idx) == 2, 1.0, 2.0)
    demand = dict(demand_frac=0.95) if relief else {}
    kw = dict(CFG, **demand)
    pol = PhysicalPolicy(*(torch.tensor(v, dtype=torch.float32)
                           for v in (p_on, p_off, lvl)))
    jpol = JaxPhysicalPolicy(*(jnp.asarray(v, jnp.float32)
                               for v in (p_on, p_off, lvl)))
    got = _dispatch_reeval(grid, pol, cpc, best_row, DispatchConfig(
        **kw, relief=Relief() if relief else None))
    want = jax_dispatch_reeval(jgrid, jpol, cpc, best_row, JaxDispatchConfig(
        **kw, relief=JaxRelief() if relief else None))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["rows"], want["rows"])
    for k in ("chosen", "site_names", "infeasible_tuned",
              "infeasible_swept"):
        assert got[k] == want[k], k
    for k in ("cpc_tuned", "cpc_swept"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    if relief:
        assert got["tuned"].n_shed_hours == want["tuned"].n_shed_hours > 0


def test_optimize_rescoring_meets_demand(small_fleet):
    """`Coupling(reeval=)` re-scores tuned against swept policy sets on
    feasible dispatch (the reference's `test_tune_dispatch_reeval`)."""
    grid = small_fleet[2]
    res = optimize(grid, TuneConfig(steps=20, coupling=Coupling(
        reeval=DispatchConfig(**CFG))), device=CPU)
    d = res.dispatch
    assert d is not None and d["chosen"] in ("tuned", "swept")
    chosen = d[d["chosen"]]
    assert chosen is not None
    assert min(d["cpc_tuned"], d["cpc_swept"]) == chosen.cpc
    demand = CFG["demand_frac"] * grid.n_markets * 1.0
    np.testing.assert_allclose(chosen.alloc_mw.sum(axis=0),
                               np.full(T, demand), rtol=1e-4)
    # a Coupling-level relief covers the re-scoring: nothing infeasible
    res = optimize(grid, TuneConfig(steps=4, coupling=Coupling(
        reeval=DispatchConfig(demand_frac=1.2), relief=Relief())),
        device=CPU)
    assert res.dispatch["tuned"].n_shed_hours > 0
    assert res.dispatch["infeasible_tuned"] is None
    assert np.isfinite(res.dispatch["cpc_tuned"])


# ---------------------------------------------------------------------------
# the CUDA kernel's walk, which stops at the demand: its plain mirror
# (`dispatch_alloc_hour_cut`) held bit for bit against the plain hour
# ---------------------------------------------------------------------------


CUT_CASES = [("plain", 1, 64, 5.0, 0), ("plain", 7, 300, 5.0, 4),
             ("plain", 64, 120, 5.0, 4), ("plain", 33, 150, 0.0, 0),
             ("zero demand", 16, 120, 5.0, 4), ("above total", 16, 120, 5.0, 4),
             ("ties", 12, 150, 0.0, 3), ("negative avail", 9, 150, 5.0, 2)]


@pytest.mark.parametrize("case", CUT_CASES)
def test_cut_walk_equals_plain_hour(case):
    kind, s, t, mc, dwell = case
    avail, rank, demand = cut_case(kind, s, t, mc, seed=s * 100 + t)
    prev = dwell_a = torch.zeros(s)
    n3 = 3 * s
    cuts = []
    for h in range(t):
        args = (_t(avail[:, h]), _t(rank[h]).long(), _t(demand[h]))
        a, d, cut = dispatch_alloc_hour_cut(prev, dwell_a, *args,
                                            min_dwell=dwell)
        prev, dwell_a = dispatch_alloc_hour(prev, dwell_a, *args,
                                            min_dwell=dwell)
        assert torch.equal(a, prev) and torch.equal(d, dwell_a), (kind, h)
        assert cut == n3 or cut % 8 == 0
        negative = bool((avail[:, h] < 0).any())
        if negative or demand[h] > avail[:, h].astype(np.float64).sum():
            assert cut == n3, h          # a negative width, or a short fill
        elif demand[h] <= 0:             # the first run's sum reaches it
            assert cut == min(8, n3), h
        cuts.append(cut)
    if kind in ("plain", "ties") and s > 1:
        assert np.mean(cuts) < n3 - 1    # the walk does stop early
    got, walked = dispatch_cut_ref(_t(avail), _t(rank), _t(demand),
                                   min_dwell=dwell)
    assert torch.equal(got, dispatch_ref(_t(avail), _t(rank), _t(demand),
                                         min_dwell=dwell))
    assert walked.tolist() == cuts


def test_cut_walk_under_relief_equals_dispatch():
    """A relieved problem (demand above availability and a power cap)
    through `dispatch` equals the mirror on the kernel's inputs."""
    avail, rank, demand = cut_case("above total", 16, 200, 5.0, seed=11)
    prices = np.random.default_rng(11).normal(80, 40, avail.shape) \
        .astype(np.float32)
    rank = segment_rank(prices, 5.0)[1]
    cap = float(0.8 * avail.sum(axis=0).max())
    prob = _problem("port", prices, avail, demand, 5.0, 4, power_cap=cap,
                    relief=Relief())
    res = dispatch(prob, device=CPU)
    assert res.n_shed_hours > 0
    got, _ = dispatch_cut_ref(_t(avail), _t(rank),
                              _t(np.minimum(demand, cap).astype(np.float32)),
                              min_dwell=4)
    np.testing.assert_array_equal(got.numpy(), res.alloc_mw)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals():
    prices, avail, demand = _feasible_case()
    prob = _problem("port", prices, avail, demand, 3.0, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dispatch(prob)                      # device=None means cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            build_problem(prices, 0.0, np.inf, 0.0, 1.0, DispatchConfig())
    args = (_t(avail), _t(prob.rank), _t(demand))
    with pytest.raises(ValueError, match="CUDA"):
        dispatch_scan(*args, use_kernel=True)   # the kernel needs the card
    # use_kernel only asserts the route: on CPU tensors False is the plain
    # version, as the default is
    torch.testing.assert_close(dispatch_scan(*args, use_kernel=False),
                               dispatch_ref(*args), rtol=0, atol=0)
    for mode in ("chunked", "sharded"):
        plan = ExecutionPlan(mode=mode, chunk_rows=4 if mode == "chunked"
                             else 0)
        with pytest.raises(ValueError, match="no row axis"):
            dispatch(prob, plan=plan, device=CPU)
    single = dispatch(prob, plan=ExecutionPlan(mode="single"), device=CPU)
    np.testing.assert_array_equal(single.alloc_mw,
                                  dispatch(prob, device=CPU).alloc_mw)
    with pytest.raises(NotImplementedError, match="workload"):
        DispatchConfig(workload=object())
    with pytest.raises(NotImplementedError, match="workload"):
        resolve_demand(DispatchConfig()._replace(workload=object()),
                       np.ones(2), 5)
    # the soft coupling is ported (tests/test_torch_tune_dispatch.py) and
    # binds the rows; the hard re-scoring alone does not
    assert TuneConfig(coupling=Coupling(
        dispatch=DispatchConfig())).resolved_coupling.binds
    TuneConfig(coupling=Coupling(reeval=DispatchConfig(), relief=Relief()))
