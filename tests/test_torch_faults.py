"""The faults slice of the port against the JAX reference on the CPU.

`repro_torch.faults` (traces, masks, `faulted_backtest`,
`faulted_problem`) and the live operator's fault channels
(`live_backtest(faults=)`), on the same price matrices (numpy from a
seed; grids carried across with `grid_from_numpy`).

Tolerances:
  * masks, storms and `faulted_problem`'s arrays equal the reference's
    bit for bit (numpy on both sides);
  * `faulted_backtest`: start counts exactly, every other report field
    within rtol 1e-5 (the port's float32 sums over hours are reductions,
    the reference's a sequential scan); a zero-fault run and trivial
    masks equal the port's `backtest` bit for bit; ``_force_masked`` on
    identity masks gives the backtest's start counts exactly and its sums
    within rtol 1e-5;
  * `live_backtest(faults=)` with the exact forecasters (seasonal-naive,
    persistence, perfect) and the quantile family: start and stop counts
    and the fallback-rung counts exactly, costs within rtol 1e-5; a
    trivial schedule equals the run without one bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tco import make_system as jax_make_system  # noqa: E402
from repro.dispatch import DispatchConfig as JaxDispatchConfig  # noqa: E402
from repro.dispatch import build_problem as jax_build_problem  # noqa: E402
from repro.faults import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.faults import FaultTrace as JaxFaultTrace  # noqa: E402
from repro.faults import faulted_backtest as jax_faulted_backtest  # noqa: E402
from repro.faults import faulted_problem as jax_faulted_problem  # noqa: E402
from repro.faults import random_storm as jax_random_storm  # noqa: E402
from repro.fleet import PolicySpec as JaxPolicySpec  # noqa: E402
from repro.fleet import build_grid as jax_build_grid  # noqa: E402
from repro.live import LiveConfig as JaxLiveConfig  # noqa: E402
from repro.live import build_live_grid as jax_build_live_grid  # noqa: E402
from repro.live.controller import _live_scan as jax_live_scan  # noqa: E402
from repro.live import live_backtest as jax_live_backtest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs.report import load_events  # noqa: E402
from repro_torch.dispatch import DispatchConfig, build_problem  # noqa: E402
from repro_torch.examples import chaos_fleet  # noqa: E402
from repro_torch.faults import (FAULT_KINDS, FaultEvent,  # noqa: E402
                                FaultMasks, FaultTrace, faulted_backtest,
                                faulted_problem, identity_masks,
                                random_storm, resolve_masks)
from repro_torch.fleet import PolicySpec, backtest, grid_from_numpy  # noqa: E402
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.kernels.ref import faulted_states_ref  # noqa: E402
from repro_torch.live import (LiveConfig, build_live_grid,  # noqa: E402
                              live_backtest)
from repro_torch.live.controller import (_live_scan, _scan_args,  # noqa: E402
                                         _scan_kw)

CPU = "cpu"


def _np(x, dtype=np.float64):
    return x.detach().cpu().numpy().astype(dtype) \
        if isinstance(x, torch.Tensor) else np.asarray(x, dtype)


def _policies(pkg):
    spec = {"jax": JaxPolicySpec, "torch": PolicySpec}[pkg]
    return [spec("ao"), spec("x10", x=0.10, off_level=0.3),
            spec("x25", x=0.25, off_level=0.3),
            spec("h", x=0.15, hysteresis=0.9, restart_energy_mwh=0.3,
                 restart_time_h=0.25, idle_frac=0.05)]


def _grids(t=300, n_markets=3, seed=3, policies=None):
    """(reference grid, port grid) on one numpy price matrix."""
    r = np.random.default_rng(seed)
    prices = np.abs(r.normal(80.0, 40.0, (n_markets, t))).astype(np.float32)
    systems = [jax_make_system(0.6 * t * 80.0, 1.0, float(t)),
               jax_make_system(2.0 * t * 80.0, 1.0, float(t))]
    jgrid = jax_build_grid(prices, systems, policies or _policies("jax"))
    grid = grid_from_numpy(
        {f: np.asarray(getattr(jgrid, f)) for f in TENSOR_FIELDS},
        market_names=jgrid.market_names, system_names=jgrid.system_names,
        policy_names=jgrid.policy_names, device=CPU)
    return jgrid, grid


def _events(pkg):
    ev = {"jax": JaxFaultEvent, "torch": FaultEvent}[pkg]
    return (ev("site_outage", 2, 10, 30, 1.0),
            ev("site_outage", -1, 40, 5, 0.4),
            ev("site_outage", 2, 25, 10, 0.7),
            ev("price_gap", 0, 0, 12),           # a leading gap
            ev("price_gap", 1, 100, 80),
            ev("forecast_blackout", -1, 50, 20),
            ev("demand_surge", -1, 60, 30, 1.5),
            ev("demand_surge", 0, 70, 40, 2.0),
            ev("site_outage", 3, 290, 50, 1.0))  # clipped at the horizon


# ---------------------------------------------------------------------------
# traces and masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_masks_and_storms_equal_the_reference(seed):
    kw = dict(n_outages=5, n_price_gaps=4, n_blackouts=3, n_surges=2,
              max_duration=30)
    st, jst = (random_storm(seed, 12, 3, 300, **kw),
               jax_random_storm(seed, 12, 3, 300, **kw))
    assert st.seed == jst.seed == seed
    assert [tuple(e) for e in st.events] == [tuple(e) for e in jst.events]
    for trace, jtrace in ((st, jst),
                          (FaultTrace(_events("torch")),
                           JaxFaultTrace(_events("jax")))):
        m, jm = trace.compile(12, 3, 300), jtrace.compile(12, 3, 300)
        for f in FaultMasks._fields:
            got, want = getattr(m, f), np.asarray(getattr(jm, f))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert m.counts() == jm.counts()
        assert m.is_trivial is jm.is_trivial is False
    assert FaultTrace().compile(4, 2, 9).is_trivial
    assert identity_masks(4, 2, 9).is_trivial


def test_trace_validation_matches_reference():
    assert FAULT_KINDS == ("site_outage", "price_gap", "forecast_blackout",
                           "demand_surge")
    for bad in (FaultEvent("meteor", 0, 0, 1),
                FaultEvent("price_gap", 0, -1, 1)):
        with pytest.raises(ValueError):
            FaultTrace((bad,))
    for bad in (FaultEvent("site_outage", 0, 0, 5, 1.5),
                FaultEvent("site_outage", 9, 0, 5),
                FaultEvent("demand_surge", -1, 0, 5, -1.0)):
        with pytest.raises(ValueError):
            FaultTrace((bad,)).compile(4, 2, 20)
    with pytest.raises(ValueError, match="do not fit"):
        resolve_masks(identity_masks(3, 2, 10), 4, 2, 10)


# ---------------------------------------------------------------------------
# the faulted backtest
# ---------------------------------------------------------------------------

def _reports_close(got, want, rtol=1e-5):
    np.testing.assert_array_equal(_np(got.n_starts), _np(want.n_starts))
    for f in got._fields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=rtol,
                                   atol=1e-6, err_msg=f)


def _reports_equal(got, want):
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("case", ["storm", "hand", "derate_only",
                                  "gaps_only"])
def test_faulted_backtest_matches_reference(case):
    jgrid, grid = _grids()
    b, n, t = grid.n_rows, grid.n_markets, grid.n_hours
    if case == "storm":
        kw = dict(n_outages=6, n_price_gaps=3, max_duration=60)
        faults, jfaults = (random_storm(5, b, n, t, **kw),
                           jax_random_storm(5, b, n, t, **kw))
    elif case == "hand":
        faults, jfaults = (FaultTrace(_events("torch")),
                           JaxFaultTrace(_events("jax")))
    else:
        r = np.random.default_rng(1)
        m = identity_masks(b, n, t)
        if case == "derate_only":
            m.cap_mult[:] = np.where(r.random((b, t)) < 0.2,
                                     r.uniform(0.0, 1.0, (b, t)), 1.0)
        else:
            m.price_ok[:] = r.random((n, t)) > 0.3
        faults = jfaults = m
    got = faulted_backtest(grid, faults, device=CPU)
    want = jax_faulted_backtest(jgrid, jfaults)
    _reports_close(got, want)
    # the plain companion alone, against the reference's report sums
    masks = resolve_masks(faults, b, n, t)
    scan = faulted_states_ref(
        grid.prices[grid.market_idx],
        torch.as_tensor(masks.price_ok)[grid.market_idx],
        torch.as_tensor(masks.cap_mult, dtype=torch.float32), grid.p_on,
        grid.p_off, grid.off_level, grid.idle_frac)
    np.testing.assert_array_equal(_np(scan.n_starts), _np(want.n_starts))


def test_zero_fault_backtest_is_the_backtest():
    jgrid, grid = _grids()
    plain = backtest(grid, device=CPU)
    b, n, t = grid.n_rows, grid.n_markets, grid.n_hours
    for faults in (None, FaultTrace(), identity_masks(b, n, t),
                   FaultTrace((FaultEvent("price_gap", 0, t + 5, 3),))):
        _reports_equal(faulted_backtest(grid, faults, device=CPU), plain)
    forced = faulted_backtest(grid, identity_masks(b, n, t),
                              _force_masked=True, device=CPU)
    _reports_close(forced, plain)
    _reports_close(forced, jax_faulted_backtest(
        jgrid, None, _force_masked=True))


def test_faulted_backtest_telemetry_and_degradation(tmp_path):
    _, grid = _grids()
    storm = random_storm(9, grid.n_rows, grid.n_markets, grid.n_hours,
                         n_outages=4, max_duration=60)
    off = faulted_backtest(grid, storm, device=CPU)
    with obs.capture(tmp_path) as run:
        on = faulted_backtest(grid, storm, device=CPU)
        outage_hours = run.counters["fault.outage_site_hours"].value
    _reports_equal(on, off)
    injected = [e for e in load_events(tmp_path)
                if e["kind"] == "fault.injected"]
    assert len(injected) == len(storm)
    assert {e["scope"] for e in injected} == {"backtest"}
    counts = resolve_masks(storm, grid.n_rows, grid.n_markets,
                           grid.n_hours).counts()
    assert outage_hours == counts["outage_site_hours"] > 0
    assert np.all(np.isfinite(_np(off.cpc)))


def test_faulted_problem_matches_reference():
    r = np.random.default_rng(4)
    s, t = 5, 120
    prices = np.abs(r.normal(80.0, 30.0, (s, t))).astype(np.float32)
    p_off = np.quantile(prices, 0.9, axis=1).astype(np.float32)
    args = (prices, p_off * 0.95, p_off, np.full(s, 0.2, np.float32),
            r.uniform(1.0, 3.0, s).astype(np.float32))
    prob = build_problem(*args, DispatchConfig(demand_frac=0.4,
                                               migrate_cost=2.0),
                         device=CPU)
    jprob = jax_build_problem(*args, JaxDispatchConfig(
        demand_frac=0.4, migrate_cost=2.0))
    kw = dict(n_outages=3, n_price_gaps=3, n_surges=2, max_duration=30)
    storm, jstorm = (random_storm(2, s, 2, t, **kw),
                     jax_random_storm(2, s, 2, t, **kw))
    sites = np.array([0, 1, 1, 0, 1])
    got = faulted_problem(prob, storm.compile(s, 2, t),
                          site_market_idx=sites)
    want = jax_faulted_problem(jprob, jstorm.compile(s, 2, t),
                               site_market_idx=sites)
    for f in ("prices", "avail_mw", "demand_mw"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    assert got.order is None and got.rank is None
    assert faulted_problem(prob, FaultTrace()) is prob


# ---------------------------------------------------------------------------
# the live operator under faults
# ---------------------------------------------------------------------------

LIVE = dict(forecasters=("seasonal_naive", "persistence", "perfect"),
            horizons=(24, 48), cadences=(1, 6), families=("quantile",))


@pytest.fixture(scope="module")
def live_case():
    pols_j = [JaxPolicySpec("x25", x=0.25), JaxPolicySpec("x10", x=0.10),
              JaxPolicySpec("h", x=0.15, hysteresis=0.9)]
    jgrid, grid = _grids(t=360, n_markets=2, seed=11, policies=pols_j)
    pols = [PolicySpec("x25", x=0.25), PolicySpec("x10", x=0.10),
            PolicySpec("h", x=0.15, hysteresis=0.9)]
    jl = jax_build_live_grid(jgrid, pols_j, **LIVE)
    pl = build_live_grid(grid, pols, **LIVE)
    cfg, jcfg = (LiveConfig(start=48, hours=300, season=48),
                 JaxLiveConfig(start=48, hours=300, season=48))
    return dict(jl=jl, pl=pl, cfg=cfg, jcfg=jcfg)


def _live_storm(pkg, b, n, t):
    fn = {"jax": jax_random_storm, "torch": random_storm}[pkg]
    return fn(3, b, n, t, n_outages=6, n_price_gaps=3, n_blackouts=4,
              max_duration=90)


def test_live_backtest_under_faults_matches_reference(live_case):
    jl, pl, cfg, jcfg = (live_case[k] for k in ("jl", "pl", "cfg", "jcfg"))
    b, n, t = pl.n_rows, pl.grid.n_markets, pl.grid.n_hours
    storm, jstorm = _live_storm("torch", b, n, t), _live_storm("jax", b, n, t)
    got = live_backtest(pl, cfg, faults=storm, device=CPU)
    want = jax_live_backtest(jl, jcfg, faults=jstorm)
    for f in ("n_starts", "n_stops", "x_realized", "threshold_updates"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), f)
    for f in got._fields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    # the fallback ladder's rung occupancy, forced-off and stale-price
    # row-hours, against the reference's
    masks = storm.compile(b, n, t)
    *_, fstats = _live_scan(*_scan_args(pl), **_scan_kw(pl, cfg),
                            masks=masks)
    g = jl.grid
    jm = jstorm.compile(b, n, t)
    *_, jf = jax_live_scan(
        g.prices, g.market_idx, g.fixed, g.power, g.period, g.p_on,
        g.p_off, g.off_level, g.idle_frac, jl.forecaster_id, jl.horizon,
        jl.cadence, jl.family_id, jl.x, jl.hysteresis, cfg=jcfg,
        h_max=jl.h_max, faulted=True, cap_mult=jm.cap_mult.astype(
            np.float32), price_ok=jm.price_ok, forecast_ok=jm.forecast_ok)
    want_f = np.concatenate([np.asarray(jf[0]), [float(jf[1]),
                                                 float(jf[2])]])
    np.testing.assert_array_equal(_np(fstats), want_f)
    assert want_f[1:4].sum() > 0 and want_f[4] > 0 and want_f[5] > 0


def test_live_trivial_faults_are_the_healthy_run(live_case, tmp_path):
    pl, cfg = live_case["pl"], live_case["cfg"]
    plain = live_backtest(pl, cfg, device=CPU)
    b, n, t = pl.n_rows, pl.grid.n_markets, pl.grid.n_hours
    for faults in (FaultTrace(), identity_masks(b, n, t),
                   FaultTrace((FaultEvent("demand_surge", -1, 0, 50,
                                          2.0),))):
        got = live_backtest(pl, cfg, faults=faults, device=CPU)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(plain, f)), f
    with obs.capture(tmp_path):
        live_backtest(pl, cfg, faults=_live_storm("torch", b, n, t),
                      device=CPU)
    (ev,) = [e for e in load_events(tmp_path) if e["kind"] == "live.fallback"]
    assert ev["rows"] == b and ev["hours"] == cfg.hours
    assert ev["fresh"] + ev["stale_shift"] + ev["seasonal_naive"] \
        + ev["persistence"] == b * cfg.hours


def test_chaos_fleet_example_smoke_on_the_cpu(capsys):
    assert chaos_fleet.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "shed" in out
