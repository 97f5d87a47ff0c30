"""The live-operation slice: the port's forecasts, SMARD loader (its
events are in `test_torch_obs.py`), `repro_torch.live` and
`repro_torch.kernels.live_window` against the JAX reference on the CPU,
on the same price matrices (made with numpy from a seed; the grids are
carried across with `grid_from_numpy`).

Tolerances:
  * the numpy forecasts equal the reference's bit for bit;
    `seasonal_naive_batch` exactly; `similar_day_ar_batch` within 2 ulp
    of float32 (its ``damp ** k`` is float32 `pow`, whose last place may
    differ from XLA's);
  * `live_backtest`: the quantile family under the exact forecasters
    (seasonal-naive, persistence, perfect) equal in every decision and
    cost field; every row's thresholds and CPC within rtol 1e-5; on/off
    decisions (``n_starts``, ``n_stops``, ``x_realized``) exactly on every
    row without a near-threshold hour — one in which a true price lies
    within rtol 1e-5 of a threshold the row realized with — and the
    count of those hours is printed; ``cpc_ao``, ``mae_h`` (float32 sums
    in another order) within rtol 1e-6;
  * perfect forecast at the full horizon against the offline backtest:
    rtol 1e-6;
  * the hindsight oracle and the summary within rtol 1e-6, the offline
    CPC within rtol 1e-5 (the offline backtests' float32 sums);
  * the window steps and the never-re-solving live dispatch bit for bit
    against the port's offline fill (`dispatch_ref`), within 1e-5 MW of
    the reference's (its float32 prefix sums round the last bit where the
    port's float64 prefix does not); the re-solving live dispatch's
    allocation within 1e-4 MW (its thresholds are float32 sorts of the
    same forecasts, equal; its float64 segment keys are the host's, the
    reference's float32 ones equal in order on these prices).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tco import make_system as jax_make_system  # noqa: E402
from repro.energy import forecast as jforecast  # noqa: E402
from repro.fleet import PolicySpec as JaxPolicySpec  # noqa: E402
from repro.fleet import backtest as jax_backtest  # noqa: E402
from repro.fleet import build_grid as jax_build_grid  # noqa: E402
from repro.kernels import live_window as jwindow  # noqa: E402
from repro.kernels.ref import dispatch_alloc_hour as jax_alloc_hour  # noqa: E402
from repro.live import LiveConfig as JaxLiveConfig  # noqa: E402
from repro.live import build_live_grid as jax_build_live_grid  # noqa: E402
from repro.live import hindsight_cpc as jax_hindsight_cpc  # noqa: E402
from repro.live import live_backtest as jax_live_backtest  # noqa: E402
from repro.live import live_fleet_dispatch as jax_live_fleet  # noqa: E402
from repro.live import offline_cpc as jax_offline_cpc  # noqa: E402
from repro.live import summarize_live as jax_summarize_live  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.dispatch import segment_rank  # noqa: E402
from repro_torch.energy import forecast  # noqa: E402
from repro_torch.examples import live_operator  # noqa: E402
from repro_torch.fleet import PolicySpec, backtest, grid_from_numpy  # noqa: E402
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.kernels import live_window  # noqa: E402
from repro_torch.kernels.ref import dispatch_alloc_hour, dispatch_ref  # noqa: E402
from repro_torch.live import (FORECASTERS, LiveConfig,  # noqa: E402
                              build_live_grid, hindsight_cpc, live_backtest,
                              live_fleet_dispatch, offline_cpc,
                              summarize_live)
from repro_torch.live.controller import near_threshold_hours  # noqa: E402
from repro_torch.live.fleet import _first_planned_hour  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro.obs.schema import validate as jax_validate  # noqa: E402

CPU = "cpu"
NEAR = 1e-5          # the thresholds' tolerance, relative


def _np(x, dtype=np.float64):
    return x.detach().cpu().numpy().astype(dtype) \
        if isinstance(x, torch.Tensor) else np.asarray(x, dtype)


# ---------------------------------------------------------------------------
# forecasts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,horizon,season", [
    (400, 24, 168), (500, 400, 168), (100, 30, 168), (20, 7, 168),
    (169, 200, 48)])
def test_numpy_forecasts_equal_the_reference(n, horizon, season):
    rng = np.random.default_rng(n + horizon)
    hist = rng.normal(60.0, 25.0, n)
    truth = rng.normal(60.0, 25.0, horizon)
    assert forecast.effective_season(n, season) \
        == jforecast.effective_season(n, season)
    for name in ("seasonal_naive", "similar_day_ar"):
        np.testing.assert_array_equal(
            getattr(forecast, name)(hist, horizon, season),
            getattr(jforecast, name)(hist, horizon, season))
    pred = forecast.similar_day_ar(hist, horizon, season)
    assert forecast.mae(pred, truth) == jforecast.mae(pred, truth)
    assert forecast.mase(pred, truth, hist, season) \
        == jforecast.mase(pred, truth, hist, season)
    # batched over a leading axis, too
    hist2 = rng.normal(60.0, 25.0, (3, n))
    np.testing.assert_array_equal(
        forecast.seasonal_naive(hist2, horizon, season),
        jforecast.seasonal_naive(hist2, horizon, season))


@pytest.mark.parametrize("w,horizon,season", [
    (169, 24, 168), (169, 168, 168), (49, 100, 48), (30, 12, 168),
    (10, 5, 168)])
def test_batched_forecasts_match_reference(w, horizon, season):
    rng = np.random.default_rng(w * horizon)
    hist = rng.normal(80.0, 40.0, (5, w)).astype(np.float32)
    got = forecast.seasonal_naive_batch(torch.as_tensor(hist), horizon,
                                        season)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jforecast.seasonal_naive_batch(
            hist, horizon, season)))
    # and the numpy form, exactly
    np.testing.assert_array_equal(
        got.numpy(), forecast.seasonal_naive(hist, horizon, season))
    got = forecast.similar_day_ar_batch(torch.as_tensor(hist), horizon,
                                        season).numpy()
    want = np.asarray(jforecast.similar_day_ar_batch(hist, horizon, season))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= 2 * ulp)
    np.testing.assert_allclose(
        got, forecast.similar_day_ar(hist, horizon, season), rtol=1e-5,
        atol=1e-3)


# ---------------------------------------------------------------------------
# the controller sweep
# ---------------------------------------------------------------------------

def _policies(pkg):
    spec = {"jax": JaxPolicySpec, "torch": PolicySpec}[pkg]
    return [spec("x25", x=0.25), spec("x10", x=0.10),
            spec("h", x=0.15, hysteresis=0.9), spec("always_on")]


def _live_case(t=240, n_markets=2, seed=11, **kw):
    """(reference grid, port grid, reference LiveGrid, port LiveGrid) on
    one numpy price matrix."""
    r = np.random.default_rng(seed)
    prices = np.abs(r.normal(80.0, 40.0, (n_markets, t))).astype(np.float32)
    jgrid = jax_build_grid(prices, [jax_make_system(5e4, 1.0, float(t))],
                           _policies("jax"))
    grid = grid_from_numpy(
        {f: np.asarray(getattr(jgrid, f)) for f in TENSOR_FIELDS},
        market_names=jgrid.market_names, system_names=jgrid.system_names,
        policy_names=jgrid.policy_names, device=CPU)
    return (jgrid, grid, jax_build_live_grid(jgrid, _policies("jax"), **kw),
            build_live_grid(grid, _policies("torch"), **kw))


SWEEP = dict(forecasters=FORECASTERS, horizons=(24, 48), cadences=(1, 6),
             families=("quantile", "tuned"))


@pytest.fixture(scope="module")
def sweep():
    """t = 240, season 48, 2 markets x 4 policies x 4 forecasters x 2
    horizons x 2 cadences x 2 families = 256 controllers over 240 h."""
    jgrid, grid, jl, pl = _live_case(**SWEEP)
    cfg, jcfg = LiveConfig(hours=240, season=48), \
        JaxLiveConfig(hours=240, season=48)
    return dict(jgrid=jgrid, grid=grid, jl=jl, pl=pl, cfg=cfg, jcfg=jcfg,
                want=jax_live_backtest(jl, jcfg),
                got=live_backtest(pl, cfg, device=CPU))


def test_build_live_grid_matches_reference_and_validates(sweep):
    jl, pl = sweep["jl"], sweep["pl"]
    assert pl.n_rows == jl.n_rows == 256 and pl.h_max == jl.h_max == 48
    np.testing.assert_array_equal(pl.base_row, jl.base_row)
    for f in ("forecaster_id", "horizon", "cadence", "family_id", "x",
              "hysteresis"):
        np.testing.assert_array_equal(_np(getattr(pl, f)),
                                      np.asarray(getattr(jl, f), np.float64))
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(_np(getattr(pl.grid, f)),
                                      np.asarray(getattr(jl.grid, f),
                                                 np.float64))
    grid, pols = sweep["grid"], _policies("torch")
    with pytest.raises(ValueError, match="policies"):
        build_live_grid(grid, pols[:1])
    with pytest.raises(ValueError, match="forecaster"):
        build_live_grid(grid, pols, forecasters=("oracle",))
    with pytest.raises(ValueError, match="family"):
        build_live_grid(grid, pols, families=("greedy",))
    with pytest.raises(ValueError, match="horizons"):
        build_live_grid(grid, pols, horizons=(1,))
    with pytest.raises(ValueError, match="cadences"):
        build_live_grid(grid, pols, cadences=(0,))
    x = _np(pl.x)
    pol = _np(pl.grid.policy_idx, np.int64)
    assert np.all(x[pol == 3] == 0.0) and np.all(x[pol == 0] == 0.25)
    sub = pl.take_rows(np.arange(10, 20))
    assert sub.n_rows == 10 and sub.horizons == pl.horizons
    np.testing.assert_array_equal(sub.base_row, pl.base_row[10:20])


def test_live_backtest_matches_reference(sweep):
    got, want, pl, cfg = sweep["got"], sweep["want"], sweep["pl"], \
        sweep["cfg"]
    fid, fam = _np(pl.forecaster_id, np.int64), _np(pl.family_id, np.int64)
    exact = (fam == 0) & (fid != FORECASTERS.index("similar_day_ar"))
    assert exact.sum() == 96
    loose = ("cpc_ao", "mae1", "mae_h", "mase1")
    for name in got._fields:
        g, w = _np(getattr(got, name)), np.asarray(getattr(want, name),
                                                    np.float64)
        if name in loose:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g[exact], w[exact], err_msg=name)
            np.testing.assert_allclose(g, w, rtol=NEAR, err_msg=name)
    near = _np(near_threshold_hours(pl, cfg, NEAR, device=CPU), np.int64)
    print(f"near-threshold row-hours: {int(near.sum())} over "
          f"{int((near > 0).sum())} rows")
    calm = near == 0
    for name in ("n_starts", "n_stops", "x_realized"):
        np.testing.assert_array_equal(_np(getattr(got, name))[calm],
                                      np.asarray(getattr(want, name),
                                                 np.float64)[calm],
                                      err_msg=name)
    # the tuned family moved its thresholds, so the comparison has teeth
    tuned = (fam == 1) & (_np(pl.x) > 0)
    assert np.all(_np(got.threshold_updates)[tuned] > 0)


def test_live_backtest_deterministic_and_on_equals_off(sweep, tmp_path):
    pl, cfg, cold = sweep["pl"], sweep["cfg"], sweep["got"]
    again = live_backtest(pl, cfg, device=CPU)
    with obs.capture(tmp_path / "run"):
        hot = live_backtest(pl, cfg, device=CPU)
        summarize_live(pl, hot, cfg)
    for a, b, c in zip(cold, again, hot):
        assert torch.equal(a, b) and torch.equal(a, c)
    events = report.load_events(tmp_path / "run")
    for e in events:
        assert jax_validate(e) == [], e["kind"]
    step = next(e for e in events if e["kind"] == "live.step")
    assert len(step["on_mw"]) == cfg.hours
    assert sum(step["transitions"]) == float(cold.n_starts.sum()
                                             + cold.n_stops.sum())
    res = next(e for e in events if e["kind"] == "live.result")
    assert res["rows"] == pl.n_rows and res["hours"] == cfg.hours


def test_a_sweep_without_the_tuned_family_equals_its_rows(sweep):
    """A quantile-only sweep skips the Adam steps; its rows are the mixed
    sweep's quantile rows (every other row) bit for bit."""
    kw = dict(SWEEP, families=("quantile",))
    only = build_live_grid(sweep["grid"], _policies("torch"), **kw)
    got = live_backtest(only, sweep["cfg"], device=CPU)
    for a, b in zip(got, sweep["got"]):
        assert torch.equal(a, b[::2])


def test_scoring_matches_reference(sweep):
    pl, jl, cfg, jcfg = sweep["pl"], sweep["jl"], sweep["cfg"], \
        sweep["jcfg"]
    np.testing.assert_allclose(hindsight_cpc(pl, cfg),
                               jax_hindsight_cpc(jl, jcfg), rtol=1e-6)
    np.testing.assert_allclose(offline_cpc(pl, cfg),
                               jax_offline_cpc(jl, jcfg), rtol=1e-5)
    got = summarize_live(pl, sweep["got"], cfg)
    want = jax_summarize_live(jl, sweep["want"], jcfg)
    assert len(got.table) == len(want.table) == 4 * 2 * 2 * 2
    assert [(r["forecaster"], r["horizon"], r["cadence"], r["family"])
            for r in got.table] == [(r["forecaster"], r["horizon"],
                                     r["cadence"], r["family"])
                                    for r in want.table]
    for g, w in zip(got.table, want.table):
        for k in ("cpc", "mae1", "churn"):
            np.testing.assert_allclose(g[k], w[k], rtol=NEAR, err_msg=k)
        for k in ("regret_oracle", "regret_offline"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5)
    # the regret sandwich: the oracle lower-bounds every controller
    assert np.all(got.cpc_oracle <= got.cpc_live * (1 + 1e-5) + 1e-6)
    assert got.cpc_oracle.mean() < got.cpc_live.mean()
    assert "perfect" in got.render_table()


def test_perfect_forecast_full_horizon_matches_offline():
    t = 336
    jgrid, grid, _, pl = _live_case(
        t=t, n_markets=3, horizons=(24, t), cadences=(1,),
        forecasters=("seasonal_naive", "perfect"))
    cfg = LiveConfig(hours=t, season=168)
    res = live_backtest(pl, cfg, device=CPU)
    fid, hor = _np(pl.forecaster_id, np.int64), _np(pl.horizon, np.int64)
    sel = (fid == FORECASTERS.index("perfect")) & (hor == t)
    assert sel.sum() >= 3
    offline = _np(backtest(grid, device=CPU).cpc)[pl.base_row[sel]]
    np.testing.assert_allclose(_np(res.cpc)[sel], offline, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(offline_cpc(pl, cfg)[sel], offline,
                               rtol=1e-6)
    np.testing.assert_allclose(
        offline, np.asarray(jax_backtest(jgrid, use_pallas=False).cpc,
                            np.float64)[pl.base_row[sel]], rtol=1e-5)


# ---------------------------------------------------------------------------
# horizon windows and live dispatch
# ---------------------------------------------------------------------------

def _fleet_case(s=4, t=240, seed=5, ties=False):
    r = np.random.default_rng(seed)
    prices = (r.integers(60, 64, (s, t)) if ties
              else np.round(r.normal(80, 40, (s, t)), 2)).astype(np.float32)
    power = r.uniform(1.0, 3.0, s).astype(np.float32)
    return prices, power, 0.4 * float(power.sum())


@pytest.mark.parametrize("ties", [False, True])
def test_segment_rank_matches_reference_and_host(ties):
    prices, _, _ = _fleet_case(ties=ties)
    keys = np.asarray(jwindow.segment_keys_jnp(prices.T, 2.0, 1000.0))
    got_k = live_window.segment_keys_jnp(torch.as_tensor(prices.T), 2.0,
                                         1000.0)
    np.testing.assert_array_equal(got_k.numpy(), keys)
    order, rank = live_window.segment_rank_jnp(got_k)
    jorder, jrank = jwindow.segment_rank_jnp(keys)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    # float64 keys from the host's span give the host's order exactly
    span = float(prices.max()) - float(prices.min()) + 2.0 + 1.0
    _, rank64 = live_window.segment_rank_jnp(live_window.segment_keys_jnp(
        torch.as_tensor(prices.T).double(), 2.0, span))
    np.testing.assert_array_equal(rank64.numpy(),
                                  segment_rank(prices, 2.0)[1])


def test_plan_on_window_matches_reference_and_script():
    rng = np.random.default_rng(3)
    p = rng.normal(80, 40, (5, 30)).astype(np.float32)
    on0 = (rng.random(5) > 0.5).astype(np.float32)
    pol = [rng.uniform(a, b, 5).astype(np.float32)
           for a, b in ((40, 70), (70, 120), (0, 0.5), (0, 0.2))]
    got = live_window.plan_on_window(torch.as_tensor(on0),
                                     torch.as_tensor(p),
                                     *(torch.as_tensor(v) for v in pol))
    want = jwindow.plan_on_window(on0, p, *pol)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, cap_w, _ = live_window.plan_on_window(
        torch.ones(1), torch.tensor([[50.0, 120.0, 130.0, 40.0, 90.0]]),
        torch.tensor([60.0]), torch.tensor([100.0]), torch.zeros(1),
        torch.zeros(1))
    assert cap_w[0].tolist() == [1.0, 0.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("min_dwell", [0, 3])
def test_dispatch_window_matches_reference(min_dwell):
    prices, power, demand = _fleet_case(t=30, seed=7)
    s, h = prices.shape
    rng = np.random.default_rng(8)
    avail = (power[:, None] * rng.uniform(0.3, 1.0, (s, h))) \
        .astype(np.float32)
    dem = np.full(h, demand, np.float32)
    prev = rng.uniform(0.0, 1.0, s).astype(np.float32)
    dwell = rng.integers(0, 3, s).astype(np.float32)
    keys = live_window.segment_keys_jnp(torch.as_tensor(prices.T), 2.0,
                                        1000.0)
    got = live_window.dispatch_window(
        torch.as_tensor(prev), torch.as_tensor(dwell),
        torch.as_tensor(avail), keys, torch.as_tensor(dem),
        min_dwell=min_dwell)
    want = jwindow.dispatch_window(prev, dwell, avail, keys.numpy(), dem,
                                   min_dwell=min_dwell)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    # one hour from a fresh carry is exactly one offline fill hour
    _, rank = live_window.segment_rank_jnp(keys[0])
    one = live_window.dispatch_window(
        torch.zeros(s), torch.zeros(s), torch.as_tensor(power[:, None]),
        keys[:1], torch.tensor([demand], dtype=torch.float32),
        min_dwell=min_dwell)[0][:, 0]
    alloc, _ = dispatch_alloc_hour(torch.zeros(s), torch.zeros(s),
                                   torch.as_tensor(power), rank,
                                   torch.tensor(demand, dtype=torch.float32),
                                   min_dwell=min_dwell)
    assert torch.equal(one, alloc)
    jorder, jrank = jwindow.segment_rank_jnp(keys[0].numpy())
    jalloc, _ = jax_alloc_hour(np.zeros(s, np.float32),
                               np.zeros(s, np.float32), power, jorder, jrank,
                               np.float32(demand), min_dwell=min_dwell)
    # the reference's float32 prefix may round the last bit elsewhere
    np.testing.assert_allclose(alloc.numpy(), np.asarray(jalloc), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_planned_hour_equals_the_whole_window(seed):
    """The live dispatch's shortcut: hour 0 of `plan_on_window` +
    `dispatch_window` over the whole forecast, bit for bit."""
    rng = np.random.default_rng(seed)
    s, h = 6, 24
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    fc = t(rng.normal(80, 40, (s, h)))
    on_new = t(rng.random(s) > 0.3)
    alloc = t(rng.uniform(0, 2, s))
    dwell = t(rng.integers(0, 4, s))
    p_off = t(rng.uniform(70, 120, s))
    p_on = p_off * 0.8
    lvl, idle, power = t(rng.uniform(0, .5, s)), t(rng.uniform(0, .2, s)), \
        t(rng.uniform(1, 3, s))
    demand = t(rng.uniform(1, 4, h))
    span = 1000.0
    got = _first_planned_hour(on_new, alloc, dwell, fc, p_on, p_off, lvl,
                              idle, power, demand[0], 2.0, span,
                              min_dwell=3)
    _, cap_w, _ = live_window.plan_on_window(on_new, fc, p_on, p_off, lvl,
                                             idle)
    keys_w = live_window.segment_keys_jnp(fc.T.double(), 2.0, span)
    plan_w, _, _ = live_window.dispatch_window(
        alloc, dwell, power[:, None] * cap_w, keys_w, demand, min_dwell=3)
    assert torch.equal(got, plan_w[:, 0])


def test_live_fleet_never_resolve_matches_dispatch_ref():
    prices, power, demand = _fleet_case()
    s, t = prices.shape
    res = live_fleet_dispatch(
        prices, power, p_on=1e9, p_off=1e9, off_level=0.0, idle_frac=0.1,
        x=0.0, demand=demand, hours=t, horizon=24, cadence=10**6,
        season=48, migrate_cost=2.0, min_dwell=3, device=CPU)
    want = dispatch_ref(torch.as_tensor(power)[:, None].expand(s, t),
                        torch.as_tensor(segment_rank(prices, 2.0)[1]),
                        torch.full((t,), demand, dtype=torch.float32),
                        min_dwell=3)
    assert torch.equal(res.alloc_mw, want)
    assert float(res.shed_mwh) < 1e-3
    np.testing.assert_allclose(float(res.delivered_mwh), demand * t,
                               rtol=1e-6)
    jres = jax_live_fleet(
        prices, power, p_on=1e9, p_off=1e9, off_level=0.0, idle_frac=0.1,
        x=0.0, demand=demand, hours=t, horizon=24, cadence=10**6,
        season=48, migrate_cost=2.0, min_dwell=3)
    np.testing.assert_allclose(res.alloc_mw.numpy(),
                               np.asarray(jres.alloc_mw), rtol=0, atol=1e-5)


def test_live_fleet_resolving_path_matches_reference():
    prices, power, demand = _fleet_case(seed=9)
    kw = dict(p_on=1e9, p_off=1e9, off_level=0.2, idle_frac=0.1, x=0.25,
              demand=demand, hours=168, horizon=24, cadence=1, season=48,
              migrate_cost=2.0, min_dwell=3, fixed=100.0)
    res = live_fleet_dispatch(prices, power, device=CPU, **kw)
    jres = jax_live_fleet(prices, power, **kw)
    np.testing.assert_array_equal(res.p_off_final.numpy(),
                                  np.asarray(jres.p_off_final))
    np.testing.assert_allclose(res.alloc_mw.numpy(),
                               np.asarray(jres.alloc_mw), rtol=0, atol=1e-4)
    for name in ("cpc", "energy_cost", "migration_mw", "delivered_mwh",
                 "shed_mwh", "replan_mw"):
        np.testing.assert_allclose(float(getattr(res, name)),
                                   float(getattr(jres, name)), rtol=1e-4,
                                   atol=1e-3, err_msg=name)
    assert np.all(res.p_off_final.numpy() < 1e9)
    assert float(res.replan_mw) > 0.0


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--smoke"], ["--retune", "--smoke"]])
def test_live_operator_example_runs_on_the_cpu(flags, tmp_path, capsys):
    out = tmp_path / "summary.json"
    assert live_operator.main(flags + ["--device", CPU, "--out",
                                       str(out)]) == 0
    text = capsys.readouterr().out
    if "--retune" in flags:
        assert "warm-started re-tune OK" in text
    else:
        assert "lower bound holds on all rows: True" in text
        assert out.exists()
