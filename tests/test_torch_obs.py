"""The telemetry slice: the port's `repro_torch.obs` (registry, schema,
report, profiling) and the telemetry branches of the backtest, dispatch
and tuner, against the JAX reference's `repro.obs` on the CPU.

What must hold: with a run active every result equals the result with it
off, bit for bit; the port's traces validate under the reference's own
reader (`repro.obs.report.main([run, "--validate"])`), which reproduces
the port's dispatch ``cpc`` and ``n_migrations`` exactly; the port's
reader renders the reference's digest from the same trace file.

Tolerances: `fleet_hourly_ref`'s starts and stops (and so the states)
equal the reference's exactly; ``on_mw`` and ``draw_price`` are float32
sums over rows in another order, within rtol 1e-5. The tuner's
``tune.step`` events against the reference's run on the same grid:
``loss`` within rtol 1e-5, ``tau`` and ``penalty`` exactly as floats
within rtol 1e-6, ``grad_norm`` within rtol 1e-3 (the gradients agree to
rtol 1e-4 per row, `tests/test_torch_tune.py`, and forty Adam steps
apart) and ``clip_frac`` exactly; ``tune.result``'s means within rtol
1e-3, as `test_torch_tune.py` holds `optimize`.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.kernels.ref import fleet_hourly_ref as jax_fleet_hourly_ref  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.tune import TuneConfig as JaxTuneConfig  # noqa: E402
from repro.tune import optimize as jax_optimize  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.tco import make_system  # noqa: E402
from repro_torch.dispatch import (DispatchConfig, DispatchInfeasible,  # noqa: E402
                                  build_problem, dispatch)
from repro_torch.energy.smard import load_price_csv, load_smard_csv  # noqa: E402
from repro_torch.examples import fleet_dispatch, tune_policies  # noqa: E402
from repro_torch.fleet import (PolicySpec, backtest, build_grid,  # noqa: E402
                               grid_from_numpy, summarize)
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.kernels.ref import hard_hour_step  # noqa: E402
from repro_torch.kernels.ref import fleet_hourly_ref  # noqa: E402
from repro_torch.obs import report, schema  # noqa: E402
from repro_torch.obs.profiling import profiled, record_compiled, xla_trace  # noqa: E402
from repro_torch.tune import (TuneConfig, init_from_grid, optimize,  # noqa: E402
                              problem_from_grid, tune_loop_checkpointed)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_run_left_open():
    yield
    obs.disable()
    jobs.disable()


def _small_grid(t=240, n=2, seed=3):
    rng = np.random.default_rng(seed)
    prices = np.abs(rng.normal(80.0, 40.0, (n, t))).astype(np.float32)
    systems = [make_system(f, 1.0, float(t), device=CPU)
               for f in (2e4, 5e4)]
    policies = [PolicySpec("ao"), PolicySpec("x10", x=0.10),
                PolicySpec("h", x=0.05, hysteresis=0.9,
                           restart_energy_mwh=0.3, restart_time_h=0.25)]
    return build_grid(prices, systems, policies, device=CPU)


def _equal(a, b) -> None:
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b or (a != a and b != b)


# ---------------------------------------------------------------------------
# registry, schema, report
# ---------------------------------------------------------------------------

def test_instruments_and_lifecycle(tmp_path):
    assert not obs.enabled() and obs.current() is None
    obs.counter("c").inc(5)                     # throwaway while disabled
    run = obs.enable(tmp_path / "run", run_id="unit")
    assert obs.enabled() and obs.current() is run
    obs.counter("c").inc()
    obs.counter("c").inc(2.5)
    obs.gauge("g").set(np.float32(1.5))
    for v in (3.0, 1.0, 2.0):
        obs.histogram("h").observe(v)
    obs.trace_event("unit.event", {"x": np.arange(3), "y": np.float32(2)})
    obs.disable()
    assert not obs.enabled()
    metrics = report.load_metrics(tmp_path / "run")
    assert metrics["counters"] == {"c": 3.5}
    assert metrics["gauges"] == {"g": 1.5}
    assert metrics["histograms"]["h"] == {"count": 3, "sum": 6.0,
                                          "min": 1.0, "max": 3.0,
                                          "mean": 2.0}
    events = report.load_events(tmp_path / "run")
    assert [e["kind"] for e in events] == ["run.meta", "unit.event",
                                           "run.close"]
    assert events[1]["x"] == [0, 1, 2] and events[1]["y"] == 2.0
    assert events[2]["n_events"] == 2 and events[2]["metrics"] == metrics
    obs.disable()                               # closing twice is a no-op
    # enabling over an active run closes it first
    first = obs.enable(tmp_path / "a")
    obs.enable(tmp_path / "b")
    assert (tmp_path / "a" / "metrics.json").exists()
    assert obs.current() is not first


def test_capture_restores_disabled_state_on_error(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with obs.capture(tmp_path / "run"):
            assert obs.enabled()
            raise RuntimeError("boom")
    assert not obs.enabled()
    kinds = [e["kind"] for e in report.load_events(tmp_path / "run")]
    assert kinds[0] == "run.meta" and kinds[-1] == "run.close"


def test_lines_are_ordered_and_schema_stamped(tmp_path):
    with obs.capture(tmp_path / "run", run_id="order"):
        for i in range(20):
            obs.trace_event("unit.tick", {"i": i})
    events = report.load_events(tmp_path / "run")
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert all(e["schema"] == obs.SCHEMA_VERSION for e in events)
    assert [e["i"] for e in events if e["kind"] == "unit.tick"] \
        == list(range(20))
    meta = events[0]
    assert meta["run_id"] == "order"
    assert meta["jax"] is None and meta["jaxlib"] is None
    assert meta["torch"] == torch.__version__
    assert meta["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    for e in events:
        assert schema.validate(e) == [] and jschema.validate(e) == []


def test_schema_is_the_reference_catalogue():
    assert obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert schema.EVENT_KINDS == jschema.EVENT_KINDS
    assert schema.validate({"kind": "fleet.hourly", "schema": 1}) \
        == jschema.validate({"kind": "fleet.hourly", "schema": 1})


def test_drain_copies_once_and_is_silent_when_disabled(tmp_path):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 3.0
    n = torch.tensor([3, 1 << 40])
    obs.drain("unit.drain", x=x, n=n)           # no run: nothing happens
    with obs.capture(tmp_path / "run"):
        obs.drain("unit.drain", x=x, n=n, flag=torch.tensor([True, False]))
    e = next(e for e in report.load_events(tmp_path / "run")
             if e["kind"] == "unit.drain")
    np.testing.assert_array_equal(np.asarray(e["x"], np.float32), x.numpy())
    assert e["n"] == [3, 1 << 40] and e["flag"] == [True, False]


def test_report_renders_the_reference_digest(tmp_path):
    """The port's reader and the reference's, on one trace the port
    wrote (a backtest, its summary with dispatch, an optimize, a loader
    warning and a span)."""
    grid = _small_grid()
    csv = tmp_path / "p.csv"
    csv.write_text("price\n80.0\nbad\n82.0\n")
    with obs.capture(tmp_path / "run", run_id="digest"):
        rep = backtest(grid, device=CPU)
        summarize(grid, rep, dispatch_cfg=DispatchConfig(
            demand_frac=0.3, migrate_cost=2.0, min_dwell_h=2))
        optimize(grid, TuneConfig(steps=6), device=CPU)
        with pytest.warns(UserWarning):
            load_price_csv(csv)
        with profiled("unit.span", rows=3):
            pass
    for redact in (False, True):
        got = report.render_digest(tmp_path / "run", redact_meta=redact)
        want = jreport.render_digest(tmp_path / "run", redact_meta=redact)
        assert got == want
    assert "(matches emitted result exactly)" in got
    assert report.main([str(tmp_path / "run"), "--validate", "-o",
                        str(tmp_path / "d.md")]) == 0


# ---------------------------------------------------------------------------
# telemetry on == off, bit for bit
# ---------------------------------------------------------------------------

def test_backtest_on_equals_off_and_drains_the_hourly_companion(tmp_path):
    grid = _small_grid()
    cold = backtest(grid, device=CPU)
    with obs.capture(tmp_path / "run"):
        hot = backtest(grid, device=CPU)
        summ = summarize(grid, hot)
    _equal(tuple(cold), tuple(hot))
    events = report.load_events(tmp_path / "run")
    hourly = [e for e in events if e["kind"] == "fleet.hourly"]
    back = [e for e in events if e["kind"] == "fleet.backtest"]
    assert len(hourly) == 1 and len(back) == 1
    want = fleet_hourly_ref(grid.prices[grid.market_idx], grid.p_on,
                            grid.p_off, grid.off_level, grid.idle_frac,
                            grid.power)
    for name, v in want._asdict().items():
        np.testing.assert_array_equal(np.asarray(hourly[0][name],
                                                 np.float32), v.numpy())
    assert back[0]["rows"] == grid.n_rows and not back[0]["use_pallas"]
    assert back[0]["n_starts_total"] == float(hot.n_starts.sum())
    assert int(sum(hourly[0]["starts"])) == int(hot.n_starts.sum())
    summ_ev = next(e for e in events if e["kind"] == "fleet.summary")
    assert summ_ev["total_cost"] == summ.total_cost
    for e in events:
        assert jschema.validate(e) == [], e["kind"]


def _hourly_case(kind):
    """[B, T] prices and row parameters: random rows; B = 1; p_on ==
    p_off; rows that never decide (every price inside the band); events
    in the last hour only."""
    rng = np.random.default_rng({"random": 0, "b1": 1, "equal": 2,
                                 "quiet": 3, "last": 4}[kind])
    b, t = (1, 97) if kind == "b1" else (7, 130)
    p = rng.normal(80, 40, (b, t)).astype(np.float32)
    p_off = rng.uniform(60, 120, b).astype(np.float32)
    p_on = (p_off * rng.uniform(0.6, 1.0, b)).astype(np.float32)
    if kind == "equal":
        p_on = p_off.copy()
        p[:, ::5] = p_off[:, None]               # exactly at the threshold
    if kind == "quiet":
        p = rng.uniform(0.0, 1.0, (b, t)).astype(np.float32) \
            * (p_off - p_on)[:, None] + p_on[:, None] + 1e-3
        p[0, :] = (p_on[0] + p_off[0]) / 2
    if kind == "last":
        p = np.tile(((p_on + p_off) / 2)[:, None], (1, t)).astype(np.float32)
        p[: b // 2, -1] = p_off[: b // 2] + 5.0
        p[b // 2:, -1] = p_on[b // 2:] - 5.0
        p[-1, 0] = p_off[-1] + 1.0                # off, then on at the end
    lvl = rng.uniform(0.0, 0.5, b).astype(np.float32)
    idle = rng.uniform(0.0, 0.2, b).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, b).astype(np.float32)
    return p, p_on, p_off, lvl, idle, weight


@pytest.mark.parametrize("kind", ["random", "b1", "equal", "quiet", "last"])
def test_fleet_hourly_ref_matches_reference(kind):
    args = _hourly_case(kind)
    got = fleet_hourly_ref(*(torch.as_tensor(a) for a in args))
    want = jax_fleet_hourly_ref(*args)
    for name in ("starts", "stops"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("on_mw", "draw_price"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6)
    # and against the per-hour loop of the port's own state machine
    p, p_on, p_off, lvl, idle, w = (torch.as_tensor(a) for a in args)
    on = torch.ones(p.shape[0])
    starts, stops = [], []
    for t in range(p.shape[1]):
        new, st, _, _ = hard_hour_step(on, p[:, t], p_on, p_off, lvl, idle)
        starts.append(st.sum())
        stops.append(torch.clamp(on - new, min=0.0).sum())
        on = new
    assert torch.equal(got.starts, torch.stack(starts))
    assert torch.equal(got.stops, torch.stack(stops))
    if kind == "quiet":
        assert float(got.starts.sum() + got.stops.sum()) == 0.0


def _dispatch_problem(cfg=None):
    grid = _small_grid(t=300, n=4, seed=8)
    rows = torch.arange(0, grid.n_rows, grid.n_policies * grid.n_systems)
    return build_problem(
        grid.prices[grid.market_idx[rows]], grid.p_on[rows],
        grid.p_off[rows], grid.off_level[rows], grid.power[rows],
        cfg or DispatchConfig(demand_frac=0.4, migrate_cost=3.0,
                              min_dwell_h=3), fixed=grid.fixed[rows],
        device=CPU)


def test_dispatch_on_equals_off_and_the_trace_reproduces_it(tmp_path):
    problem = _dispatch_problem()
    cold = dispatch(problem, device=CPU)
    with obs.capture(tmp_path / "run"):
        hot = dispatch(problem, device=CPU)
    _equal(tuple(cold), tuple(hot))
    events = report.load_events(tmp_path / "run")
    res = next(e for e in events if e["kind"] == "dispatch.result")
    for rec in (report.reconstruct_dispatch(events),
                jreport.reconstruct_dispatch(events)):
        assert rec["cpc"] == hot.cpc == res["cpc"]
        assert rec["n_migrations"] == hot.n_migrations
    metrics = report.load_metrics(tmp_path / "run")
    assert metrics["counters"]["dispatch.moves"] == hot.n_migrations
    assert metrics["gauges"]["dispatch.cpc"] == hot.cpc


def test_dispatch_infeasible_and_shed_events(tmp_path):
    from repro_torch.dispatch import Relief
    cfg = DispatchConfig(demand_frac=0.99, migrate_cost=3.0, min_dwell_h=3,
                         power_cap_mw=1.0)
    with obs.capture(tmp_path / "run"):
        with pytest.raises(DispatchInfeasible):
            dispatch(_dispatch_problem(cfg), device=CPU)
        dispatch(_dispatch_problem(cfg._replace(relief=Relief())),
                 device=CPU)
    events = report.load_events(tmp_path / "run")
    bad = [e for e in events if e["kind"] == "dispatch.infeasible"]
    assert len(bad) == 1 and bad[0]["constraint"] == "power_cap"
    shed = [e for e in events if e["kind"] == "dispatch.shed"]
    assert len(shed) == 1 and shed[0]["shed_mwh"] > 0.0
    for e in events:
        assert jschema.validate(e) == [], e["kind"]


def test_optimize_on_equals_off_with_step_events(tmp_path):
    grid = _small_grid()
    cfg = TuneConfig(steps=12, clip_norm=1e-4)
    cold = optimize(grid, cfg, device=CPU)
    with obs.capture(tmp_path / "run"):
        hot = optimize(grid, cfg, device=CPU)
    for name in cold._fields:
        if name != "history":
            _equal(getattr(cold, name), getattr(hot, name))
    for k, v in cold.history.items():
        np.testing.assert_array_equal(v, hot.history[k])
    assert set(hot.history) - set(cold.history) == {"grad_norm",
                                                    "clip_frac"}
    events = report.load_events(tmp_path / "run")
    steps = [e for e in events if e["kind"] == "tune.step"]
    assert [e["step"] for e in steps] == list(range(12))
    np.testing.assert_array_equal([e["grad_norm"] for e in steps],
                                  hot.history["grad_norm"])
    assert 0.0 < max(e["clip_frac"] for e in steps) <= 1.0
    stages = [e for e in events if e["kind"] == "tune.stage"]
    assert [e["cpc_hard_mean"] for e in stages] \
        == [float(v) for v in hot.stage_cpc]
    res = next(e for e in events if e["kind"] == "tune.result")
    assert res["rows"] == grid.n_rows and res["steps"] == 12
    assert sum(res["source_counts"].values()) == grid.n_rows
    assert report.load_metrics(tmp_path / "run")["histograms"][
        "tune.grad_norm"]["count"] == 12


def test_checkpointed_loop_on_equals_off_and_resumes(tmp_path):
    grid = _small_grid()
    problem = problem_from_grid(grid)
    raw0 = init_from_grid(grid)
    cfg = TuneConfig(steps=8, eval_stages=4)
    cold = tune_loop_checkpointed(raw0, problem, cfg=cfg,
                                  directory=tmp_path / "cold", keep=8)
    hot = tune_loop_checkpointed(raw0, problem, cfg=cfg,
                                 directory=tmp_path / "hot", telemetry=True,
                                 keep=8)
    _equal(tuple(cold[0]), tuple(hot[0]))
    _equal(cold[2], hot[2])
    for k, v in cold[1].items():
        np.testing.assert_array_equal(v, hot[1][k])
    assert hot[1]["grad_norm"].shape == (8,)
    # a telemetry run resumed from stage 2 equals the uninterrupted one
    part = tmp_path / "part"
    shutil.copytree(tmp_path / "hot", part)
    for step_dir in sorted(part.glob("step_*"))[2:]:
        shutil.rmtree(step_dir)          # "killed" after stage 2
    again = tune_loop_checkpointed(raw0, problem, cfg=cfg, directory=part,
                                   telemetry=True, keep=8)
    _equal(tuple(again[0]), tuple(hot[0]))
    for k, v in hot[1].items():
        np.testing.assert_array_equal(v, again[1][k])


# ---------------------------------------------------------------------------
# the examples' traces, read by the reference's reader
# ---------------------------------------------------------------------------

def test_fleet_dispatch_trace_validates_under_the_reference(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    run = tmp_path / "dispatch"
    full = fleet_dispatch.run
    monkeypatch.setattr(fleet_dispatch, "run",
                        lambda device: full(device, hours=720))
    assert fleet_dispatch.main(["--device", CPU, "--trace", str(run)]) == 0
    capsys.readouterr()
    assert jreport.main([str(run), "--validate"]) == 0
    out = capsys.readouterr().out
    assert "## Dispatch" in out
    assert "(matches emitted result exactly)" in out
    assert (run / "digest.md").read_text() == report.render_digest(run)
    kinds = {e["kind"] for e in report.load_events(run)}
    assert {"fleet.backtest", "fleet.hourly", "fleet.summary",
            "dispatch.hourly", "dispatch.result"} <= kinds


def _reference_tune_example():
    spec = importlib.util.spec_from_file_location(
        "_reference_tune_policies", ROOT / "examples" / "tune_policies.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Smoke:
    smoke = True


def test_tune_policies_trace_agrees_with_the_reference_run(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """``tune_policies --smoke --trace`` on the reference's smoke grid
    (its market draws carried across), against the reference's
    `optimize` on that grid under its own telemetry run."""
    jgrid = _reference_tune_example().build(_Smoke)
    grid = grid_from_numpy(
        {f: np.asarray(getattr(jgrid, f)) for f in TENSOR_FIELDS},
        market_names=jgrid.market_names, system_names=jgrid.system_names,
        policy_names=jgrid.policy_names, device=CPU)
    monkeypatch.setattr(tune_policies, "build", lambda args, dev: grid)
    run = tmp_path / "tune"
    assert tune_policies.main(["--smoke", "--device", CPU, "--trace",
                               str(run)]) == 0
    with jobs.capture(tmp_path / "ref"):
        jax_optimize(jgrid, JaxTuneConfig(steps=40))
    capsys.readouterr()
    assert jreport.main([str(run), "--validate"]) == 0
    assert "## Tuning" in capsys.readouterr().out

    def kind(path, k):
        return [e for e in report.load_events(path) if e["kind"] == k]

    got, want = kind(run, "tune.step"), kind(tmp_path / "ref", "tune.step")
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose([g["tau"], g["penalty"]],
                                   [w["tau"], w["penalty"]], rtol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-3)
        assert g["clip_frac"] == w["clip_frac"]
    g, w = kind(run, "tune.result")[0], kind(tmp_path / "ref",
                                             "tune.result")[0]
    assert (g["rows"], g["steps"]) == (w["rows"], w["steps"])
    for k in ("cpc_mean", "cpc_tuned_mean", "cpc_swept_best_mean"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-3)
    np.testing.assert_allclose(g["improvement_vs_best_mean"],
                               w["improvement_vs_best_mean"], atol=1e-3)


# ---------------------------------------------------------------------------
# loader events, profiling
# ---------------------------------------------------------------------------

SMARD = ("Datum;Anfang;Ende;Deutschland/Luxemburg [€/MWh]\n"
         "01.01.2024;00:00;01:00;39,91\n"
         "01.01.2024;01:00;02:00;-\n"
         "01.01.2024;02:00;03:00;1.234,50\n"
         "01.01.2024;03:00\n"
         "01.01.2024;04:00;05:00;abc\n"
         "01.01.2024;05:00;06:00;-5,25\n")


@pytest.mark.parametrize("fill", [None, "ffill"])
def test_loader_event_payload_matches_loadstats(tmp_path, fill):
    from repro.energy.smard import load_smard_csv as jax_load_smard_csv
    csv = tmp_path / "smard.csv"
    csv.write_text(SMARD, encoding="utf-8")
    with obs.capture(tmp_path / "run"):
        with pytest.warns(UserWarning):
            got, stats = load_smard_csv(csv, return_stats=True, fill=fill)
    with pytest.warns(UserWarning):
        want, jstats = jax_load_smard_csv(csv, return_stats=True, fill=fill)
    np.testing.assert_array_equal(got, want)
    assert tuple(stats) == tuple(jstats)
    e = next(e for e in report.load_events(tmp_path / "run")
             if e["kind"] == "loader.skipped_rows")
    assert e["action"] == "warn" and e["loader"] == "load_smard_csv"
    assert e["path"] == str(csv)
    for field in stats._fields:
        assert e[field] == getattr(stats, field), field
    assert e["skip_frac"] == stats.skip_frac
    assert jschema.validate(e) == []
    assert report.load_metrics(tmp_path / "run")["counters"][
        "loader.skipped_rows"] == stats.n_skipped + stats.n_nan


def test_loader_silent_when_disabled_and_raises_on_nothing(tmp_path):
    csv = tmp_path / "prices.csv"
    csv.write_text("80.0\nbad\n82.0\n" * 10)
    assert not obs.enabled()
    with pytest.warns(UserWarning):
        assert load_price_csv(csv, max_skip_frac=0.05).shape == (20,)
    junk = tmp_path / "junk.csv"
    junk.write_text("a\nb\n")
    with obs.capture(tmp_path / "run"):
        with pytest.raises(ValueError, match="no .* line parsed"):
            load_price_csv(junk)
    e = next(e for e in report.load_events(tmp_path / "run")
             if e["kind"] == "loader.skipped_rows")
    assert e["action"] == "raise" and e["n_parsed"] == 0


def test_profiling_span_trace_and_compiled(tmp_path):
    with xla_trace("off") as d:
        assert d is None                 # no run, no profiler
    with obs.capture(tmp_path / "run"):
        with profiled("unit.block", rows=3):
            pass
        with xla_trace("unit/trace") as d:
            torch.ones(8).sum()
    assert (d / "trace.json").exists()
    json.loads((d / "trace.json").read_text())
    events = report.load_events(tmp_path / "run")
    span = next(e for e in events if e["kind"] == "profile.span")
    assert span["label"] == "unit.block" and span["rows"] == 3
    tr = next(e for e in events if e["kind"] == "profile.trace")
    assert tr["dir"] == str(d)
    from repro_torch.launch.hlo_analysis import HLOReport
    got = record_compiled("unit", HLOReport(
        flops=6.0, bytes_accessed=8.0,
        collective_payload={"all-gather": 4.0}))
    assert got == {"label": "unit", "flops": 6.0, "bytes_accessed": 8.0,
                   "collective_bytes": 4.0}


def test_run_metadata_stamps_the_ports_facts():
    meta = obs.run_metadata()
    assert meta["jax"] is None and meta["jaxlib"] is None
    assert meta["torch"] == torch.__version__
    assert meta["cuda"] == torch.version.cuda
    if not torch.cuda.is_available():
        assert meta["device_kind"] == "cpu" and meta["backend"] == "cpu"
        assert meta["power_limit_w"] is None
