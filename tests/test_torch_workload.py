"""The workload slice of the port against the JAX reference on the CPU.

`repro_torch.workload` (the arrival model, the numpy replay, the coupled
backtest), the ledger's plain versions and wrappers
(`repro_torch.kernels.ref` / `repro_torch.kernels.queue_scan`), and the
hooks the slice lifts: `ScenarioGrid.workload`, `summarize(workload=)`,
`DispatchConfig(workload=)`, `soft_objective(workload=)`,
`TuneConfig(workload=)` and `live_fleet_dispatch(workload=, faults=)`.
Inputs are numpy from a seed; grids are carried across with
`grid_from_numpy`.

Tolerances:
  * request draws, demand profiles and the replay equal the reference's
    bit for bit (numpy on both sides); `from_roofline` within rtol 1e-12
    with the reference's peak injected;
  * the hard ledger on integer-valued float64 work: every implementation
    equal, exactly (all sums are exact);
  * `SoftLedger`'s plain route (the hand-written backward) in float64:
    within 1e-9 of `jax.grad` of the reference's `queue_scan`, within
    1e-12 of torch autograd through the plain loop;
  * `workload_backtest`: the `FleetReport` equal to the port's `backtest`
    bit for bit; the ledger's sums and CPC quantiles within rtol 1e-5 of
    the reference's (float32 sums over buckets in another order); the
    hourly telemetry means within rtol 1e-5;
  * `soft_objective`'s workload term within rtol 1e-4 (float32, softplus
    in another order), its gradient within rtol 1e-3 relative to the
    largest entry;
  * the live replay's per-draw sums within rtol 1e-9 (float64).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.tco import make_system as jax_make_system  # noqa: E402
from repro.dispatch import DispatchConfig as JaxDispatchConfig  # noqa: E402
from repro.dispatch import resolve_demand as jax_resolve_demand  # noqa: E402
from repro.faults import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.faults import FaultTrace as JaxFaultTrace  # noqa: E402
from repro.fleet import PolicySpec as JaxPolicySpec  # noqa: E402
from repro.fleet import build_grid as jax_build_grid  # noqa: E402
from repro.kernels.queue_scan import queue_scan as jax_queue_scan  # noqa: E402
from repro.kernels.ref import queue_scan_ref as jax_queue_scan_ref  # noqa: E402
from repro.launch.roofline import PEAK_FLOPS as JAX_PEAK  # noqa: E402
from repro.live import live_fleet_dispatch as jax_live_fleet  # noqa: E402
from repro.tune.objective import problem_from_grid as jax_problem  # noqa: E402
from repro.tune.objective import init_from_grid as jax_init  # noqa: E402
from repro.tune.objective import soft_objective as jax_soft_objective  # noqa: E402
from repro.workload import Workload as JaxWorkload  # noqa: E402
from repro.workload import realized_cost as jax_realized_cost  # noqa: E402
from repro.workload import workload_backtest as jax_workload_backtest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.dispatch import (DispatchConfig, Relief,  # noqa: E402
                                  resolve_demand)
from repro_torch.examples import workload_fleet  # noqa: E402
from repro_torch.faults import FaultEvent, FaultTrace  # noqa: E402
from repro_torch.fleet import (PolicySpec, backtest,  # noqa: E402
                               grid_from_numpy, summarize)
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.kernels import queue_scan as qs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.live import live_fleet_dispatch  # noqa: E402
from repro_torch.obs.report import load_events  # noqa: E402
from repro_torch.tune import TuneConfig, optimize  # noqa: E402
from repro_torch.tune.objective import (init_from_grid,  # noqa: E402
                                        problem_from_grid, soft_objective)
from repro_torch.tune.optimizer import cell_best_rows  # noqa: E402
from repro_torch.workload import (Workload, ledger_cost,  # noqa: E402
                                  realized_cost, replay_ledger,
                                  workload_backtest)

CPU = "cpu"
LEDGER_CASES = [(0, 5.0), (2, 3.0), (4, 100.0), (3, 0.0)]


def _np(x, dtype=np.float64):
    return x.detach().cpu().numpy().astype(dtype) \
        if isinstance(x, torch.Tensor) else np.asarray(x, dtype)


def _int_case(r=3, t=40, seed=0, hi=6):
    """Integer-valued float64 arrivals/capacity: every ledger sum is
    exact."""
    g = np.random.default_rng(seed)
    return (g.integers(0, hi, (r, t)).astype(np.float64),
            g.integers(0, hi, (r, t)).astype(np.float64))


def _policies(pkg):
    spec = {"jax": JaxPolicySpec, "torch": PolicySpec}[pkg]
    return [spec("ao"), spec("x10", x=0.10, off_level=0.3),
            spec("x30", x=0.30, off_level=0.3),
            spec("h", x=0.15, hysteresis=0.9, restart_energy_mwh=0.3,
                 restart_time_h=0.25)]


def _grids(t=200, n_markets=2, seed=5, n_draws=6, deadline=3):
    """(reference grid, port grid, workloads) on one numpy price matrix,
    each grid carrying its package's Workload."""
    r = np.random.default_rng(seed)
    prices = np.abs(r.normal(80.0, 40.0, (n_markets, t))).astype(np.float32)
    systems = [jax_make_system(0.5 * t * 80.0, 1.0, float(t)),
               jax_make_system(2.0 * t * 80.0, 1.0, float(t))]
    kw = dict(n_draws=n_draws, seed=seed, deadline_h=deadline,
              queue_bound_mwh=2.5)
    jwl, wl = JaxWorkload(**kw), Workload(**kw)
    jgrid = jax_build_grid(prices, systems, _policies("jax"), workload=jwl)
    grid = grid_from_numpy(
        {f: np.asarray(getattr(jgrid, f)) for f in TENSOR_FIELDS},
        market_names=jgrid.market_names, system_names=jgrid.system_names,
        policy_names=jgrid.policy_names, device=CPU)
    return jgrid, dataclasses.replace(grid, workload=wl), jwl, wl


# ---------------------------------------------------------------------------
# the arrival model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,od", [(0, 0.25), (3, 0.0), (11, 1.5)])
def test_arrivals_and_demand_equal_the_reference(seed, od):
    kw = dict(seed=seed, overdispersion=od, n_draws=5, base_rps=3.0,
              peak_hour=9.0)
    wl, jwl = Workload(**kw), JaxWorkload(**kw)
    mult = np.where(np.arange(100) % 13 < 4, 1.7, 1.0)
    for m in (None, mult):
        np.testing.assert_array_equal(wl.sample_requests(100, m),
                                      jwl.sample_requests(100, m))
        np.testing.assert_array_equal(wl.sample_demand_mw(100, m),
                                      jwl.sample_demand_mw(100, m))
        np.testing.assert_array_equal(wl.mean_demand_mw(100, m),
                                      jwl.mean_demand_mw(100, m))
    assert wl.mw_per_request_hour == jwl.mw_per_request_hour
    for bad in (dict(n_draws=0), dict(base_rps=-1.0), dict(deadline_h=-1),
                dict(tokens_per_engine_hour=0.0)):
        with pytest.raises(ValueError):
            Workload(**bad)


def test_from_serving_and_from_roofline(monkeypatch):
    from repro.serving.engine import ServeConfig as JaxServeConfig
    from repro_torch.serving.engine import ServeConfig
    w = Workload.from_serving(ServeConfig(slots=8), seed=3)
    jw = JaxWorkload.from_serving(JaxServeConfig(slots=8), seed=3)
    assert dataclasses.asdict(w) == {
        k: v for k, v in dataclasses.asdict(jw).items()}
    cfg, jcfg = base.get_config("qwen1.5-0.5b"), \
        jbase.get_config("qwen1.5-0.5b")
    h100 = Workload.from_roofline(cfg, batch=64, seq_len=4096)
    # the port takes the H100's peak; injected with the reference's TPU
    # peak the formula gives the reference's number
    monkeypatch.setattr(roofline, "H100_SXM_BF16_FLOPS", JAX_PEAK)
    got = Workload.from_roofline(cfg, batch=64, seq_len=4096)
    want = JaxWorkload.from_roofline(jcfg, batch=64, seq_len=4096)
    np.testing.assert_allclose(got.tokens_per_engine_hour,
                               want.tokens_per_engine_hour, rtol=1e-12)
    np.testing.assert_allclose(h100.tokens_per_engine_hour
                               / got.tokens_per_engine_hour,
                               989e12 / JAX_PEAK, rtol=1e-12)


# ---------------------------------------------------------------------------
# the hard ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deadline,bound", LEDGER_CASES)
def test_ledger_implementations_agree_exactly(deadline, bound):
    a, c = _int_case(seed=deadline)
    out, hourly = ref.queue_scan_ref(a, c, deadline=deadline, bound=bound,
                                     hourly=True)
    jout, jh = jax_queue_scan(a, c, deadline=deadline, bound=bound,
                              hourly=True)
    s_ref, d_ref, b_ref, q_ref = jax_queue_scan_ref(a, c, deadline=deadline,
                                                    bound=bound)
    for got, *wants in ((hourly.served, jh.served, s_ref),
                        (hourly.dropped, jh.dropped, d_ref),
                        (hourly.backlog, jh.backlog, b_ref),
                        (out.q_final, jout.q_final, q_ref)):
        assert got.dtype == torch.float64
        for want in wants:
            np.testing.assert_array_equal(_np(got), np.asarray(want))
    for r in range(a.shape[0]):
        rep = replay_ledger(a[r], c[r], deadline=deadline, bound=bound)
        np.testing.assert_array_equal(rep.served, _np(hourly.served[r]))
        np.testing.assert_array_equal(rep.dropped, _np(hourly.dropped[r]))
        np.testing.assert_array_equal(rep.backlog, _np(hourly.backlog[r]))
        np.testing.assert_array_equal(rep.q_final, _np(out.q_final[r]))
    # the CPU wrapper is the plain loop; the forward's plain mirror too
    w = qs.queue_scan(torch.as_tensor(a), torch.as_tensor(c),
                      deadline=deadline, bound=bound)
    sums, _, q_final, hr = ref.soft_ledger_fwd_ref(
        torch.as_tensor(a), torch.as_tensor(c), None, deadline=deadline,
        bound=bound, hard=True, hourly=True)
    for x, y in ((w.served, out.served), (sums[1], out.dropped),
                 (sums[2], out.backlog), (q_final, out.q_final),
                 (hr[0], hourly.served)):
        assert torch.equal(x, y)


def test_conservation_and_economics():
    a, c = _int_case(r=4, t=60, seed=9)
    _, h = ref.queue_scan_ref(a, c, deadline=3, bound=4.0, hourly=True)
    srv, drp, bkl = (_np(v) for v in h)
    carried_in = np.concatenate([np.zeros((4, 1)), bkl[:, :-1]], axis=1)
    np.testing.assert_array_equal(a + carried_in, srv + drp + bkl)
    assert (bkl <= 4.0).all()
    rep = replay_ledger(a[0], c[0], deadline=2, bound=5.0)
    cost = ledger_cost(rep, slo_penalty_eur_mwh=40.0, voll_eur_mwh=3000.0)
    assert cost["drop_cost"] == pytest.approx(3000.0 * rep.dropped.sum())
    with pytest.raises(ValueError, match="deadline"):
        qs.queue_scan(a, c, deadline=-1, bound=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        qs.queue_scan(torch.as_tensor(a), c, deadline=1, bound=1.0,
                      use_kernel=True)


def test_soft_ledger_converges_to_hard():
    a, c = _int_case(r=2, t=50, seed=5)
    hard = ref.queue_scan_ref(a, c, deadline=2, bound=3.0)
    errs = []
    for tau in (1.0, 1e-1, 1e-2, 1e-4):
        soft = ref.queue_scan_ref(a, c, deadline=2, bound=3.0, tau=tau)
        errs.append(max(float((soft.served - hard.served).abs().max()),
                        float((soft.dropped - hard.dropped).abs().max())))
    assert errs[-1] < 1e-2 and errs[-1] < errs[0]
    z = torch.linspace(-3.0, 8.0, 50, dtype=torch.float64)
    assert torch.equal(ref.smoothclip(z, torch.zeros_like(z), 0.1),
                       torch.zeros_like(z))
    mid = ref.smoothclip(z, torch.full_like(z, 5.0), 1.0)
    assert (mid > 0).all() and (mid < 5.0).all() and (mid.diff() >= 0).all()


@pytest.mark.parametrize("deadline,bound", LEDGER_CASES + [(9, 4.0)])
def test_soft_ledger_gradients_match_jax_and_autograd(deadline, bound):
    """A differentiable soft `queue_scan` on the CPU runs the plain route
    of `SoftLedger` (its hand-written backward): in float64 against
    `jax.grad` of the reference's soft `queue_scan` and torch autograd
    through the plain loop, with and without prices. Its hourly series
    carry no gradient and raise."""
    a, c = _int_case(r=3, t=24, seed=7 + deadline)
    c = c + 0.5
    tau = 0.3
    g = np.random.default_rng(deadline).normal(size=(4, 3))
    prices = np.random.default_rng(1).normal(80.0, 20.0, (3, 24))
    for p in (None, prices):
        at, ct = (torch.tensor(x, requires_grad=True) for x in (a, c))
        pt = None if p is None else torch.tensor(p)
        o = qs.queue_scan(at, ct, deadline=deadline, bound=bound, tau=tau,
                          prices=pt)
        sums = (o.served, o.dropped, o.backlog, o.served_cost)
        loss = sum((torch.tensor(g[k]) * sums[k]).sum() for k in range(4))
        d_a, d_c = torch.autograd.grad(loss, [at, ct])
        # torch autograd through the plain hour loop
        at2, ct2 = (torch.tensor(x, requires_grad=True) for x in (a, c))
        out = ref.queue_scan_ref(at2, ct2, deadline=deadline, bound=bound,
                                 tau=tau, prices=pt)
        loss2 = sum((torch.tensor(g[k]) * v).sum() for k, v in enumerate(
            (out.served, out.dropped, out.backlog, out.served_cost)))
        w_a, w_c = torch.autograd.grad(loss2, [at2, ct2])
        np.testing.assert_allclose(_np(d_c), _np(w_c), rtol=0, atol=1e-12)
        np.testing.assert_allclose(_np(d_a), _np(w_a), rtol=0, atol=1e-12)
        if p is None:
            continue
        with jax.enable_x64(True):
            def jloss(av, cv):
                o = jax_queue_scan(av, cv, deadline=deadline, bound=bound,
                                   tau=tau, prices=p)
                return sum(jnp.sum(jnp.asarray(g[k]) * v) for k, v in
                           enumerate((o.served, o.dropped, o.backlog,
                                      o.served_cost)))
            j_a, j_c = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                                       jnp.asarray(c))
            j_val = float(jloss(jnp.asarray(a), jnp.asarray(c)))
        np.testing.assert_allclose(_np(d_c), np.asarray(j_c), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(_np(d_a), np.asarray(j_a), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(float(loss.detach()), j_val, rtol=1e-12)
    at = torch.tensor(a, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        qs.queue_scan(at, torch.tensor(c), deadline=deadline, bound=bound,
                      tau=tau, hourly=True)


# ---------------------------------------------------------------------------
# the coupled backtest
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coupled():
    jgrid, grid, jwl, wl = _grids()
    return dict(jgrid=jgrid, grid=grid, jwl=jwl, wl=wl,
                got=workload_backtest(grid, device=CPU),
                want=jax_workload_backtest(jgrid))


def _results_close(got, want, rtol=1e-5):
    for f in got._fields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=rtol,
                                   atol=1e-4, err_msg=f)


def test_workload_backtest_matches_reference(coupled):
    got, want, grid = coupled["got"], coupled["want"], coupled["grid"]
    plain = backtest(grid, device=CPU)
    for f in plain._fields:
        assert torch.equal(getattr(got.report, f), getattr(plain, f)), f
    np.testing.assert_array_equal(_np(got.report.n_starts),
                                  _np(want.report.n_starts))
    _results_close(got.workload, want.workload)
    assert got.workload.n_draws == 6
    # zero workload short-circuits; _force_coupled runs the ledger anyway
    bare = dataclasses.replace(grid, workload=None)
    plain_run = workload_backtest(bare, device=CPU)
    assert plain_run.workload is None
    forced = workload_backtest(bare, _force_coupled=True, device=CPU)
    _results_close(forced.workload, jax_workload_backtest(
        dataclasses.replace(coupled["jgrid"], workload=None),
        _force_coupled=True).workload)


def test_workload_telemetry_and_surge(coupled, tmp_path):
    grid, jgrid = coupled["grid"], coupled["jgrid"]
    with obs.capture(tmp_path):
        on = workload_backtest(grid, device=CPU)
    for f in on.workload._fields:
        assert torch.equal(getattr(on.workload, f),
                           getattr(coupled["got"].workload, f)), f
    ev = {e["kind"]: e for e in load_events(tmp_path)}
    hourly = ev["workload.hourly"]
    assert ev["workload.result"]["n_draws"] == 6
    # the reference's per-hour means, from its own fused scan
    from repro.kernels.queue_scan import workload_fleet_scan
    jp = jnp.asarray(jgrid.prices)[jgrid.market_idx]
    dt = jgrid.period / grid.n_hours
    wl = coupled["jwl"]
    _, jh = workload_fleet_scan(
        jp, jgrid.p_on, jgrid.p_off, jgrid.off_level, jgrid.idle_frac,
        jgrid.power * dt, jnp.asarray(wl.sample_demand_mw(grid.n_hours),
                                      jnp.float32), dt,
        deadline=wl.deadline_h, bound=wl.queue_bound_mwh, hourly=True)
    for k in jh._fields:
        np.testing.assert_allclose(np.asarray(hourly[k], np.float64),
                                   np.asarray(getattr(jh, k), np.float64),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # a demand surge reshapes the arrivals themselves
    t = grid.n_hours
    surge = FaultTrace((FaultEvent("demand_surge", -1, 50, 60, 2.0),))
    jsurge = JaxFaultTrace((JaxFaultEvent("demand_surge", -1, 50, 60,
                                          2.0),))
    hit = workload_backtest(grid, faults=surge, device=CPU)
    _results_close(hit.workload, jax_workload_backtest(
        jgrid, faults=jsurge).workload)
    assert float(hit.workload.arrivals_mwh.mean()) \
        > float(coupled["got"].workload.arrivals_mwh.mean())
    assert t == 200


def test_workload_fleet_scan_halves(coupled):
    grid = coupled["grid"]
    wl = coupled["wl"]
    dt = grid.period / grid.n_hours
    dem = torch.as_tensor(wl.sample_demand_mw(grid.n_hours),
                          dtype=torch.float32)
    out = qs.workload_fleet_scan(
        grid.prices, grid.p_on, grid.p_off, grid.off_level, grid.idle_frac,
        grid.power * dt, dem, dt, deadline=wl.deadline_h,
        bound=wl.queue_bound_mwh, market_idx=grid.market_idx)
    fleet = ref.fleet_scan_ref(grid.prices[grid.market_idx], grid.p_on,
                               grid.p_off, grid.off_level, grid.idle_frac)
    for x, y in zip(out.fleet, fleet):
        assert torch.equal(x, y)
    # the ledger reads the same rows through the index as gathered
    led, _ = qs.workload_ledger_fwd(
        grid.prices[grid.market_idx], grid.p_on, grid.p_off, grid.off_level,
        grid.power * dt, dem, dt, deadline=wl.deadline_h,
        bound=wl.queue_bound_mwh)
    for x, y in zip(led, out[1:]):
        assert torch.equal(x, y)


def test_grid_summary_and_dispatch_carry_the_workload(coupled):
    grid, wl = coupled["grid"], coupled["wl"]
    order = np.arange(grid.n_rows)[::-1].copy()
    assert grid.take_rows(order).workload is wl
    assert grid.to(CPU).workload is wl
    summ = summarize(grid, backtest(grid, device=CPU))
    _results_close(summ.workload, coupled["got"].workload, rtol=0)
    cfg = DispatchConfig(workload=wl)
    jcfg = JaxDispatchConfig(workload=coupled["jwl"])
    np.testing.assert_array_equal(
        resolve_demand(cfg, np.ones(3), 48),
        jax_resolve_demand(jcfg, np.ones(3), 48))
    # an explicit demand still wins over the workload
    np.testing.assert_array_equal(
        resolve_demand(cfg._replace(demand_mw=2.0), np.ones(3), 4),
        np.full(4, 2.0, np.float32))
    assert hash(cfg) == hash(DispatchConfig(workload=wl))


# ---------------------------------------------------------------------------
# SLO-aware tuning
# ---------------------------------------------------------------------------

def test_soft_objective_workload_term_matches_reference(coupled):
    grid, jgrid, wl, jwl = (coupled[k] for k in ("grid", "jgrid", "wl",
                                                 "jwl"))
    prob, jprob = problem_from_grid(grid), jax_problem(jgrid)
    raw, jraw = init_from_grid(grid), jax_init(jgrid)
    dem = wl.mean_demand_mw(grid.n_hours)
    for tau in (2.0,):
        leaves = [x.detach().clone().requires_grad_(True) for x in raw]
        loss, aux = soft_objective(type(raw)(*leaves), prob, tau,
                                   workload=wl, workload_demand=dem,
                                   reduction="sum")
        grads = torch.autograd.grad(loss, leaves)

        def jloss(r):
            return jax_soft_objective(
                r, jprob, tau, workload=jwl,
                workload_demand=jnp.asarray(dem, jnp.float32),
                reduction="sum")
        (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jraw)
        assert float(aux["workload"].detach().abs().max()) > 0
        np.testing.assert_allclose(_np(aux["workload"]),
                                   np.asarray(jaux["workload"]), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
        for got, want in zip(grads, jg):
            want = np.asarray(want, np.float64)
            np.testing.assert_allclose(
                _np(got), want, rtol=0,
                atol=1e-3 * max(np.abs(want).max(), 1e-6))
    off = soft_objective(raw, prob, 1.0)[1]["workload"]
    assert torch.equal(off, torch.zeros_like(off))


def test_optimize_realized_cost_never_above_best_swept(coupled):
    grid, jgrid, wl, jwl = (coupled[k] for k in ("grid", "jgrid", "wl",
                                                 "jwl"))
    demand = wl.sample_demand_mw(grid.n_hours)
    got = realized_cost(grid, grid.p_on, grid.p_off, grid.off_level, wl,
                        demand_mw=demand)
    want = jax_realized_cost(jgrid, jgrid.p_on, jgrid.p_off,
                             jgrid.off_level, jwl, demand_mw=demand)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    res = optimize(grid, TuneConfig(steps=6), device=CPU)
    assert res.workload_cost is not None
    swept = _np(got)
    best = swept[cell_best_rows(grid, swept)]
    assert np.all(res.workload_cost <= best * (1 + 1e-6))
    assert np.all(np.isfinite(res.workload_cost))
    # TuneConfig(workload=) takes the same path as the grid's workload
    bare = dataclasses.replace(grid, workload=None)
    res2 = optimize(bare, TuneConfig(steps=6, workload=wl), device=CPU)
    np.testing.assert_array_equal(res2.workload_cost, res.workload_cost)
    assert optimize(bare, TuneConfig(steps=2), device=CPU).workload_cost \
        is None


# ---------------------------------------------------------------------------
# the live fleet and the example
# ---------------------------------------------------------------------------

def test_live_fleet_workload_and_surge_match_reference():
    r = np.random.default_rng(2)
    prices = np.abs(r.normal(80.0, 40.0, (3, 300))).astype(np.float32)
    kw = dict(n_draws=5, seed=4)
    wl, jwl = Workload(**kw), JaxWorkload(**kw)
    surge = FaultTrace((FaultEvent("demand_surge", 0, 220, 12, 3.0),))
    jsurge = JaxFaultTrace((JaxFaultEvent("demand_surge", 0, 220, 12,
                                          3.0),))
    args = (prices, 1.0, 30.0, 60.0, 0.0, 0.0, np.full(3, 0.25))
    for f, jf in ((None, None), (surge, jsurge)):
        got = live_fleet_dispatch(*args, start=200, hours=48, workload=wl,
                                  faults=f, device=CPU)
        want = jax_live_fleet(*args, start=200, hours=48, workload=jwl,
                              faults=jf)
        np.testing.assert_allclose(_np(got.alloc_mw),
                                   np.asarray(want.alloc_mw), atol=1e-4)
        for k in ("served_mwh", "dropped_mwh", "deferred_mwh_h", "cost",
                  "cpc_p10", "cpc_p50", "cpc_p90"):
            np.testing.assert_allclose(got.workload[k], want.workload[k],
                                       rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="workload="):
        live_fleet_dispatch(*args, start=0, hours=10, device=CPU)


def test_live_replay_is_the_numpy_ledger():
    wl = Workload(n_draws=4, seed=1, deadline_h=2, queue_bound_mwh=1.5)
    alloc = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 0.6, (3, 30)), dtype=torch.float32)
    from repro_torch.live.fleet import _replay_workload
    stats = _replay_workload(wl, alloc, None, start=10, hours=30,
                             fleet_cost=100.0)
    draws = wl.sample_demand_mw(40)[:, 10:40]
    cap = torch.sum(alloc, 0).double().numpy()
    for g in range(4):
        rep = replay_ledger(draws[g], cap, deadline=2, bound=1.5)
        np.testing.assert_allclose(stats["served_mwh"][g], rep.served.sum(),
                                   rtol=1e-9)
        np.testing.assert_allclose(stats["dropped_mwh"][g],
                                   rep.dropped.sum(), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(stats["deferred_mwh_h"][g],
                                   rep.backlog.sum(), rtol=1e-9, atol=1e-12)
    assert Relief().voll_eur_mwh == wl.relief.voll_eur_mwh


def test_workload_fleet_example_smoke_on_the_cpu(capsys):
    assert workload_fleet.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "SLO-aware tuning" in out
