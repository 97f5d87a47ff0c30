"""Dispatch-aware tuning: the port's `DispatchCoupling`, its dispatch term
in `soft_objective` (`soft_dispatch_ratio`) and the coupled tuner against
the JAX reference on the same grid (the reference's `_fleet_grid` of
`tests/test_soft_dispatch.py`, carried across with `grid_from_numpy`),
plus a float64 finite-difference check and the coupled tuner's
determinism, refusals and checkpoint resume. Everything runs on the CPU,
where the soft dispatch runs its plain versions.

Tolerances, and why:
- The coupling's host data: equal, once the port's float64 is rounded to
  the reference's float32 (the reference holds it in float32 without x64).
- The objective in float32: the loss within rtol 1e-5 and each raw
  gradient within 1e-4 of its largest magnitude. The soft scan and the
  water-fill sum in other orders (the port in float64, with a correctly
  rounded exp), so bisection steps compare differently in the last bits;
  the Newton step absorbs that to ~1e-7 of an allocation.
- The float64 finite-difference check: worst relative error <= 1e-3 over
  every raw coordinate, the reference's acceptance bound
  (`benchmarks/bench_tune.py::fd_grad_worst_rel_err`), with its problem.
- `optimize` after 25 steps: the same source per row and the same chosen
  set, per-row CPCs within rtol 1e-3 and the dispatched CPCs within rtol
  1e-4 (25 Adam steps amplify ulp-level gradient differences; the hard
  re-scoring of nearby thresholds moves less).
- Determinism and the checkpoint resume: bitwise.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.tco import make_system as jax_make_system  # noqa: E402
from repro.dispatch import DispatchConfig as JaxDispatchConfig  # noqa: E402
from repro.dispatch import Relief as JaxRelief  # noqa: E402
from repro.energy.markets import MarketParams as JaxMarketParams  # noqa: E402
from repro.fleet import PolicySpec as JaxPolicySpec  # noqa: E402
from repro.fleet import build_grid as jax_build_grid  # noqa: E402
from repro.tune import Coupling as JaxCoupling  # noqa: E402
from repro.tune import TuneConfig as JaxTuneConfig  # noqa: E402
from repro.tune import dispatch_coupling_from_grid as jax_coupling  # noqa: E402
from repro.tune import init_from_grid as jax_init_from_grid  # noqa: E402
from repro.tune import optimize as jax_optimize  # noqa: E402
from repro.tune import problem_from_grid as jax_problem_from_grid  # noqa: E402
from repro.tune import soft_objective as jax_soft_objective  # noqa: E402
from repro_torch.dispatch import DispatchConfig, Relief  # noqa: E402
from repro_torch.examples import tune_policies  # noqa: E402
from repro_torch.execution import Coupling, ExecutionPlan  # noqa: E402
from repro_torch.fleet import grid_from_numpy  # noqa: E402
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.tune import (DispatchCoupling, PolicyParams,  # noqa: E402
                              TuneConfig, dispatch_coupling_from_grid,
                              dispatch_coupling_from_numpy, init_from_grid,
                              optimize, problem_from_grid, soft_objective,
                              tune_loop, tune_loop_checkpointed)

CPU = "cpu"
DCFG = dict(demand_frac=0.25, migrate_cost=4.0, min_dwell_h=3)


def _jax_fleet_grid(t, n_markets=3, n_policies=3):
    """The reference's `_fleet_grid` at ``t`` hours."""
    markets = [JaxMarketParams(n_hours=t, seed=s) for s in range(n_markets)]
    system = jax_make_system(0.5 * t * 80.0, 1.0, float(t))
    pols = [JaxPolicySpec("ao"), JaxPolicySpec("x5", x=0.05, off_level=0.3),
            JaxPolicySpec("x10", x=0.10, off_level=0.3)][:n_policies]
    return jax_build_grid(markets, [system], pols)


def _port(jgrid):
    return grid_from_numpy(
        {f: np.asarray(getattr(jgrid, f)) for f in TENSOR_FIELDS},
        market_names=jgrid.market_names, system_names=jgrid.system_names,
        policy_names=jgrid.policy_names, device=CPU)


@pytest.fixture(scope="module")
def grids():
    jgrid = _jax_fleet_grid(96)
    return jgrid, _port(jgrid)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_dispatch_coupling_matches_reference(grids):
    jgrid, grid = grids
    for cfg in (DCFG, dict(demand_mw=1.1, migrate_cost=0.0, min_dwell_h=0)):
        got = dispatch_coupling_from_grid(grid, DispatchConfig(**cfg))
        want = jax_coupling(jgrid, JaxDispatchConfig(**cfg))
        assert isinstance(got, DispatchCoupling)
        for name in DispatchCoupling._fields:
            g, w = _np(getattr(got, name)), np.asarray(getattr(want, name))
            if name in ("cell_id", "order"):
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                assert g.dtype == np.float64
                np.testing.assert_array_equal(g.astype(w.dtype), w,
                                              err_msg=name)
        # the reference's coupling carried across as numpy
        back = dispatch_coupling_from_numpy(want)
        for name in DispatchCoupling._fields:
            np.testing.assert_array_equal(
                _np(getattr(back, name)),
                np.asarray(getattr(want, name)).astype(
                    _np(getattr(back, name)).dtype), err_msg=name)


@pytest.mark.parametrize("relief", [False, True], ids=["penalty", "relief"])
def test_dispatch_objective_and_gradients_match_reference(grids, relief):
    jgrid, grid = grids
    tau, mw = 4.0, 0.05
    # relief at a demand above what the soft fleet offers in some hours
    cfg = dict(DCFG, demand_frac=0.6) if relief else DCFG
    jc = jax_coupling(jgrid, JaxDispatchConfig(**cfg))
    pc = dispatch_coupling_from_grid(grid, DispatchConfig(**cfg))
    kw = dict(dispatch_min_dwell=3, dispatch_mw_scale=mw, dispatch_fused=True,
              reduction="sum")
    jval, jgrad = jax.value_and_grad(
        lambda r: jax_soft_objective(
            r, jax_problem_from_grid(jgrid), tau, dispatch=jc,
            relief=JaxRelief() if relief else None, **kw)[0])(
        jax_init_from_grid(jgrid))
    leaves = [x.clone().requires_grad_(True) for x in init_from_grid(grid)]
    loss, aux = soft_objective(PolicyParams(*leaves), problem_from_grid(grid),
                               tau, dispatch=pc,
                               relief=Relief() if relief else None, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    for leaf, want in zip(leaves, jgrad):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(leaf.grad), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    assert float(aux["dispatch_ratio"].detach()) > 0.0
    if relief:
        assert float(aux["penalty"].detach()) == 0.0


def _fd_problem(t=48):
    """`benchmarks/bench_tune.py::fd_grad_worst_rel_err`'s problem: 2
    market draws x 1 system x 2 policies x 48 h, raw parameters drawn
    with numpy seed 11, DispatchConfig(0.4, 3.0, 2), tau 4."""
    jgrid = jax_build_grid(
        [JaxMarketParams(n_hours=t, seed=s) for s in range(2)],
        [jax_make_system(0.5 * t * 80.0, 1.0, float(t))],
        [JaxPolicySpec("x5", x=0.05, off_level=0.3),
         JaxPolicySpec("x10", x=0.10, off_level=0.3)])
    grid = _port(jgrid)
    b = grid.n_rows
    problem = problem_from_grid(grid)
    problem = problem._replace(**{
        f: getattr(problem, f).double() for f in problem._fields
        if f != "market_idx"})
    coupling = dispatch_coupling_from_grid(
        grid, DispatchConfig(demand_frac=0.4, migrate_cost=3.0,
                             min_dwell_h=2))
    r = np.random.default_rng(11)
    raw = PolicyParams(
        raw_off=torch.tensor(r.uniform(70, 110, b), dtype=torch.float64),
        raw_gap=torch.tensor(r.uniform(0.5, 3.0, b), dtype=torch.float64),
        raw_lvl=torch.tensor(r.uniform(-1.0, 1.0, b), dtype=torch.float64))
    return problem, coupling, raw


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "native"])
def test_dispatch_objective_fd_float64(fused):
    problem, coupling, raw = _fd_problem()

    def loss(rw):
        return soft_objective(rw, problem, 4.0, dispatch=coupling,
                              dispatch_min_dwell=2, dispatch_fused=fused,
                              fused=fused)[0]

    leaves = [x.clone().requires_grad_(True) for x in raw]
    got = torch.autograd.grad(loss(PolicyParams(*leaves)), leaves)
    worst = 0.0
    with torch.no_grad():
        for k, field in enumerate(raw._fields):
            base = raw[k]
            for i in range(base.shape[0]):
                h = 1e-5 * max(1.0, abs(float(base[i])))
                hi, lo = base.clone(), base.clone()
                hi[i] += h
                lo[i] -= h
                fd = (float(loss(raw._replace(**{field: hi})))
                      - float(loss(raw._replace(**{field: lo})))) / (2 * h)
                worst = max(worst, abs(float(got[k][i]) - fd)
                            / max(abs(fd), 1e-8))
    assert worst <= 1e-3, f"worst FD-vs-autograd rel err {worst:.2e}"


@pytest.fixture(scope="module")
def optimized():
    jgrid = _jax_fleet_grid(200)
    grid = _port(jgrid)
    want = jax_optimize(jgrid, JaxTuneConfig(
        steps=25, coupling=JaxCoupling(dispatch=JaxDispatchConfig(**DCFG))))
    got = optimize(grid, TuneConfig(steps=25, coupling=Coupling(
        dispatch=DispatchConfig(**DCFG))), device=CPU)
    return got, want


def test_dispatch_aware_optimize_matches_reference(optimized):
    got, want = optimized
    np.testing.assert_array_equal(got.source, want.source)
    assert np.all(got.source == 0)         # the coupling binds
    assert got.dispatch["chosen"] == want.dispatch["chosen"]
    np.testing.assert_array_equal(got.dispatch["rows"], want.dispatch["rows"])
    np.testing.assert_allclose(got.cpc, want.cpc, rtol=1e-3)
    for k in ("cpc_tuned", "cpc_swept"):
        np.testing.assert_allclose(got.dispatch[k], want.dispatch[k],
                                   rtol=1e-4, err_msg=k)
    assert set(got.history) == set(want.history)
    assert np.all(np.isfinite(got.history["dispatch_ratio"]))
    assert np.all(got.history["dispatch_ratio"] > 0.0)
    assert got.guard_count == 0
    best = min(got.dispatch["cpc_tuned"], got.dispatch["cpc_swept"])
    assert best <= got.dispatch["cpc_swept"] * (1.0 + 1e-9)


def test_dispatch_aware_optimize_is_deterministic(grids):
    _, grid = grids
    cfg = TuneConfig(steps=6, coupling=Coupling(
        dispatch=DispatchConfig(**DCFG)))
    a, b = (optimize(grid, cfg, device=CPU) for _ in range(2))
    for x, y in zip(a.raw, b.raw):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.cpc, b.cpc)
    assert a.dispatch["cpc_tuned"] == b.dispatch["cpc_tuned"]
    np.testing.assert_array_equal(a.dispatch["tuned"].alloc_mw,
                                  b.dispatch["tuned"].alloc_mw)


def test_chunked_plan_refuses_the_dispatch_coupling():
    with pytest.raises(ValueError, match="chunk_rows"):
        TuneConfig(steps=5, plan=ExecutionPlan(mode="chunked", chunk_rows=4),
                   coupling=Coupling(dispatch=DispatchConfig(**DCFG)))


def test_coupled_checkpoint_resume_is_bitwise(grids, tmp_path):
    _, grid = grids
    cfg = TuneConfig(steps=8)
    coupling = dispatch_coupling_from_grid(grid, DispatchConfig(**DCFG))
    prob, raw0 = problem_from_grid(grid), init_from_grid(grid)
    raw_a, hist_a, cpc_a = tune_loop_checkpointed(
        raw0, prob, coupling, cfg=cfg, directory=tmp_path / "a", keep=8)
    tune_loop_checkpointed(raw0, prob, coupling, cfg=cfg,
                           directory=tmp_path / "b", keep=8)
    for step_dir in sorted((tmp_path / "b").glob("step_*"))[2:]:
        shutil.rmtree(step_dir)          # "killed" after stage 2
    raw_b, hist_b, cpc_b = tune_loop_checkpointed(
        raw0, prob, coupling, cfg=cfg, directory=tmp_path / "b", keep=8)
    for x, y in zip(raw_a, raw_b):
        assert torch.equal(x, y)
    assert torch.equal(cpc_a, cpc_b)
    for k in hist_a:
        np.testing.assert_array_equal(hist_a[k], hist_b[k], err_msg=k)
    assert np.all(hist_a["dispatch_ratio"] > 0.0)
    # and the checkpointed run is the loop itself, bit for bit
    raw_c, hist_c, _ = tune_loop(raw0, prob, coupling, cfg=cfg)
    for x, y in zip(raw_a, raw_c):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(hist_a["dispatch_ratio"],
                                  _np(hist_c["dispatch_ratio"]))


def test_example_trace_option_records_a_valid_run(tmp_path, capsys):
    run = tmp_path / "trace"
    assert tune_policies.main(["--smoke", "--device", "cpu", "--trace",
                               str(run)]) == 0
    from repro_torch.obs import report
    capsys.readouterr()
    assert report.main([str(run), "--validate"]) == 0
    kinds = {e["kind"] for e in report.load_events(run)}
    assert {"tune.step", "tune.stage", "tune.result",
            "fleet.backtest"} <= kinds
