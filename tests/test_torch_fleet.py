"""The slice as a whole: the port's grid -> backtest -> summarize against
the JAX reference on a shared [N, T] price matrix, plus the port's own
execution-plan, permutation and surface checks.

The reference grid is carried across with `grid_from_numpy`, so both
packages backtest the same scenario rows; the port's own `build_grid`
must resolve the same thresholds bit for bit.

Tolerances: start counts and exact-decision fields equal; CPC, TCO and
hours within rtol 1e-5 (float32 sums in another order); `cpc_reduction`,
a difference of two nearly equal ratios (zero for always-on rows), and
the summary's reductions additionally within atol 1e-6; the realized
shutdown fraction within abs 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tco import make_system as jax_make_system  # noqa: E402
from repro.fleet import backtest as jax_backtest  # noqa: E402
from repro.fleet import build_grid as jax_build_grid  # noqa: E402
from repro.fleet import elastic_policy as jax_elastic_policy  # noqa: E402
from repro.fleet import PolicySpec as JaxPolicySpec  # noqa: E402
from repro.fleet import summarize as jax_summarize  # noqa: E402
from repro_torch.core.optimizer import optimal_shutdown  # noqa: E402
from repro_torch.core.policy import policy_cpc, threshold_policy  # noqa: E402
from repro_torch.core.tco import make_system  # noqa: E402
from repro_torch.dispatch import DispatchConfig  # noqa: E402
from repro_torch.examples import fleet_backtest, quickstart  # noqa: E402
from repro_torch.execution import ExecutionPlan  # noqa: E402
from repro_torch.fleet import (PolicySpec, ScenarioGrid, backtest,  # noqa: E402
                               build_grid, elastic_policy, grid_from_numpy,
                               summarize)
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402

CPU = "cpu"
T = 1200
N_MARKETS = 2
FIXED = (60_000.0, 150_000.0)
MARKET_NAMES = ("m0", "m1")
SYSTEM_NAMES = ("lean", "heavy")


def _price_matrix(seed: int = 2024) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = np.arange(T)
    p = 80 + 25 * np.sin(2 * np.pi * h / 24) \
        + rng.normal(0, 15, (N_MARKETS, T))
    p = np.where(rng.random(p.shape) < 0.02, p * rng.uniform(2, 5, p.shape),
                 p)
    p = np.where(rng.random(p.shape) < 0.03, p - 90, p)
    return p.astype(np.float32)


PRICES = _price_matrix()


def _policies(spec, elastic):
    """The six policies of `examples/fleet_backtest.py`."""
    return [
        spec("always_on"),
        spec("x1", x=0.01),
        spec("x3", x=0.03),
        spec("x3_hyst", x=0.03, hysteresis=0.9,
             restart_energy_mwh=0.3, restart_time_h=0.25),
        spec("x8_idle", x=0.08, idle_frac=0.05),
        elastic("x8_half_dp", level=0.5, dp_total=16, x=0.08),
    ]


@pytest.fixture(scope="module")
def jax_run():
    systems = [jax_make_system(f, 1.0, float(T)) for f in FIXED]
    grid = jax_build_grid(PRICES, systems,
                          _policies(JaxPolicySpec, jax_elastic_policy),
                          market_names=MARKET_NAMES,
                          system_names=SYSTEM_NAMES)
    report = jax_backtest(grid, use_pallas=False)
    return grid, report, jax_summarize(grid, report)


@pytest.fixture(scope="module")
def port_run(jax_run):
    jgrid = jax_run[0]
    grid = grid_from_numpy({f: np.asarray(getattr(jgrid, f))
                            for f in TENSOR_FIELDS},
                           market_names=jgrid.market_names,
                           system_names=jgrid.system_names,
                           policy_names=jgrid.policy_names, device=CPU)
    report = backtest(grid, device=CPU)
    return grid, report, summarize(grid, report)


def _port_grid():
    systems = [make_system(f, 1.0, float(T), device=CPU) for f in FIXED]
    return build_grid(PRICES, systems, _policies(PolicySpec, elastic_policy),
                      market_names=MARKET_NAMES, system_names=SYSTEM_NAMES,
                      device=CPU)


def test_build_grid_matches_reference_bit_for_bit(jax_run):
    jgrid, grid = jax_run[0], _port_grid()
    assert grid.n_rows == jgrid.n_rows == N_MARKETS * 2 * 6
    for name in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(grid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)),
                                      err_msg=name)
    for name in ("market_names", "system_names", "policy_names"):
        assert getattr(grid, name) == tuple(getattr(jgrid, name))


@pytest.mark.parametrize("field", ["cpc", "cpc_ao", "tco", "up_hours",
                                   "energy_cost", "restart_cost",
                                   "cpc_reduction"])
def test_report_matches_reference(jax_run, port_run, field):
    want = np.asarray(getattr(jax_run[1], field))
    got = getattr(port_run[1], field).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 if field == "cpc_reduction" else 0)


def test_report_decisions_match_reference(jax_run, port_run):
    jrep, rep = jax_run[1], port_run[1]
    np.testing.assert_array_equal(rep.n_starts.numpy(),
                                  np.asarray(jrep.n_starts))
    assert float(rep.n_starts.sum()) > 0
    np.testing.assert_allclose(rep.x_realized.numpy(),
                               np.asarray(jrep.x_realized), rtol=0,
                               atol=1e-6)
    for name in ("market_idx", "system_idx", "policy_idx"):
        np.testing.assert_array_equal(getattr(rep, name).numpy(),
                                      np.asarray(getattr(jrep, name)))


@pytest.mark.parametrize("field", ["reduction", "oracle_reduction",
                                   "regret", "best_reduction"])
def test_summary_reductions_match_reference(jax_run, port_run, field):
    np.testing.assert_allclose(getattr(port_run[2], field),
                               getattr(jax_run[2], field),
                               rtol=1e-5, atol=1e-6)


def test_summary_totals_and_best_policy_match_reference(jax_run, port_run):
    jsum, summ = jax_run[2], port_run[2]
    for name in ("energy_by_policy", "up_hours_by_policy", "total_cost",
                 "total_up_hours"):
        np.testing.assert_allclose(getattr(summ, name), getattr(jsum, name),
                                   rtol=1e-5, err_msg=name)
    top2 = np.sort(jsum.reduction, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    assert clear.any()
    np.testing.assert_array_equal(summ.best_policy[clear],
                                  jsum.best_policy[clear])
    assert summ.dispatch is None and summ.workload is None


def test_chunked_plan_is_bitwise_equal_to_single(port_run):
    grid, rep = port_run[0], port_run[1]
    plan = ExecutionPlan(mode="chunked", chunk_rows=5, contract="bitwise")
    chunked = backtest(grid, plan=plan, device=CPU)
    for name in rep._fields:
        assert torch.equal(getattr(chunked, name), getattr(rep, name)), name


def test_summary_is_row_permutation_invariant(port_run):
    grid, _, base = port_run
    order = np.random.default_rng(3).permutation(grid.n_rows)
    grid_p = grid.take_rows(order)
    perm = summarize(grid_p, backtest(grid_p, device=CPU))
    for field in base._fields:
        bv, pv = getattr(base, field), getattr(perm, field)
        if bv is None:
            assert pv is None, field
            continue
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(pv),
                                      err_msg=field)


def test_take_rows_carries_every_per_row_field(port_run):
    grid = port_run[0]
    order = np.random.default_rng(5).permutation(grid.n_rows)
    perm = grid.take_rows(order)
    shared = set(ScenarioGrid.SHARED_FIELDS)
    assert shared < {f.name for f in dataclasses.fields(ScenarioGrid)}
    for f in dataclasses.fields(ScenarioGrid):
        v, pv = getattr(grid, f.name), getattr(perm, f.name)
        if f.name in shared:
            assert pv is v, f.name
        else:
            assert v.shape[0] == grid.n_rows, f.name
            assert torch.equal(pv, v[torch.as_tensor(order)]), f.name


def test_sharded_plan_and_unported_options_raise(port_run):
    grid, rep = port_run[0], port_run[1]
    with pytest.raises(ValueError, match="shard"):
        backtest(grid, plan=ExecutionPlan(mode="sharded"), device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        backtest(grid, use_kernel=True, device=CPU)
    with pytest.raises(NotImplementedError, match="workload"):
        summarize(grid, rep, dispatch_cfg=DispatchConfig()._replace(
            workload=object()))
    with pytest.raises(NotImplementedError, match="workload"):
        summarize(grid, rep, workload=object())
    with pytest.raises(ValueError, match="missing"):
        grid_from_numpy({"prices": PRICES}, market_names=(),
                        system_names=(), policy_names=(), device=CPU)


def test_b1_threshold_row_matches_policy_cpc():
    """A single threshold row equals the single-trace `policy_cpc`."""
    sys_ = make_system(60_000.0, 1.0, float(T), device=CPU)
    grid = build_grid(PRICES[:1], [sys_], [PolicySpec("x3", x=0.03)],
                      device=CPU)
    rep = backtest(grid, device=CPU)
    prices = grid.prices[0]
    mask = threshold_policy(prices, grid.p_off[0], device=CPU)
    want = float(policy_cpc(sys_, prices, mask, device=CPU))
    assert float(rep.cpc[0]) == pytest.approx(want, rel=1e-5)
    assert float(rep.x_realized[0]) == pytest.approx(
        1.0 - float(mask.mean()), abs=1e-6)
    # and the summary's oracle column is optimal_shutdown's reduction
    psi = 60_000.0 / (T * float(prices.mean()))
    plan = optimal_shutdown(prices, psi, device=CPU)
    assert summarize(grid, rep).oracle_reduction[0, 0] == pytest.approx(
        float(plan.cpc_reduction), rel=1e-5)


def test_examples_run_on_the_cpu(capsys):
    grid, report, summ = fleet_backtest.run(CPU, hours=400, n_seeds=2)
    assert grid.n_rows == 2 * 3 * 6 and report.cpc.shape == (36,)
    fleet_backtest.print_tables(grid, summ)
    r = quickstart.lichtenberg(CPU)
    quickstart.report(r)
    out = capsys.readouterr().out
    assert "x8_half_dp" in out and "CPC reduction" in out
    assert r["p_avg"] == pytest.approx(77.84, rel=1e-5)
    assert 0.0 < r["x_opt"] < r["x_be"] < 0.1 and r["viable"]
    assert not r["weekly_viable"]
