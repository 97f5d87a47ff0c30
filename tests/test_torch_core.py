"""The port's paper model (`repro_torch.core`, `runtime.elastic`) against
the JAX reference on shared numpy price series.

Tolerances: per-x arrays within rtol 1e-5 (float32 cumulative sums taken
in another order); shutdown fractions found by a search over the PV set
within one sample (1/T), since a last-bit difference in k(x) can move an
argmin or a crossing by one entry; CPC reductions within rtol 1e-4;
decisions (masks, viability) exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import optimizer as j_opt  # noqa: E402
from repro.core import policy as j_pol  # noqa: E402
from repro.core import price_model as j_pm  # noqa: E402
from repro.core import regions as j_reg  # noqa: E402
from repro.core import scenarios as j_sc  # noqa: E402
from repro.core import tco as j_tco  # noqa: E402
from repro.runtime import elastic as j_el  # noqa: E402
from repro_torch.core import optimizer as t_opt  # noqa: E402
from repro_torch.core import policy as t_pol  # noqa: E402
from repro_torch.core import price_model as t_pm  # noqa: E402
from repro_torch.core import regions as t_reg  # noqa: E402
from repro_torch.core import scenarios as t_sc  # noqa: E402
from repro_torch.core import tco as t_tco  # noqa: E402
from repro_torch.runtime import elastic as t_el  # noqa: E402

T = 1000
CPU = "cpu"


def _prices(seed: int, t: int = T) -> np.ndarray:
    """Diurnal prices with noise, rare multi-x spikes and negative hours."""
    rng = np.random.default_rng(seed)
    h = np.arange(t)
    p = 80 + 25 * np.sin(2 * np.pi * h / 24) + rng.normal(0, 15, t)
    p = np.where(rng.random(t) < 0.02, p * rng.uniform(2, 6, t), p)
    p = np.where(rng.random(t) < 0.03, p - 90, p)
    return p.astype(np.float32)


PRICES = [_prices(s) for s in (0, 1, 2)]
PSIS = [0.3, 1.0, 2.0, 4.0, 50.0]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("i", range(len(PRICES)))
def test_price_variability_matches(i):
    got = t_pm.price_variability(PRICES[i], device=CPU)
    want = j_pm.price_variability(PRICES[i])
    for name in want._fields:
        if name == "p_low":
            continue
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)
    # p_low = (sum p - top-m sum) / (n - m) is a difference of two float32
    # sums of size ~sum|p| over a count that reaches 1: its error is
    # relative to sum|p| / (n - m), not to p_low itself
    n_low = T - np.arange(1, T)
    scale = np.abs(PRICES[i]).sum() / n_low
    err = np.abs(_np(got.p_low) - _np(want.p_low))
    assert np.all(err <= 1e-5 * np.abs(_np(want.p_low)) + 1e-5 * scale)


def test_price_stats_and_threshold_match():
    xs = np.asarray([0.001, 0.01, 0.05, 0.3, 0.9], np.float32)
    got = t_pm.price_stats(PRICES[0], xs, device=CPU)
    want = j_pm.price_stats(PRICES[0], xs)
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), rtol=1e-5,
                                   atol=1e-3 if name == "p_low" else 0.0,
                                   err_msg=name)
    assert float(t_pm.threshold_price(PRICES[1], 0.02, device=CPU)) == \
        float(j_pm.threshold_price(PRICES[1], 0.02))


def test_resample_and_region_means_match():
    np.testing.assert_allclose(
        _np(t_pm.resample(PRICES[0], 24, device=CPU)),
        _np(j_pm.resample(jnp.asarray(PRICES[0]), 24)), rtol=1e-6)
    got = t_pm.region_means(77.84, 4.97, 0.008)
    want = j_pm.region_means(77.84, 4.97, 0.008)
    np.testing.assert_allclose(got, [float(w) for w in want], rtol=1e-6)


def test_dtype_rule_float64_stays_float64():
    pv64 = t_pm.price_variability(PRICES[0].astype(np.float64), device=CPU)
    pv32 = t_pm.price_variability(PRICES[0].astype(np.float16), device=CPU)
    assert pv64.k.dtype == torch.float64
    assert pv32.k.dtype == torch.float32


@pytest.mark.parametrize("psi", PSIS)
@pytest.mark.parametrize("i", range(len(PRICES)))
def test_optimal_shutdown_matches(i, psi):
    got = t_opt.optimal_shutdown(PRICES[i], psi, device=CPU)
    want = j_opt.optimal_shutdown(PRICES[i], psi)
    assert bool(got.viable) == bool(want.viable)
    assert abs(float(got.x_opt) - float(want.x_opt)) <= 1.0 / T + 1e-7
    assert abs(float(got.x_break_even) - float(want.x_break_even)) \
        <= 1.0 / T + 1e-7
    np.testing.assert_allclose(float(got.cpc_reduction),
                               float(want.cpc_reduction), rtol=1e-4)
    np.testing.assert_allclose(float(got.p_avg), float(want.p_avg),
                               rtol=1e-6)
    if bool(want.viable) and float(got.x_opt) == float(want.x_opt):
        np.testing.assert_allclose(float(got.k_opt), float(want.k_opt),
                                   rtol=1e-5)
        assert float(got.p_thresh) == float(want.p_thresh)


def test_break_even_fraction_and_psi_sweep_match():
    for psi in PSIS:
        got = float(t_opt.break_even_fraction(PRICES[2], psi, device=CPU))
        want = float(j_opt.break_even_fraction(PRICES[2], psi))
        assert abs(got - want) <= 1.0 / T + 1e-7, psi
    psis = np.geomspace(0.1, 10, 25).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_opt.psi_sweep(PRICES[0], psis, device=CPU)),
        _np(j_opt.psi_sweep(PRICES[0], jnp.asarray(psis))),
        rtol=1e-4, atol=1e-7)


def test_cpc_formulas_match():
    rng = np.random.default_rng(4)
    psi = rng.uniform(0.1, 6, 200).astype(np.float32)
    k = rng.uniform(1, 10, 200).astype(np.float32)
    x = rng.uniform(0.001, 0.5, 200).astype(np.float32)
    tt = [torch.as_tensor(a) for a in (psi, k, x)]
    jj = [jnp.asarray(a) for a in (psi, k, x)]
    for name in ("cpc_ratio", "cpc_reduction"):
        np.testing.assert_allclose(_np(getattr(t_tco, name)(*tt)),
                                   _np(getattr(j_tco, name)(*jj)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(_np(t_tco.shutdowns_viable(tt[0], tt[1])),
                                  _np(j_tco.shutdowns_viable(jj[0], jj[1])))
    sys_t = t_tco.make_system(60_000.0, 1.5, 8760.0, device=CPU)
    sys_j = j_tco.make_system(60_000.0, 1.5, 8760.0)
    for name in ("cpc_always_on", "energy_cost_always_on", "psi"):
        np.testing.assert_allclose(
            float(getattr(t_tco, name)(sys_t, 77.84)),
            float(getattr(j_tco, name)(sys_j, 77.84)), rtol=1e-6,
            err_msg=name)
    for name in ("cpc_with_shutdowns", "energy_cost_with_shutdowns"):
        np.testing.assert_allclose(
            float(getattr(t_tco, name)(sys_t, 77.84, 4.9, 0.01)),
            float(getattr(j_tco, name)(sys_j, 77.84, 4.9, 0.01)),
            rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("band", [(0.8, 1.0), (1.0, 1.0)])
def test_policies_and_policy_cpc_match(band):
    p = PRICES[1]
    q = np.quantile(p, 0.95).astype(np.float32)
    p_on, p_off = float(q * band[0]), float(q * band[1])
    m_t = t_pol.hysteresis_policy(p, p_on, p_off, device=CPU)
    m_j = j_pol.hysteresis_policy(jnp.asarray(p), p_on, p_off)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    th_t = t_pol.threshold_policy(p, p_off, device=CPU)
    th_j = j_pol.threshold_policy(p, p_off)
    np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))
    sys_t = t_tco.make_system(60_000.0, 1.0, float(T), device=CPU)
    sys_j = j_tco.make_system(60_000.0, 1.0, float(T))
    kw = dict(idle_power_frac=0.07, restart_energy_mwh=0.4,
              restart_time_h=0.5)
    for init in (1.0, 0.0):
        got = t_pol.policy_cpc(sys_t, p, m_t, initial_uptime=init,
                               device=CPU, **kw)
        want = j_pol.policy_cpc(sys_j, jnp.asarray(p), m_j,
                                initial_uptime=init, **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        float(t_pol.policy_energy_cost(sys_t, p, th_t, 0.1, device=CPU)),
        float(j_pol.policy_energy_cost(sys_j, jnp.asarray(p), th_j, 0.1)),
        rtol=1e-5)


def test_hysteresis_policy_batches_over_leading_axes():
    batch = np.stack(PRICES)
    masks = t_pol.hysteresis_policy(batch, 60.0, 120.0, device=CPU)
    for i, p in enumerate(PRICES):
        assert torch.equal(masks[i], t_pol.hysteresis_policy(
            p, 60.0, 120.0, device=CPU))


def test_scenarios_match():
    rng = np.random.default_rng(8)
    fossil = rng.uniform(0, 2, T).astype(np.float32)
    ren = np.where(rng.random(T) < 0.05, 0.0,
                   rng.uniform(0, 2, T)).astype(np.float32)
    fossil[:10] = 0.0
    ren[:10] = 0.0
    beta_t = t_sc.fossil_share(fossil, ren, device=CPU)
    beta_j = j_sc.fossil_share(fossil, ren)
    np.testing.assert_allclose(beta_t.numpy(), np.asarray(beta_j),
                               rtol=1e-6)
    np.testing.assert_allclose(
        t_sc.amplify_volatility(PRICES[0], beta_t, device=CPU).numpy(),
        np.asarray(j_sc.amplify_volatility(PRICES[0], beta_j)), rtol=1e-6)
    assert t_sc.scale_fixed_costs(2.0, 0.8) == pytest.approx(
        float(j_sc.scale_fixed_costs(2.0, 0.8)))


def test_region_rows_match():
    prices = {"germany": PRICES[0], "finland": PRICES[1] * 0.6,
              "france": PRICES[2] * 0.75}
    got = t_reg.regional_table(prices, device=CPU)
    want = j_reg.regional_table(prices)
    assert [r.region for r in got] == [r.region for r in want]
    for g, w in zip(got, want):
        assert g.p_avg == pytest.approx(w.p_avg, rel=1e-6)
        assert g.psi == pytest.approx(w.psi, rel=1e-6)
        for name in ("x_be_pct", "x_opt_pct"):
            gv, wv = getattr(g, name), getattr(w, name)
            assert (gv is None) == (wv is None)
            if gv is not None:
                assert abs(gv - wv) <= 100.0 / T + 1e-5
        if w.cpc_red_pct is not None:
            assert g.cpc_red_pct == pytest.approx(w.cpc_red_pct, rel=1e-4)
    assert t_reg.PAPER_TABLE2 == j_reg.PAPER_TABLE2


def test_capacity_plan_and_schedule_match():
    for level in (0.1, 0.25, 0.5, 0.75, 1.0):
        for dp in (1, 3, 8, 16):
            assert t_el.capacity_plan(level, dp, 4) == \
                t_el.CapacityLevel(**vars(j_el.capacity_plan(level, dp, 4)))
    plans = {"a": {"viable": True, "p_thresh": 120.0},
             "b": {"viable": False, "p_thresh": 10.0},
             "c": {"viable": True, "p_thresh": 90.0}}
    power = {"a": 1.0, "b": 2.0, "c": 0.5}
    np.testing.assert_array_equal(
        t_el.capacity_schedule(PRICES[0], plans, power),
        j_el.capacity_schedule(PRICES[0], plans, power))
    assert not t_el.capacity_schedule(PRICES[0], {}, {}).any()
