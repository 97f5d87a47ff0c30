"""The port's market calibration (`repro_torch.core.calibration`,
`repro_torch.core.fit_presets`) against the JAX reference.

Torch draws differ from `jax.random`, so the fitted numbers are not
compared. The host arithmetic (`k_opt_from_table`, `nelder_mead`, the
theta box) is the reference's and equals it to rtol 1e-12; `interp_k`
and `target_loss` read the PV set through `price_variability`, which on
integer-valued prices (every float32 sum exact) equals the reference's
to rtol 1e-12 too. The calibration objective with the reference's draws
injected agrees within rtol 1e-5: the markets agree within
`tests/test_torch_markets.py`'s tolerances and the loss is a smooth
function of k at the target fractions.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import calibration as jcal  # noqa: E402
from repro.core import fit_presets as jfit  # noqa: E402
from repro.energy.markets import MarketParams as JMarketParams  # noqa: E402
from repro.energy.markets import generate_market as jgenerate  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import fit_presets as fit  # noqa: E402
from repro_torch.core.optimizer import break_even_fraction  # noqa: E402
from repro_torch.core.regions import PAPER_TABLE2  # noqa: E402
from repro_torch.energy import presets  # noqa: E402
from repro_torch.energy.markets import (MarketDraws, MarketParams,  # noqa: E402
                                        generate_market, generate_markets)
from repro_torch.energy.presets import region_params  # noqa: E402

CPU = "cpu"
EXACT = dict(rtol=1e-12, atol=0.0)
BREAK_EVEN_REGIONS = ("germany", "south_australia", "france")


def reference_draws(seed: int, n: int) -> MarketDraws:
    """The five random tensors `repro.energy.markets._generate_jit` draws
    (as in `tests/test_torch_markets.py`)."""
    key = jax.random.PRNGKey(seed)
    k_cloud, k_wind, k_noise, k_sp_e, k_sp_m = jax.random.split(key, 5)
    return MarketDraws(
        cloud=np.asarray(jax.random.normal(k_cloud, (n,))),
        wind=np.asarray(jax.random.normal(k_wind, (n,))),
        noise=np.asarray(jax.random.normal(k_noise, (n,))),
        spike_u=np.asarray(jax.random.uniform(k_sp_e, (n,))),
        spike_mag=np.asarray(jax.random.normal(k_sp_m, (n,))))


def _stacked(draws: list) -> MarketDraws:
    return MarketDraws(*(np.stack(d) for d in zip(*draws)))


def _integer_prices(seed: int, n: int = 3000) -> np.ndarray:
    """Integer-valued float32 prices with a spiky tail: every float32 sum
    of the PV set is exact, so both packages' PV sets are equal."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 120, n).astype(np.float32)
    spikes = rng.random(n) < 0.02
    p[spikes] += rng.integers(100, 900, int(spikes.sum()))
    return p


# ---------------------------------------------------------------------------
# targets and the host optimiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("region", sorted(PAPER_TABLE2))
def test_targets_and_k_opt_match_reference(region):
    got, want = fit.targets_for(region), jfit.targets_for(region)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    row = PAPER_TABLE2[region]
    if row.x_opt_pct is not None:
        args = (row.psi, row.x_opt_pct / 100, row.cpc_red_pct / 100)
        np.testing.assert_allclose(cal.k_opt_from_table(*args),
                                   jcal.k_opt_from_table(*args), **EXACT)
    assert fit._INIT_STYLE == jfit._INIT_STYLE


@pytest.mark.parametrize("seed", [0, 1])
def test_interp_k_and_target_loss_match_reference(seed):
    prices = _integer_prices(seed)
    xs = (1.0 / len(prices), 0.004, 0.0123, 0.05, 0.3)
    np.testing.assert_allclose(cal.interp_k(prices, xs, device=CPU),
                               jcal.interp_k(prices, xs), **EXACT)
    np.testing.assert_allclose(
        cal.interp_k(torch.as_tensor(prices), xs),
        jcal.interp_k(prices, xs), **EXACT)
    for weights in (None, (0.5, 2.0, 2.0, 1.0, 0.1)):
        t = cal.KTargets(xs=xs, ks=(9.0, 4.1, 3.0, 2.2, 1.3),
                         weights=weights)
        jt = jcal.KTargets(xs=xs, ks=t.ks, weights=weights)
        np.testing.assert_allclose(cal.target_loss(prices, t, device=CPU),
                                   jcal.target_loss(prices, jt), **EXACT)


def _fixed_objective():
    """A fixed numpy objective with curvature and a plateau region."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(6, 6))
    m = a @ a.T + np.eye(6)
    c = rng.normal(size=6)

    def f(x):
        d = x - c
        return float(d @ m @ d + 0.3 * np.sin(3 * x[0]) + np.abs(x).sum())
    return f


@pytest.mark.parametrize("case", ["quadratic", "fixed"])
def test_nelder_mead_matches_reference(case):
    if case == "quadratic":
        def f(x):
            return float(np.sum((x - np.arange(len(x))) ** 2))
        x0 = np.zeros(4)
    else:
        f, x0 = _fixed_objective(), np.linspace(-1, 1, 6)
    steps = 0.7 * np.ones(len(x0))
    for max_iter in (3, 40, 400):
        got = cal.nelder_mead(f, x0, steps, max_iter=max_iter)
        want = jcal.nelder_mead(f, x0, steps, max_iter=max_iter)
        np.testing.assert_allclose(got[0], want[0], **EXACT)
        np.testing.assert_allclose(got[1], want[1], **EXACT)
    if case == "quadratic":
        np.testing.assert_allclose(got[0], np.arange(4), atol=1e-2)


def test_theta_box_matches_reference():
    base = MarketParams(p_avg=77.84, seed=3, **fit._INIT_STYLE["germany"])
    jbase = JMarketParams(**dataclasses.asdict(base))
    theta = cal._params_to_theta(base)
    np.testing.assert_allclose(theta, jcal._params_to_theta(jbase), **EXACT)
    for t in (theta, theta + 0.7, theta - np.linspace(0, 2, len(theta))):
        assert dataclasses.asdict(cal._theta_to_params(base, t)) == \
            dataclasses.asdict(jcal._theta_to_params(jbase, t))
    assert cal._FIT_FIELDS == jcal._FIT_FIELDS
    np.testing.assert_array_equal(cal._LO, jcal._LO)
    np.testing.assert_array_equal(cal._HI, jcal._HI)


# ---------------------------------------------------------------------------
# the objective, with the reference's draws injected
# ---------------------------------------------------------------------------

def _reference_objective(base, targets, seeds, theta) -> float:
    """`repro.core.calibration.calibrate_market`'s inner objective."""
    params = jcal._theta_to_params(base, theta)
    tot = 0.0
    for s in seeds:
        prices = np.asarray(jgenerate(params.replace(seed=int(s))).prices)
        if prices.mean() <= 0:
            return 1e6
        tot += jcal.target_loss(prices, targets)
    return tot / len(seeds)


@pytest.mark.parametrize("region", ["germany", "france"])
def test_objective_matches_reference_with_injected_draws(region):
    row = PAPER_TABLE2[region]
    s0 = sum(ord(c) for c in region) * 7919 % (2 ** 16)
    seeds = (s0, s0 + 1, s0 + 2)
    base = MarketParams(p_avg=row.p_avg, seed=s0,
                        **fit._INIT_STYLE[region])
    jbase = JMarketParams(**dataclasses.asdict(base))
    tgt, jtgt = fit.targets_for(region), jfit.targets_for(region)
    draws = _stacked([reference_draws(s, base.n_hours) for s in seeds])
    objective = cal.calibration_objective(base, tgt, seeds, draws=draws,
                                          device=CPU)
    theta0 = cal._params_to_theta(base)
    for theta in (theta0, theta0 + 0.7, theta0 - 0.35 * np.arange(6) / 5):
        got = objective(theta)
        want = _reference_objective(jbase, jtgt, seeds, theta)
        assert np.isfinite(got) and got < 1e6
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_objective_guard_on_a_nonpositive_mean():
    """A market whose mean price is not positive scores 1e6, as in the
    reference."""
    base = MarketParams(p_avg=-5.0, n_hours=500, seed=1)
    tgt = fit.targets_for("germany")
    objective = cal.calibration_objective(base, tgt, (1, 2), device=CPU)
    assert objective(cal._params_to_theta(base)) == 1e6


def test_objective_batches_the_seeds():
    """One `generate_markets` call over the seeds gives the loss of each
    seed's market generated alone."""
    base = region_params("germany").replace(n_hours=2000)
    tgt = fit.targets_for("germany")
    seeds = (4, 9)
    theta = cal._params_to_theta(base)
    params = cal._theta_to_params(base, theta)
    one = [cal.target_loss(generate_market(params.replace(seed=s),
                                           device=CPU).prices, tgt)
           for s in seeds]
    got = cal.calibration_objective(base, tgt, seeds, device=CPU)(theta)
    np.testing.assert_allclose(got, np.mean(one), rtol=1e-6)


def test_calibrate_market_lowers_the_loss():
    base = region_params("germany").replace(n_hours=1500, spike_enter=0.02,
                                            spike_mu=2.0)
    tgt = fit.targets_for("germany")
    objective = cal.calibration_objective(base, tgt, (5,), device=CPU)
    start = objective(cal._params_to_theta(base))
    fitted, loss = cal.calibrate_market(base, tgt, max_iter=8, seeds=(5,),
                                        device=CPU)
    assert loss <= start
    np.testing.assert_allclose(
        loss, objective(cal._params_to_theta(fitted)), rtol=1e-6)


# ---------------------------------------------------------------------------
# fit_presets
# ---------------------------------------------------------------------------

def _digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_fit_presets_main_writes_only_its_out(tmp_path, monkeypatch,
                                              capsys):
    shipped = presets._PRESET_PATH
    assert fit.OUT == shipped
    before = _digest(shipped)
    out = tmp_path / "presets.json"
    monkeypatch.setattr(fit, "OUT", out)
    fit.main(["--regions", "germany", "--max-iter", "3"], device=CPU)
    assert _digest(shipped) == before
    written = json.loads(out.read_text())
    assert set(written) == {"germany"}
    fitted = MarketParams(**written["germany"])
    assert fitted.p_avg == PAPER_TABLE2["germany"].p_avg
    assert fitted.seed == sum(ord(c) for c in "germany") * 7919 % (2 ** 16)
    text = capsys.readouterr().out
    report = json.loads(text[:text.rindex("}") + 1])
    assert report["region"] == "germany"
    assert np.isfinite(report["loss"])
    assert len(report["k_fitted"]) == len(report["k_targets"]) == 3
    assert f"wrote {out}" in text


# ---------------------------------------------------------------------------
# the mirror of tests/test_markets.py::
# test_calibrated_regions_reproduce_paper_break_even
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("region", BREAK_EVEN_REGIONS)
def test_presets_reproduce_break_even_with_reference_draws(region):
    """With the reference's draws injected, the shipped presets land
    within rel 0.35 of Table II's break-even fraction, as the reference's
    own check asks of its generator."""
    params = region_params(region)
    draws = reference_draws(params.seed, params.n_hours)
    prices = generate_market(params, draws=draws, device=CPU).prices
    row = PAPER_TABLE2[region]
    x_be = float(break_even_fraction(prices, row.psi, device=CPU)) * 100
    assert x_be == pytest.approx(row.x_be_pct, rel=0.35), region


@pytest.mark.parametrize("region", BREAK_EVEN_REGIONS)
def test_presets_reproduce_break_even_over_seeds_on_port_draws(region):
    """On the port's own draws, the median break-even fraction over the
    preset seed s and the seven after it lies within rel 0.35 of Table II.

    The preset seed's own value is only required to be finite. France's
    x_BE is about 46 of 8760 hours and swings from seed to seed as widely
    in JAX as in torch: on the preset seed the port's draws give 0.753 %
    (the band is 0.345-0.716 %) and the reference's 0.422 %; over seeds
    s..s+7, 3 of the reference's 8 fall outside the band (0.719, 0.742,
    0.765) and 2 of the port's (0.753, 0.788). The reference's check
    passes on its own preset seed by the luck of that draw."""
    params = region_params(region)
    seeds = range(params.seed, params.seed + 8)
    prices = generate_markets([params.replace(seed=s) for s in seeds],
                              device=CPU).prices
    row = PAPER_TABLE2[region]
    x_be = np.array([float(break_even_fraction(p, row.psi, device=CPU))
                     for p in prices]) * 100
    assert np.isfinite(x_be[0])
    assert np.median(x_be) == pytest.approx(row.x_be_pct, rel=0.35), \
        (region, x_be)
