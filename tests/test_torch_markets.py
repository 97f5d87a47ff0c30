"""The port's market generator and presets against the JAX reference.

`jax.random` cannot be reproduced in torch, so the tests draw the
reference's own random tensors (repeating its key split and its
`jax.random.normal`/`uniform` calls) and hand them to the port as
``draws=``; everything else is deterministic shaping that must agree.

Tolerances: prices within rtol 1e-5 plus atol 1e-5 * p_avg * (1 + m_t),
m_t the hour's spike multiplier — a price is a relative level times
p_avg, a near-zero level carries the absolute rounding of the level
itself (the transcendental functions differ in the last bits), and a
spike multiplies that rounding by 1 + m_t; generation volumes (relative
units ~1) within rtol 1e-5, atol 1e-5; the target mean p_avg to 1e-5
relative.
"""

import dataclasses
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.energy.markets import generate_market as jax_generate_market  # noqa: E402
from repro.energy.presets import region_params as jax_region_params  # noqa: E402
from repro_torch.energy.markets import (MarketDraws, MarketParams,  # noqa: E402
                                        generate_market, generate_markets,
                                        market_draws)
from repro_torch.energy.presets import (REGION_PRESETS, default_seed,  # noqa: E402
                                        region_params)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def reference_draws(seed: int, n: int) -> MarketDraws:
    """The five random tensors `repro.energy.markets._generate_jit` draws."""
    key = jax.random.PRNGKey(seed)
    k_cloud, k_wind, k_noise, k_sp_e, k_sp_m = jax.random.split(key, 5)
    return MarketDraws(
        cloud=np.asarray(jax.random.normal(k_cloud, (n,))),
        wind=np.asarray(jax.random.normal(k_wind, (n,))),
        noise=np.asarray(jax.random.normal(k_noise, (n,))),
        spike_u=np.asarray(jax.random.uniform(k_sp_e, (n,))),
        spike_mag=np.asarray(jax.random.normal(k_sp_m, (n,))))


def spike_multiplier(params, draws: MarketDraws) -> np.ndarray:
    """m_t of the reference's spike regime, replayed from its draws."""
    u = np.asarray(draws.spike_u, np.float32)
    mag = np.minimum(np.exp(np.float32(params.spike_mu) + np.float32(
        params.spike_sigma) * np.asarray(draws.spike_mag, np.float32)),
        np.float32(params.spike_cap))
    spiking, state = np.zeros(u.shape, bool), False
    for t, ut in enumerate(u):
        state = ut < (np.float32(params.spike_stay) if state
                      else np.float32(params.spike_enter))
        spiking[t] = state
    return np.where(spiking, mag, 0.0)


def _assert_market_close(got, want, params, draws):
    atol = 1e-5 * params.p_avg * (1.0 + spike_multiplier(params, draws))
    err = np.abs(got.prices.numpy() - np.asarray(want.prices))
    assert np.all(err <= 1e-5 * np.abs(np.asarray(want.prices)) + atol)
    for name in ("demand", "fossil", "renewable"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_german_year_matches_reference_with_injected_draws():
    params = region_params("germany")
    assert params == MarketParams(**vars(jax_region_params("germany")))
    draws = reference_draws(params.seed, params.n_hours)
    got = generate_market(params, draws=draws, device=CPU)
    want = jax_generate_market(jax_region_params("germany"))
    assert got.prices.shape == (8760,)
    _assert_market_close(got, want, params, draws)
    assert float(got.prices.mean()) == pytest.approx(params.p_avg, rel=1e-5)


@pytest.mark.parametrize("region", ["france", "south_australia"])
def test_short_calibrated_markets_match_reference(region):
    params = region_params(region, seed=5).replace(n_hours=1200)
    draws = reference_draws(params.seed, params.n_hours)
    got = generate_market(params, draws=draws, device=CPU)
    want = jax_generate_market(
        jax_region_params(region, seed=5).replace(n_hours=1200))
    _assert_market_close(got, want, params, draws)
    assert float(got.prices.mean()) == pytest.approx(params.p_avg, rel=1e-5)


def test_batched_generation_matches_one_market_at_a_time():
    params = [region_params("germany", seed=s).replace(n_hours=600)
              for s in range(3)]
    per = [reference_draws(p.seed, p.n_hours) for p in params]
    draws = MarketDraws(*(np.stack(d) for d in zip(*per)))
    batch = generate_markets(params, draws=draws, device=CPU)
    assert batch.prices.shape == (3, 600)
    for i, p in enumerate(params):
        one = generate_market(p, draws=per[i], device=CPU)
        for name in one._fields:
            np.testing.assert_allclose(getattr(batch, name)[i].numpy(),
                                       getattr(one, name).numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_torch_draws_hit_the_target_mean_and_repeat_by_seed():
    params = region_params("germany", seed=3).replace(n_hours=2000)
    a = generate_market(params, device=CPU)
    b = generate_market(params, device=CPU)
    c = generate_market(params.replace(seed=4), device=CPU)
    assert torch.equal(a.prices, b.prices)
    assert not torch.equal(a.prices, c.prices)
    assert float(a.prices.mean()) == pytest.approx(params.p_avg, rel=1e-5)
    assert bool(torch.isfinite(a.prices).all())
    d = market_draws(3, 2000, device=CPU)
    assert all(x.shape == (2000,) and x.dtype == torch.float32 for x in d)
    assert float(d.spike_u.min()) >= 0.0 and float(d.spike_u.max()) < 1.0


def test_bad_draw_shapes_raise():
    params = MarketParams(n_hours=48)
    draws = MarketDraws(*(np.zeros(47, np.float32) for _ in range(5)))
    with pytest.raises(ValueError, match="draws"):
        generate_market(params, draws=draws, device=CPU)
    with pytest.raises(ValueError, match="n_hours"):
        generate_markets([params, params.replace(n_hours=24)], device=CPU)


def test_market_presets_json_is_a_byte_identical_copy():
    port = ROOT / "src" / "repro_torch" / "configs" / "market_presets.json"
    ref = ROOT / "src" / "repro" / "configs" / "market_presets.json"
    assert port.read_bytes() == ref.read_bytes()
    assert json.loads(port.read_text())


def test_region_params_match_reference_but_the_seed_of_defaults():
    baked = json.loads((ROOT / "src" / "repro_torch" / "configs"
                        / "market_presets.json").read_text())
    for region in REGION_PRESETS:
        got = dataclasses.asdict(region_params(region))
        want = dataclasses.asdict(jax_region_params(region))
        if region not in baked:
            # the reference seeds defaults with the per-process salted
            # hash(); the port with a stable CRC-32
            got.pop("seed")
            want.pop("seed")
        assert got == want, region
    assert region_params("germany", seed=11).seed == 11


def test_default_seed_is_stable_across_processes():
    """The reference's `hash(region)` changes with PYTHONHASHSEED; the
    port's default seed must not."""
    assert default_seed("spain") == zlib.crc32(b"spain") % 2 ** 31
    assert default_seed("spain") == 1146089528
    code = ("from repro_torch.energy.presets import region_params;"
            "print(region_params('spain').seed)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    seeds = {subprocess.run([sys.executable, "-c", code], check=True,
                            capture_output=True, text=True,
                            env=dict(env, PYTHONHASHSEED=h)).stdout.strip()
             for h in ("0", "1", "12345")}
    assert seeds == {"1146089528"}
