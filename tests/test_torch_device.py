"""The device rule: every entry point takes ``device=None``, meaning
"cuda", and raises without CUDA unless the caller passes ``device="cpu"``
— it never falls back to the CPU on its own. `torch.cuda.is_available`
is patched so that this also holds on a machine with a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import optimizer, policy, price_model, regions  # noqa: E402
from repro_torch.core.tco import make_system  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.energy.markets import (MarketParams, generate_market,  # noqa: E402
                                        generate_markets, market_draws)
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.fleet import PolicySpec, backtest, build_grid  # noqa: E402

PRICES = np.random.default_rng(0).normal(80, 30, (2, 96)).astype(np.float32)
MARKET = MarketParams(n_hours=48)


def _cpu_grid():
    return build_grid(PRICES, [make_system(1e4, 1.0, 96.0, device="cpu")],
                      [PolicySpec("ao"), PolicySpec("x5", x=0.05)],
                      device="cpu")


ENTRY_POINTS = {
    "resolve_device": lambda **kw: resolve_device(**kw),
    "make_system": lambda **kw: make_system(1.0, 1.0, 1.0, **kw),
    "market_draws": lambda **kw: market_draws(0, 48, **kw),
    "generate_market": lambda **kw: generate_market(MARKET, **kw),
    "generate_markets": lambda **kw: generate_markets([MARKET], **kw),
    "price_variability": lambda **kw: price_model.price_variability(
        PRICES[0], **kw),
    "optimal_shutdown": lambda **kw: optimizer.optimal_shutdown(
        PRICES[0], 2.0, **kw),
    "psi_sweep": lambda **kw: optimizer.psi_sweep(PRICES[0], [1.0], **kw),
    "hysteresis_policy": lambda **kw: policy.hysteresis_policy(
        PRICES[0], 60.0, 90.0, **kw),
    "compute_region_row": lambda **kw: regions.compute_region_row(
        "germany", PRICES[0], **kw),
    "build_grid": lambda **kw: build_grid(
        PRICES, [make_system(1e4, 1.0, 96.0, device="cpu")],
        [PolicySpec("ao")], **kw),
    "backtest": lambda **kw: backtest(_cpu_grid(), **kw),
    "quickstart": lambda **kw: quickstart.lichtenberg(kw.get("device")),
}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(set(ENTRY_POINTS) - {"quickstart"}))
def test_entry_point_runs_on_the_cpu_when_asked(no_cuda, name):
    ENTRY_POINTS[name](device="cpu")


def test_explicit_cuda_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
