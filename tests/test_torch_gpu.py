"""The CUDA `fleet_scan` kernel on the card, held against its plain
PyTorch version. Marked ``gpu``: without a CUDA device every test skips.
Imports neither JAX nor the reference, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: start counts equal; sums within rtol 2e-5 / atol 1e-3 of the
plain version run in float64 on the same inputs (the float32 plain run's
own running-sum drift over 8760 hours exceeds 2e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.tco import make_system  # noqa: E402
from repro_torch.fleet import PolicySpec, backtest, build_grid  # noqa: E402
from repro_torch.kernels.fleet_scan import fleet_scan  # noqa: E402
from repro_torch.kernels.ref import fleet_scan_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(b, t, seed, dev):
    rng = np.random.default_rng(seed)
    p_off = rng.uniform(40, 160, b)
    arrays = (rng.normal(80, 40, (b, t)), p_off * rng.uniform(0.7, 1.0, b),
              p_off, rng.uniform(0.0, 0.6, b), rng.uniform(0.0, 0.3, b))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in arrays]


@pytest.mark.parametrize("case", [(1, 64), (5, 333), (130, 1000),
                                  (64, 4097), (1024, 8760)])
def test_kernel_matches_plain_version(cuda, case):
    args = _inputs(*case, seed=sum(case), dev=cuda)
    before = fleet_scan.launches
    got = fleet_scan(*args)
    assert fleet_scan.launches == before + 1
    plain = fleet_scan(*args, use_kernel=False)
    exact = fleet_scan_ref(args[0].double(), *args[1:])
    assert torch.equal(got.n_starts, plain.n_starts)
    for g, e in zip(got, exact):
        torch.testing.assert_close(g.double(), e, rtol=2e-5, atol=1e-3)


def test_kernel_refuses_what_it_does_not_take(cuda):
    p, p_on, p_off, lvl, idle = _inputs(4, 100, seed=1, dev=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fleet_scan(p.T.contiguous().T, p_on, p_off, lvl, idle)
    with pytest.raises(ValueError, match="float32"):
        fleet_scan(p.double(), p_on, p_off, lvl, idle)
    with pytest.raises(ValueError, match="parameters"):
        fleet_scan(p, p_on.cpu(), p_off, lvl, idle)
    with pytest.raises(ValueError, match="parameters"):
        fleet_scan(p, p_on[:3], p_off, lvl, idle)


def test_backtest_on_the_card_matches_the_cpu(cuda):
    prices = np.random.default_rng(4).lognormal(4.3, 0.5, (3, 1500))
    reports = {}
    for dev in ("cpu", cuda):
        grid = build_grid(prices.astype(np.float32),
                          [make_system(9e4, 1.0, 1500.0, device=dev)],
                          [PolicySpec("ao"), PolicySpec("x2", x=0.02),
                           PolicySpec("h", x=0.05, hysteresis=0.9,
                                      off_level=0.25, idle_frac=0.1,
                                      restart_energy_mwh=0.3)],
                          device=dev)
        reports[str(dev)] = backtest(grid, device=dev)
    gpu, cpu = reports[str(cuda)], reports["cpu"]
    assert torch.equal(gpu.n_starts.cpu(), cpu.n_starts)
    for name in ("cpc", "cpc_ao", "tco", "up_hours"):
        torch.testing.assert_close(getattr(gpu, name).cpu(),
                                   getattr(cpu, name), rtol=1e-5, atol=0.0)
