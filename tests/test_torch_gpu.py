"""The CUDA kernels on the card (`fleet_scan`, the soft-scan forward and
backward, `dispatch_scan`, the three soft-dispatch kernels, flash and
decode attention, the SSD chunk scan), held against their plain PyTorch
versions, and the backtest, the tuner (plain and dispatch-aware), the
dispatch summary and the serving engine (dense, mamba2 and zamba2) on
the card against the CPU; one seed's market and parameters drawn for the card
equal the CPU's; the three serving kernels refuse inputs that need grad;
the training slice's Functions, batch, compression and step.
Marked ``gpu``:
without a CUDA device every test skips. Imports neither JAX nor the
reference, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: start counts equal; fleet-scan sums within rtol 2e-5 / atol
1e-3 of the plain version run in float64 on the same inputs (the float32
plain run's own running-sum drift over 8760 hours exceeds 2e-5), and
equal bit for bit to its segmented mirror run on the card, to a second
launch and, read through ``market_idx``, to the gathered form; soft
states within atol 1e-5 and soft gradients within rtol 2e-5 (d_p: atol
1e-5 max|d_p|) of the plain blocked versions in float64, with a positive
cotangent so the threshold sums carry no cancellation, at any positive
block_t, and equal bit for bit to their segmented mirrors run on the card
(the kernels' windows, maps, scans and sums in plain PyTorch, every
operation rounded once as the kernels, built without FMA contraction,
round it); the tuner's CPC on
the card within rtol 1e-4 of the CPU's, with the same source per row;
the dispatch kernel bitwise equal to its plain version (the two share
one summation order), and so the dispatch summary on the card equal to
the CPU's. The soft-dispatch kernels against their plain versions run on
the CPU on the same inputs: allocations within 1e-5 MW, entering dwell
within 1e-4, levels within 1e-3 EUR/MWh (or, in an hour where the fill
is flat at the demand between the two levels, `soft_level_in_gap`, a
level at which the plain hour places the same load), every backward output, from the kernel's
residuals and from the plain version's, within 1e-4 of the larger of its
own scale and the cotangent's (the two share every float32 operation, a
correctly rounded exp included, and differ in the order of their float64
sums), at the reference's soft cases and at blocks of more than one
warp (64, 45 and 130 sites), and at one to 32 warps a group with every
count of bisection levels a round (1 to 1024 sites, 400 among them;
n_bisect 0, 7, 30, 31, zero-demand hours; a second run equal bit for
bit); the forward kernel's allocation equal to the fused forward's bit
for bit (one kernel); one kernel on the card a forward call and two a
backward call; the backward's scratch the call's own (two streams' calls
equal each run alone); the dispatch-aware tuner on the card within rtol
1e-3 of the CPU's CPCs, with the same source and chosen set. The
attention kernels against their plain versions on the card: float32
within atol = rtol = 2e-5, bfloat16 within 2e-2 (the reference's kernel
tolerances; the two share tiles and casts and differ
in the order of float32 sums); the reduced serving engine on the card at
float32 returns the CPU's tokens. The SSD kernel against its plain
version on the card: y and the final state within 1e-4 of the output's
scale (the two share every cast and differ in the order of float32 sums,
the cumsum's included). The training slice: the flash and SSD kernels
under autograd (the model's `FlashAttention` and `SSDScan`) against
autograd through the plain versions, every gradient within 1e-4
(float32) or 3e-2 (bf16) of max(max |plain gradient|, 1) (the
Functions' backward is the analytic gradient in float32, the plain
route's the derivative of the computed forward; bf16 rounds to 8 bits);
the pipeline's batch on the card equal to the CPU's; int8 quantisation on
the card equal to the CPU's bit for bit; a 2-layer float32 training step
through the kernels within 1e-5 (loss) and 1e-4 (each gradient leaf's
largest entry) of the plain route. The work ledger's kernels
(`csrc/queue_scan.cu`) against their plain hour loops on the card: the
hard ledger bit for bit on integer-valued work and within rtol 1e-5
otherwise (its hour in closed form, sums in another order), telemetry
changing no other bit, and equal bit for bit to its mirror
(`ref.workload_ledger_seg_ref`) run on the card; the soft pair in float64 within 1e-10 of max(1, each output's
largest entry) of the plain loop and of autograd through it, in float32
within rtol 1e-5, and equal bit for bit to its mirrors run on the card
(the kernels' scans, trees and sums in their order); the workload-coupled
backtest's report equal to `backtest`'s bit for bit, a zero-fault
`faulted_backtest` too, a storm's start counts equal to the CPU's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _dispatch_cases import cut_case  # noqa: E402
from repro_torch.core.tco import make_system  # noqa: E402
from repro_torch.dispatch import (DispatchConfig, segment_keys,  # noqa: E402
                                  segment_rank)
from repro_torch.execution import Coupling  # noqa: E402
from repro_torch.fleet import (PolicySpec, backtest, build_grid,  # noqa: E402
                               summarize)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.inputs import reduced_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.dispatch_scan import dispatch_scan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fleet_scan import fleet_scan  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_plain,  # noqa: E402
                                     dispatch_ref,
                                     flash_attention_plain, fleet_scan_ref,
                                     fleet_scan_seg_ref, soft_dispatch_bwd_ref,
                                     soft_scan_bwd_seg_ref,
                                     soft_scan_fwd_seg_ref,
                                     soft_dispatch_fwd_ref,
                                     soft_dispatch_hour_fixed,
                                     soft_dispatch_ref, soft_level_in_gap,
                                     ssd_scan_plain)
from repro_torch.kernels.soft_dispatch import (  # noqa: E402
    soft_dispatch, soft_dispatch_fused_bwd, soft_dispatch_fused_fwd,
    soft_dispatch_scan)
from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,  # noqa: E402
                                               soft_scan_fwd,
                                               soft_state_fused)
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import (Request, ServeConfig,  # noqa: E402
                                 ServingEngine)
from repro_torch.tune import TuneConfig, optimize  # noqa: E402

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


FLEET_SHAPES = [(1, 64), (5, 333), (130, 1000), (64, 4097), (1024, 8760),
                (3, 9300)]


@pytest.mark.parametrize("case", FLEET_SHAPES)
def test_kernel_matches_plain_version(cuda, case):
    """Start counts equal to the plain float32 version, sums within rtol
    2e-5 of the plain version in float64, every output equal bit for bit
    to the segmented mirror run on the card and to a second launch; one
    kernel on the card a call."""
    args = _inputs(*case, seed=sum(case), dev=cuda)
    before = (fleet_scan.launches, fleet_scan.device_launches)
    got = fleet_scan(*args)
    assert (fleet_scan.launches, fleet_scan.device_launches) == \
        (before[0] + 1, before[1] + 1)
    plain = fleet_scan(*args, use_kernel=False)
    exact = fleet_scan_ref(args[0].double(), *args[1:])
    assert torch.equal(got.n_starts, plain.n_starts)
    for g, e in zip(got, exact):
        torch.testing.assert_close(g.double(), e, rtol=2e-5, atol=1e-3)
    mirror = fleet_scan_seg_ref(*args)
    again = fleet_scan(*args)
    for g, m, a in zip(got, mirror, again):
        assert torch.equal(g, m) and torch.equal(g, a)


@pytest.mark.parametrize("case", FLEET_SHAPES)
def test_indexed_kernel_equals_the_gathered_kernel(cuda, case):
    """Rows read through ``market_idx`` from an [N, T] block give the bits
    of the same kernel on the gathered [B, T] block."""
    b, t = case
    n = max(1, b // 8)
    markets = _inputs(n, t, seed=b + t, dev=cuda)[0]
    params = _inputs(b, 1, seed=b, dev=cuda)[1:]
    mi = torch.as_tensor(np.random.default_rng(t).integers(0, n, b),
                         device=cuda)
    got = fleet_scan(markets, *params, market_idx=mi)
    want = fleet_scan(markets[mi].contiguous(), *params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", [3, -1])
def test_kernel_stops_on_an_index_out_of_range(cuda, bad):
    """An index outside [0, N) traps on the card and raises at the next
    synchronisation (in a process of its own: the trap ends its CUDA
    context)."""
    script = (
        "import sys, torch\n"
        "from repro_torch.kernels.fleet_scan import fleet_scan\n"
        "p = torch.zeros((3, 100), device='cuda')\n"
        f"mi = torch.tensor([0, {bad}, 1], device='cuda')\n"
        "try:\n"
        "    fleet_scan(p, 1.0, 2.0, 0.0, 0.0, market_idx=mi)\n"
        "    torch.cuda.synchronize()\n"
        "except Exception as e:\n"
        "    print('raised:', e)\n"
        "    sys.exit(0)\n"
        "sys.exit(1)\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", script], text=True,
                          capture_output=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=src))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised:" in proc.stdout


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
    mi = torch.tensor([0, 1, 2, 3], device=cuda)
    with pytest.raises(ValueError, match="market_idx"):
        fleet_scan(p, p_on, p_off, lvl, idle, market_idx=mi.int())
    with pytest.raises(ValueError, match="market_idx"):
        fleet_scan(p, p_on, p_off, lvl, idle, market_idx=mi.cpu())
    with pytest.raises(ValueError, match="parameters"):
        fleet_scan(p, p_on, p_off, lvl, idle, market_idx=mi[:3])


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


def _soft_inputs(b, t, seed, dev):
    p, p_on, p_off = _inputs(b, t, seed, dev)[:3]
    g = torch.as_tensor(np.random.default_rng(seed + 1).uniform(
        0.5, 1.5, (b, t)), dtype=torch.float32, device=dev)
    return p, p_on, p_off, torch.tensor([1 / 3.0], device=dev), g


@pytest.mark.parametrize("case", [(1, 64, 64), (130, 1000, 256),
                                  (256, 2190, 256)])
def test_soft_kernels_match_plain_versions(cuda, case):
    b, t, bt = case
    p, p_on, p_off, itau, g = _soft_inputs(b, t, sum(case), cuda)
    f64 = [x.double() for x in (p, p_on, p_off, itau)]
    before = (soft_scan_fwd.launches, soft_scan_bwd.launches)
    s, carries = soft_scan_fwd(p, p_on, p_off, itau, block_t=bt)
    got = soft_scan_bwd(p, p_on, p_off, itau, carries, g, block_t=bt)
    assert (soft_scan_fwd.launches, soft_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    s64, c64 = soft_scan_fwd(*f64, block_t=bt, use_kernel=False)
    want = soft_scan_bwd(*f64, c64, g.double(), block_t=bt,
                         use_kernel=False)
    torch.testing.assert_close(s.double(), s64, rtol=0, atol=1e-5)
    torch.testing.assert_close(carries.double(), c64, rtol=0, atol=1e-5)
    torch.testing.assert_close(got[0].double(), want[0], rtol=2e-5,
                               atol=1e-5 * float(want[0].abs().max()))
    for k in (1, 2, 3):             # d_p_on, d_p_off, d_inv_tau
        torch.testing.assert_close(got[k].double(), want[k], rtol=2e-5,
                                   atol=0.0)
    no_dp = soft_scan_bwd(p, p_on, p_off, itau, carries, g, block_t=bt,
                          want_dp=False)
    assert no_dp[0] is None
    for k in (1, 2, 3):             # deterministic: the same bits again
        assert torch.equal(no_dp[k], got[k])


def test_soft_kernels_refuse_what_they_do_not_take(cuda):
    p, p_on, p_off, itau, g = _soft_inputs(4, 100, 3, cuda)
    with pytest.raises(ValueError, match="float32"):
        soft_scan_fwd(p.double(), p_on, p_off, itau)
    with pytest.raises(ValueError, match="contiguous"):
        soft_scan_fwd(p.T.contiguous().T, p_on, p_off, itau)
    with pytest.raises(ValueError, match="on cuda"):
        soft_scan_fwd(p, p_on.cpu(), p_off, itau)
    with pytest.raises(ValueError, match="positive"):
        soft_scan_fwd(p, p_on, p_off, itau, block_t=0)
    _, carries = soft_scan_fwd(p, p_on, p_off, itau)
    with pytest.raises(ValueError, match="g must be"):
        soft_scan_bwd(p, p_on, p_off, itau, carries, g[:, :50])
    with pytest.raises(ValueError, match="carries"):
        soft_scan_bwd(p, p_on, p_off, itau, carries[:, :0], g)
    s = soft_state_fused(p, p_on, p_off, tau=3.0)   # autograd route
    assert s.shape == p.shape


@pytest.mark.parametrize("case", [(3, 2190, 1), (3, 2190, 48),
                                  (3, 5000, 100), (2, 8761, 256),
                                  (1, 31, 256), (3, 2190, 2190),
                                  (2, 6000, 8192)])
def test_soft_kernels_take_any_block_t(cuda, case):
    """Any positive block_t, as the reference takes (block_t >= T too, and
    windows that start inside a block). Each kernel equals its segmented
    mirror run on the card bit for bit, and a second launch the first."""
    b, t, bt = case
    p, p_on, p_off, itau, g = _soft_inputs(b, t, sum(case), cuda)
    f64 = [x.double() for x in (p, p_on, p_off, itau)]
    n0 = (soft_scan_fwd.device_launches, soft_scan_bwd.device_launches)
    s, carries = soft_scan_fwd(p, p_on, p_off, itau, block_t=bt)
    got = soft_scan_bwd(p, p_on, p_off, itau, carries, g, block_t=bt)
    assert (soft_scan_fwd.device_launches, soft_scan_bwd.device_launches) \
        == (n0[0] + 1, n0[1] + 1)
    assert carries.shape == (b, -(-t // bt))
    s64, c64 = soft_scan_fwd(*f64, block_t=bt, use_kernel=False)
    want = soft_scan_bwd(*f64, c64, g.double(), block_t=bt,
                         use_kernel=False)
    torch.testing.assert_close(s.double(), s64, rtol=0, atol=1e-5)
    torch.testing.assert_close(carries.double(), c64, rtol=0, atol=1e-5)
    torch.testing.assert_close(got[0].double(), want[0], rtol=2e-5,
                               atol=1e-5 * float(want[0].abs().max()))
    for k in (1, 2, 3):
        torch.testing.assert_close(got[k].double(), want[k], rtol=2e-5,
                                   atol=0.0)
    mirror = (*soft_scan_fwd_seg_ref(p, p_on, p_off, itau, bt),
              *soft_scan_bwd_seg_ref(p, p_on, p_off, itau, carries, g, bt))
    again = (*soft_scan_fwd(p, p_on, p_off, itau, block_t=bt),
             *soft_scan_bwd(p, p_on, p_off, itau, carries, g, block_t=bt))
    for x, m, y in zip((s, carries, *got), mirror, again):
        assert torch.equal(x, m)
        assert torch.equal(x, y)


def test_optimize_on_the_card_matches_the_cpu(cuda):
    prices = np.random.default_rng(5).lognormal(4.3, 0.5, (2, 700))
    results = {}
    for dev in ("cpu", cuda):
        grid = build_grid(prices.astype(np.float32),
                          [make_system(4e4, 1.0, 700.0, device=dev)],
                          [PolicySpec("ao"), PolicySpec("x3", x=0.03),
                           PolicySpec("h", x=0.08, hysteresis=0.9)],
                          device=dev)
        results[str(dev)] = optimize(grid, TuneConfig(steps=30), device=dev)
    gpu, cpu = results[str(cuda)], results["cpu"]
    np.testing.assert_allclose(gpu.cpc, cpu.cpc, rtol=1e-4)
    np.testing.assert_array_equal(gpu.source, cpu.source)
    assert np.all(gpu.cpc <= gpu.cpc_swept_best * (1 + 1e-6))


# 2500-4400 sites: 3-5 sites a thread (the 4- and 8-site instantiations),
# one buffer of one hour (two at 3100), the walk's widths and prefix in
# float32 storage above ~3030 sites
@pytest.mark.parametrize("case", [(1, 64, 0.0, 0), (5, 333, 5.0, 0),
                                  (16, 500, 5.0, 6), (64, 200, 0.0, 3),
                                  (512, 300, 5.0, 4),
                                  ("zero demand", 16, 500, 5.0, 4),
                                  ("above total", 40, 500, 5.0, 4),
                                  ("ties", 12, 500, 0.0, 3),
                                  ("negative avail", 9, 500, 5.0, 2),
                                  ("negative avail", 70, 300, 5.0, 2),
                                  ("plain", 8, 8760, 5.0, 4),
                                  ("plain", 1100, 60, 5.0, 4),
                                  ("plain", 2500, 48, 5.0, 4),
                                  ("plain", 3100, 48, 5.0, 4),
                                  ("plain", 3500, 48, 5.0, 4),
                                  ("plain", 4400, 48, 5.0, 4),
                                  ("negative avail", 3500, 48, 5.0, 2)])
def test_dispatch_kernel_matches_plain_version(cuda, case):
    if isinstance(case[0], str):
        kind, s, t, mc, dwell = case
        avail, rank, demand = cut_case(kind, s, t, mc, seed=s + t)
    else:
        s, t, mc, dwell = case
        rng = np.random.default_rng(s + t)
        prices = rng.normal(80, 40, (s, t)).astype(np.float32)
        avail = rng.uniform(0.0, 400.0 / s, (s, t)).astype(np.float32)
        demand = (rng.uniform(0.3, 1.05, t) * avail.sum(axis=0)) \
            .astype(np.float32)
        rank = segment_rank(prices, mc)[1]
    args = [torch.as_tensor(a) for a in (avail, rank, demand)]
    want = dispatch_ref(*args, min_dwell=dwell)
    before = dispatch_scan.launches
    got = dispatch_scan(*(a.to(cuda) for a in args), min_dwell=dwell)
    assert dispatch_scan.launches == before + 1
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="int32"):
        dispatch_scan(args[0].to(cuda), args[1].long().to(cuda),
                      args[2].to(cuda))
    with pytest.raises(ValueError, match="CUDA tensors launch the kernel"):
        dispatch_scan(*(a.to(cuda) for a in args), use_kernel=False)


def test_dispatch_under_relief_on_the_card_matches_the_cpu(cuda):
    """Demand above availability and a power cap, relieved: `dispatch` on
    the card (the kernel) equals the CPU (the plain version)."""
    from repro_torch.dispatch import DispatchProblem, Relief, dispatch
    avail, rank, demand = cut_case("above total", 16, 600, 5.0, seed=12)
    prices = np.random.default_rng(12).normal(80, 40, avail.shape) \
        .astype(np.float32)
    prob = DispatchProblem(
        prices=prices, avail_mw=avail, demand_mw=demand,
        power_cap_mw=float(0.8 * avail.sum(axis=0).max()), migrate_cost=5.0,
        min_dwell_h=4, compute_floor_mwh=0.0, fixed_cost=1e3, order=None,
        rank=segment_rank(prices, 5.0)[1], relief=Relief())
    gpu, cpu = dispatch(prob, device=cuda), dispatch(prob, device="cpu")
    assert cpu.n_shed_hours > 0
    np.testing.assert_array_equal(gpu.alloc_mw, cpu.alloc_mw)
    assert gpu.n_shed_hours == cpu.n_shed_hours


def test_summarize_dispatch_on_the_card_matches_the_cpu(cuda):
    prices = np.random.default_rng(6).lognormal(4.3, 0.5, (5, 900))
    cfg = DispatchConfig(demand_frac=0.3, migrate_cost=5.0, min_dwell_h=4)
    out = {}
    for dev in ("cpu", cuda):
        grid = build_grid(prices.astype(np.float32),
                          [make_system(5e4, 1.0, 900.0, device=dev)],
                          [PolicySpec("ao"),
                           PolicySpec("x5", x=0.05, off_level=0.3)],
                          device=dev)
        out[str(dev)] = summarize(grid, backtest(grid, device=dev),
                                  dispatch_cfg=cfg)
    gpu, cpu = out[str(cuda)], out["cpu"]
    np.testing.assert_array_equal(gpu.dispatch_rows, cpu.dispatch_rows)
    for f in cpu.dispatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(gpu.dispatch, f)),
                                      np.asarray(getattr(cpu.dispatch, f)),
                                      err_msg=f)


# (S, T, migrate_cost, min_dwell, tau): the reference's SOFT_CASES
SOFT_DISPATCH_CASES = [(1, 64, 0.0, 0, 5.0), (5, 333, 5.0, 0, 2.0),
                       (8, 500, 5.0, 6, 0.5), (16, 700, 3.0, 3, 20.0)]
# blocks of more than one warp: 64 sites, and 45 and 130, which are not
# multiples of 32
WIDE_DISPATCH_CASES = [(64, 300, 5.0, 4, 3.0), (45, 300, 5.0, 4, 1.0),
                       (130, 200, 3.0, 0, 2.0)]


def _soft_dispatch_problem(s, t, mc, seed=0):
    """The reference's `_random_case`, with a positive cotangent."""
    r = np.random.default_rng(29 + seed)
    prices = r.normal(80, 40, (s, t)).astype(np.float32)
    power = r.uniform(1.0, 3.0, s).astype(np.float32)
    on = (r.uniform(size=(s, t)) > 0.3).astype(np.float32)
    avail = power[:, None] * (0.2 + 0.8 * on)
    demand = np.full(t, 0.5 * float(avail.sum(axis=0).min()), np.float32)
    keys = segment_keys(prices, mc).astype(np.float32)
    order = segment_rank(prices, mc)[0]
    g = r.uniform(0.5, 1.5, (s, t)).astype(np.float32)
    return [torch.as_tensor(np.ascontiguousarray(x))
            for x in (avail, keys, order, demand, g)]


def _near(got, want, atol, msg):
    torch.testing.assert_close(got.cpu().double(), want.double(), rtol=0,
                               atol=atol, msg=msg)


def _near_bwd(got, want, g):
    floor = float(g.abs().max())
    for name, x, w in zip(("d_avail", "d_keys", "d_demand", "d_itau",
                           "d_itau_mw"), got, want):
        scale = max(float(w.abs().max()), floor)
        _near(x, w, 1e-4 * scale, name)


def _hold_soft_dispatch(cuda, cpu, dwell, tau, n_bisect=30):
    """The three soft-dispatch kernels on ``cpu``'s problem against their
    plain versions (see the module's docstring); returns the kernels'
    outputs."""
    avail, keys, order, demand, g = (x.to(cuda) for x in cpu)
    s = avail.shape[0]
    it = torch.tensor([1.0 / tau], dtype=torch.float32)
    itm = it / torch.tensor(0.05)
    counted = (soft_dispatch_scan, soft_dispatch_fused_fwd,
               soft_dispatch_fused_bwd)
    before = [(fn.launches, fn.device_launches) for fn in counted]
    alone = soft_dispatch_scan(avail, keys, order, demand, tau=tau,
                               min_dwell=dwell, n_bisect=n_bisect)
    alloc, dwin, lam = soft_dispatch_fused_fwd(
        avail, keys, order, demand, it.to(cuda), itm.to(cuda),
        min_dwell=dwell, n_bisect=n_bisect)
    back = soft_dispatch_fused_bwd(avail, keys, demand, it.to(cuda),
                                   itm.to(cuda), alloc, dwin, lam, g,
                                   min_dwell=dwell)
    torch.cuda.synchronize()
    # one call each; on the card one kernel a forward, two a backward
    assert [(fn.launches, fn.device_launches) for fn in counted] == [
        (n + 1, k + d) for (n, k), d in zip(before, (1, 1, 2))]
    assert torch.equal(alone, alloc)            # one kernel, two entries
    p_alloc, p_dwin, p_lam = soft_dispatch_fwd_ref(
        *cpu[:4], it, itm, min_dwell=dwell, n_bisect=n_bisect)
    _near(alloc, p_alloc, 1e-5, "alloc")
    _near(dwin, p_dwin, 1e-4, "dwell_in")
    # a level may be off by more only in a gap of the fill, where it is
    # not determined: any level there places the same load, which is what
    # is held in such hours
    for h in torch.nonzero((lam.cpu() - p_lam).abs() > 1e-3).flatten():
        prev = p_alloc[:, h - 1] if h > 0 else torch.zeros(s)
        assert soft_level_in_gap(prev, p_dwin[:, h], cpu[0][:, h],
                                 cpu[1][h], cpu[3][h], p_lam[h],
                                 lam.cpu()[h], it[0], min_dwell=dwell), \
            f"level of hour {h}"
        moved, _ = soft_dispatch_hour_fixed(
            prev, p_dwin[:, h], cpu[0][:, h], cpu[1][h], cpu[3][h],
            lam.cpu()[h], it[0], itm[0], min_dwell=dwell)
        _near(moved, p_alloc[:, h], 1e-5, f"alloc at the level of hour {h}")
    _near(alone, soft_dispatch_ref(*cpu[:4], tau=tau, min_dwell=dwell,
                                   n_bisect=n_bisect),
          1e-5, "soft_dispatch_ref")
    # the backward from the kernel's own residuals on both sides, then
    # from the plain version's
    _near_bwd(back, soft_dispatch_bwd_ref(
        cpu[0], cpu[1], cpu[3], it, itm, alloc.cpu(), dwin.cpu(), lam.cpu(),
        cpu[4], min_dwell=dwell), cpu[4])
    back_p = soft_dispatch_fused_bwd(
        avail, keys, demand, it.to(cuda), itm.to(cuda), p_alloc.to(cuda),
        p_dwin.to(cuda), p_lam.to(cuda), g, min_dwell=dwell)
    _near_bwd(back_p, soft_dispatch_bwd_ref(
        cpu[0], cpu[1], cpu[3], it, itm, p_alloc, p_dwin, p_lam, cpu[4],
        min_dwell=dwell), cpu[4])
    return (alloc, dwin, lam) + tuple(back)


@pytest.mark.parametrize("case", SOFT_DISPATCH_CASES + WIDE_DISPATCH_CASES)
def test_soft_dispatch_kernels_match_plain_versions(cuda, case):
    s, t, mc, dwell, tau = case
    _hold_soft_dispatch(cuda, _soft_dispatch_problem(s, t, mc), dwell, tau)


# sites -> (hours, the forward's bisection levels a round): one to 32 warps
# a group; four levels down to one (at 321 to 512 sites three groups of 11
# to 16 warps do not fit the block's 32, so one level a round there too)
SOFT_DISPATCH_WIDTHS = {1: (80, 4), 5: (80, 4), 32: (80, 4), 33: (60, 3),
                        45: (60, 3), 64: (60, 3), 130: (40, 2),
                        400: (20, 1), 1024: (12, 1)}


@pytest.mark.parametrize("s", sorted(SOFT_DISPATCH_WIDTHS))
def test_soft_dispatch_kernels_at_every_group_width(cuda, s):
    """At one to 32 warps a group and every levels-a-round count, for
    n_bisect 0, 7, 30 and 31, with and without dwell locks and with
    zero-demand hours: the kernels against their plain versions, and a
    second run equal to the first bit for bit."""
    from repro_torch.kernels.soft_dispatch import _library

    t, levels = SOFT_DISPATCH_WIDTHS[s]
    assert _library().soft_dispatch_fwd_levels(s) == levels
    cpu = _soft_dispatch_problem(s, t, 4.0, seed=s)
    cpu[3][[0, t // 2, t // 2 + 1, t - 1]] = 0.0
    for dwell in (0, 4):
        for n_bisect in (0, 7, 30, 31):
            first = _hold_soft_dispatch(cuda, cpu, dwell, 3.0, n_bisect)
            again = _hold_soft_dispatch(cuda, cpu, dwell, 3.0, n_bisect)
            for x, y in zip(first, again):
                assert torch.equal(x, y), (dwell, n_bisect)
            assert bool((first[0][:, [0, t - 1]] == 0.0).all())


def test_soft_dispatch_backward_keeps_no_state_between_calls(cuda):
    """The backward's scratch is the call's own: two problems' backwards
    issued back to back on two streams equal each one run alone."""
    probs = []
    for s, t, seed in ((32, 300, 1), (45, 200, 2)):
        cpu = _soft_dispatch_problem(s, t, 5.0, seed=seed)
        avail, keys, order, demand, g = (x.to(cuda) for x in cpu)
        it = torch.tensor([1.0 / 3.0], device=cuda)
        itm = it / 0.05
        res = soft_dispatch_fused_fwd(avail, keys, order, demand, it, itm,
                                      min_dwell=4)
        probs.append((avail, keys, demand, it, itm, *res, g))
    alone = [soft_dispatch_fused_bwd(*p, min_dwell=4) for p in probs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in probs]
    both = []
    for st, p in zip(streams, probs):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            both.append(soft_dispatch_fused_bwd(*p, min_dwell=4))
    torch.cuda.synchronize()
    for a, b in zip(alone, both):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_soft_dispatch_kernels_refuse_what_they_do_not_take(cuda):
    avail, keys, order, demand, _ = (
        x.to(cuda) for x in _soft_dispatch_problem(4, 50, 4.0))
    with pytest.raises(ValueError, match="float32"):
        soft_dispatch_scan(avail.double(), keys, order, demand, tau=2.0)
    with pytest.raises(ValueError, match="int32"):
        soft_dispatch_scan(avail, keys, order.long(), demand, tau=2.0)
    with pytest.raises(ValueError, match="contiguous"):
        soft_dispatch_scan(avail.T.contiguous().T, keys, order, demand,
                           tau=2.0)
    with pytest.raises(ValueError, match="on cuda"):
        soft_dispatch_scan(avail, keys.cpu(), order, demand, tau=2.0)
    with pytest.raises(ValueError, match=r"\[50, 12\]"):
        soft_dispatch_scan(avail, keys[:, :6].contiguous(), order, demand,
                           tau=2.0)
    with pytest.raises(ValueError, match="fused=True"):
        soft_dispatch(avail.clone().requires_grad_(True), keys, order,
                      demand, tau=2.0)
    # the fused route differentiates through the kernel pair
    a = avail.clone().requires_grad_(True)
    before = soft_dispatch_fused_bwd.launches
    soft_dispatch(a, keys, order, demand, tau=2.0, min_dwell=2,
                  fused=True).sum().backward()
    assert soft_dispatch_fused_bwd.launches == before + 1
    assert bool(torch.isfinite(a.grad).all())


def test_dispatch_aware_optimize_on_the_card_matches_the_cpu(cuda):
    prices = np.random.default_rng(7).lognormal(4.3, 0.5, (3, 300))
    dcfg = DispatchConfig(demand_frac=0.25, migrate_cost=4.0, min_dwell_h=3)
    cfg = TuneConfig(steps=20, coupling=Coupling(dispatch=dcfg))
    results = {}
    for dev in ("cpu", cuda):
        grid = build_grid(prices.astype(np.float32),
                          [make_system(4e4, 1.0, 300.0, device=dev)],
                          [PolicySpec("ao"),
                           PolicySpec("x5", x=0.05, off_level=0.3),
                           PolicySpec("x10", x=0.10, off_level=0.3)],
                          device=dev)
        results[str(dev)] = optimize(grid, cfg, device=dev)
    gpu, cpu = results[str(cuda)], results["cpu"]
    np.testing.assert_array_equal(gpu.source, cpu.source)
    np.testing.assert_allclose(gpu.cpc, cpu.cpc, rtol=1e-3)
    assert gpu.dispatch["chosen"] == cpu.dispatch["chosen"]
    for k in ("cpc_tuned", "cpc_swept"):
        np.testing.assert_allclose(gpu.dispatch[k], cpu.dispatch[k],
                                   rtol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match="fused=True"):
        optimize(grid, TuneConfig(steps=2, fused=False,
                                  coupling=Coupling(dispatch=dcfg)),
                 device=cuda)


ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _attn_inputs(shapes, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device=dev).to(dtype) for s in shapes]


# B, Sq, Skv, H, G, Dh, causal, window, q_offset, dtype: float32 (the
# CUDA-core kernel), then bf16 (the tensor-core kernel) at the four head
# dims, ragged Sq of 100 and 1000, Skv > Sq with q_offset, windows and
# non-causal cases
@pytest.mark.parametrize("case", [
    (1, 100, 100, 8, 2, 64, True, 0, 0, torch.float32),
    (2, 200, 200, 16, 2, 128, True, 0, 0, torch.bfloat16),
    (1, 70, 200, 16, 2, 32, True, 40, 130, torch.float32),
    (1, 100, 100, 8, 2, 16, True, 0, 0, torch.bfloat16),
    (2, 1000, 1000, 16, 2, 32, True, 0, 0, torch.bfloat16),
    (1, 200, 200, 4, 4, 64, True, 0, 0, torch.bfloat16),
    (1, 1000, 1000, 16, 2, 128, True, 0, 0, torch.bfloat16),
    (1, 70, 300, 16, 2, 128, True, 0, 230, torch.bfloat16),
    (1, 70, 200, 16, 2, 32, True, 40, 130, torch.bfloat16),
    (1, 256, 256, 8, 2, 64, True, 100, 0, torch.bfloat16),
    (2, 64, 256, 4, 4, 32, False, 0, 0, torch.bfloat16),
    (1, 100, 170, 8, 2, 16, False, 0, 0, torch.bfloat16),
    (1, 130, 130, 16, 2, 128, False, 0, 0, torch.bfloat16),
    (1, 1024, 1024, 32, 32, 64, True, 0, 0, torch.bfloat16)])
def test_flash_kernel_matches_plain_version(cuda, case):
    b, sq, skv, h, g, dh, causal, win, qo, dt = case
    q, k, v = _attn_inputs([(b, sq, h, dh), (b, skv, g, dh),
                            (b, skv, g, dh)], dt, cuda,
                            sum(case[:6]) + win + qo)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=win, q_offset=qo,
                          use_kernel=True)
    want = flash_attention_plain(q, k, v, causal=causal, window=win,
                                 q_offset=qo)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == (b, sq, h, dh)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dt])


# B, H, G, Dh, W, dtype: float32 (the CUDA-core kernel), then bf16 (the
# tensor-core kernel) at R = H / G of 1, 8, 16 and 32 heads a group (one
# and two row tiles), with one split and with several; last zamba2-1.2b's
# pool (32 heads, each its own group, Dh 64, 8 slots of 2048)
@pytest.mark.parametrize("case", [(2, 8, 2, 64, 100, torch.float32),
                                  (8, 16, 2, 128, 2048, torch.bfloat16),
                                  (1, 4, 1, 16, 513, torch.float32),
                                  (2, 2, 2, 64, 300, torch.bfloat16),
                                  (1, 8, 1, 32, 64, torch.bfloat16),
                                  (3, 32, 2, 128, 700, torch.bfloat16),
                                  (2, 32, 1, 64, 1000, torch.bfloat16),
                                  (2, 64, 2, 16, 513, torch.bfloat16),
                                  (8, 32, 32, 64, 2048, torch.bfloat16)])
def test_decode_kernel_matches_plain_version(cuda, case):
    b, h, g, dh, w, dt = case
    q, k, v = _attn_inputs([(b, 1, h, dh), (b, w, g, dh), (b, w, g, dh)],
                           dt, cuda, sum(case[:5]))
    rng = np.random.default_rng(w)
    valid = torch.as_tensor(rng.random((b, w)) > 0.3, device=cuda)
    valid[:, 0] = True
    valid = valid.to(torch.int8)
    before = decode_attention.launches
    got = decode_attention(q, k, v, valid, use_kernel=True)
    want = decode_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dt])


# B, H, G, Dh, W, dtype; rows filled linearly to 0, 1, 65, 300 slots and
# then to the whole cache, in turn
@pytest.mark.parametrize("case", [(8, 16, 2, 128, 2048, torch.bfloat16),
                                  (5, 8, 2, 64, 600, torch.float32)])
def test_decode_kernel_skips_tiles_with_no_valid_slot(cuda, case):
    """Tiles and whole splits with no valid slot are skipped by the kernel
    and its plain version alike: every row agrees, and a row with no
    valid slot is exactly 0."""
    b, h, g, dh, w, dt = case
    q, k, v = _attn_inputs([(b, 1, h, dh), (b, w, g, dh), (b, w, g, dh)],
                           dt, cuda, w)
    fill = torch.tensor([0, 1, 65, 300, w] * b, device=cuda)[:b]
    valid = (torch.arange(w, device=cuda)[None] < fill[:, None])
    valid = valid.to(torch.int8)
    got = decode_attention(q, k, v, valid, use_kernel=True)
    want = decode_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dt])


def test_decode_kernel_folds_in_its_launch_and_resets_its_counters(cuda):
    """The splits are folded in the kernel's own launch, by the block that
    takes a (batch row, group) counter's last ticket: two calls in a row
    on one stream, then two at once on two streams, each agree with the
    plain version, and every stream's counters are back at 0."""
    from repro_torch.kernels import decode_attention as dmod

    b, h, g, dh, w = 8, 16, 2, 128, 2048
    cases = []
    for seed in range(4):
        q, k, v = _attn_inputs([(b, 1, h, dh), (b, w, g, dh),
                                (b, w, g, dh)], torch.bfloat16, cuda, seed)
        fill = torch.as_tensor(np.random.default_rng(seed).integers(
            1, w + 1, b), device=cuda)
        valid = (torch.arange(w, device=cuda)[None] < fill[:, None])
        cases.append((q, k, v, valid.to(torch.int8)))
    want = [decode_attention_plain(*c) for c in cases]
    before = decode_attention.launches
    got = [decode_attention(*cases[0]), decode_attention(*cases[1])]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        got.append(decode_attention(*cases[2]))
    with torch.cuda.stream(s2):
        got.append(decode_attention(*cases[3]))
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 4
    for x, y in zip(got, want):
        torch.testing.assert_close(x.float(), y.float(),
                                   **ATTN_TOL[torch.bfloat16])
    idx = cases[0][0].device.index
    bufs = [dmod._counters[(idx, s.cuda_stream)] for s in (s1, s2)]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    for buf in dmod._counters.values():
        assert int(buf.count_nonzero()) == 0


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_attention_kernels_read_strided_misaligned_views(cuda, dt):
    """q, k, v cut from wider rows at a one-element offset: the kernels'
    4-byte load path, through the strides."""
    wide = _attn_inputs([(2, 150, 8, 65), (2, 150, 2, 65), (2, 150, 2, 65)],
                        dt, cuda, 4)
    q, k, v = (x[..., 1:] for x in wide)
    got = flash_attention(q, k, v, causal=True, window=50, use_kernel=True)
    want = flash_attention_plain(q, k, v, causal=True, window=50)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dt])
    valid = torch.ones((2, 150), dtype=torch.int8, device=cuda)
    got = decode_attention(q[:, -1:], k, v, valid, use_kernel=True)
    want = decode_attention_plain(q[:, -1:], k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dt])


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = _attn_inputs([(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)],
                           torch.float32, cuda, 0)
    valid = torch.ones((1, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        decode_attention(q[:, :1].half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError, match="dtype|bfloat16"):
        flash_attention(q, k.bfloat16(), v)
    wide = torch.zeros((1, 64, 4, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(wide, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(wide[:, :1], k, v, valid)
    k3 = torch.zeros((1, 64, 3, 64), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k3, k3)
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(q[:, :1], k3, k3, valid)
    with pytest.raises(ValueError, match="int8"):
        decode_attention(q[:, :1], k, v, valid.bool())
    with pytest.raises(ValueError, match="use_kernel"):
        flash_attention(q, k, v, use_kernel=False)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen1.5-0.5b"])
def test_serving_engine_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced engine at float32 on the card returns the CPU's tokens,
    through the kernels: one flash launch per layer and prefill, one
    decode launch per layer and decode step."""
    cfg = reduced_config(get_config(arch))
    cpu_params = init_params(5, cfg, device="cpu")
    outputs, launches = {}, {}
    for dev in ("cpu", cuda):
        params = _tree_to(cpu_params, dev)
        eng = ServingEngine(params, cfg, ServeConfig(slots=4, max_seq=48),
                            device=dev)
        rng = np.random.default_rng(2)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(
                2, cfg.vocab - 1, size=int(rng.integers(5, 20))).astype(
                    np.int32), max_new=8))
        f0, d0 = flash_attention.launches, decode_attention.launches
        out = eng.run(ticks=30)
        launches[str(dev)] = (flash_attention.launches - f0,
                              decode_attention.launches - d0)
        outputs[str(dev)] = ({r.rid: r.output for r in eng.completed},
                             out["tokens_served"], out["completed"])
    assert outputs[str(cuda)] == outputs["cpu"]
    assert outputs["cpu"][2] == 6
    assert launches["cpu"] == (0, 0)
    assert launches[str(cuda)][0] == 6 * cfg.n_layers
    assert launches[str(cuda)][1] % cfg.n_layers == 0
    assert launches[str(cuda)][1] > 0


# ---------------------------------------------------------------------------
# the Mamba2 slice: the SSD kernel, card draws, the gradient guard
# ---------------------------------------------------------------------------

SSD_SCALE_TOL = 1e-4     # of the output's scale (max |y|, max |h|)


def _ssd_inputs(b, s, h, p, g, n, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    xs = (rng.normal(size=(b, s, h, p)),
          np.abs(rng.normal(size=(b, s, h))) * 0.1,
          -np.abs(rng.normal(size=(h,))) - 0.1,
          rng.normal(size=(b, s, g, n)) * 0.3,
          rng.normal(size=(b, s, g, n)) * 0.3)
    x, dt, a, bb, cc = (torch.as_tensor(v.astype(f), device=dev) for v in xs)
    return x.to(dtype), dt, a, bb.to(dtype), cc.to(dtype)


def _scale_close(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= SSD_SCALE_TOL * scale, f"{what}: {err:.3g} of {scale:.3g}"


# B, S, H, P, G, N, chunk, dtype, with h0: the reference's SSD_CASES, then
# mamba2-1.3b's serving shape (64 heads of P 64, N 128, chunk 256) at a
# ragged length in bf16 with h0; then the kernel's head sets of 2: several
# heads a group (H 12 / G 2, H 6 / G 1), 3 a group with a ragged last set
# (H 6 / G 2), one head a group (G = H, the set's second group idle), B and
# C rows that take no 16-byte copies (N 20, P 24), a partial second slab
# of N (N 96, P 24) and N past the tensor-core passes' 128 (N 136), a chunk
# that is not a multiple of the 64-row tile, the serving shape in bf16
# and float32 with and without h0, and zamba2-1.2b's (N 64: one slab)
SSD_GPU_CASES = [
    (2, 64, 4, 16, 1, 32, 16, torch.float32, False),
    (1, 128, 8, 32, 2, 16, 32, torch.float32, True),
    (2, 96, 4, 64, 1, 128, 48, torch.float32, False),
    (1, 64, 2, 8, 1, 8, 64, torch.float32, True),
    (1, 1000, 64, 64, 1, 128, 256, torch.bfloat16, True),
    (1, 512, 12, 64, 2, 128, 128, torch.bfloat16, True),
    (2, 320, 6, 32, 1, 64, 64, torch.float32, False),
    (1, 384, 6, 64, 1, 128, 128, torch.bfloat16, False),
    (1, 256, 6, 64, 2, 128, 64, torch.bfloat16, True),
    (1, 160, 4, 16, 4, 32, 32, torch.bfloat16, True),
    (1, 160, 4, 16, 4, 32, 32, torch.float32, False),
    (1, 96, 4, 24, 1, 20, 32, torch.bfloat16, True),
    (1, 192, 4, 24, 1, 96, 64, torch.bfloat16, True),
    (1, 128, 4, 32, 1, 136, 64, torch.bfloat16, True),
    (2, 96, 4, 64, 1, 128, 48, torch.bfloat16, False),
    (1, 1024, 64, 64, 1, 128, 256, torch.bfloat16, False),
    (1, 1024, 64, 64, 1, 128, 256, torch.float32, True),
    (1, 1024, 64, 64, 1, 128, 256, torch.float32, False),
    (1, 1024, 64, 64, 1, 64, 256, torch.bfloat16, False),
    (1, 1000, 64, 64, 1, 64, 256, torch.bfloat16, True)]


def _hold_ssd(cuda, case):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, s, h, p, g, n, l, dt_, with_h0 = case
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, g, n, dt_, cuda, sum(case[:7]))
    h0 = (torch.randn((b, h, p, n), device=cuda) * 0.5 if with_h0 else None)
    before = ssd_scan.launches
    y, hl = ops.ssd_scan(x, dt, a, bb, cc, l, h0)
    wy, wh = ssd_scan_plain(x, dt, a, bb, cc, l, h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert bool(torch.isfinite(y).all())
    _scale_close(y, wy, "y")
    _scale_close(hl, wh, "h_last")


@pytest.mark.parametrize("case", SSD_GPU_CASES)
def test_ssd_kernel_matches_plain_version(cuda, case):
    _hold_ssd(cuda, case)


def test_ssd_kernel_is_one_wrapper_call_a_scan(cuda):
    """A scan is one counted wrapper call and three kernels on the card
    (chunk states, state pass, outputs), whatever the head sets."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_scan
    x, dt, a, bb, cc = _ssd_inputs(1, 512, 12, 64, 2, 128, torch.bfloat16,
                                   cuda)
    calls, dev = ssd_scan.launches, ssd_scan.device_launches
    lib0 = build.kernels_launched("ssd_scan")
    for _ in range(3):
        ssd_scan(x, dt, a, bb, cc, 128)
    torch.cuda.synchronize()
    assert ssd_scan.launches == calls + 3
    assert ssd_scan.device_launches == dev + 9
    assert build.kernels_launched("ssd_scan") == lib0 + 9


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan
    x, dt, a, bb, cc = _ssd_inputs(1, 64, 4, 16, 1, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(x[:, :60], dt[:, :60], a, bb[:, :60], cc[:, :60], 16)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x, dt.double(), a, bb, cc, 16)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan(x, dt, a, bb.bfloat16(), cc, 16)
    with pytest.raises(ValueError, match="on"):
        ssd_scan(x, dt, a.cpu(), bb, cc, 16)
    with pytest.raises(ValueError, match="use_kernel"):
        ssd_scan(x, dt, a, bb, cc, 16, use_kernel=False)


def test_draws_on_the_card_equal_the_cpus(cuda):
    """One seed, the same draws on every device: a market's draws equal,
    its prices within float32 rounding; a reduced config's parameters
    equal, leaf by leaf (dense, ssm and hybrid)."""
    from repro_torch.energy.markets import generate_market, market_draws
    from repro_torch.energy.presets import region_params
    mp = region_params("germany", seed=3)
    for a, b in zip(market_draws(3, 8760, device=cuda),
                    market_draws(3, 8760, device="cpu")):
        assert torch.equal(a.cpu(), b)
    got = generate_market(mp, device=cuda).prices.cpu()
    want = generate_market(mp, device="cpu").prices
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    for arch in ("qwen2.5-3b", "mamba2-1.3b", "zamba2-1.2b"):
        cfg = reduced_config(get_config(arch))
        gp = init_params(7, cfg, device=cuda)
        cp = init_params(7, cfg, device="cpu")

        def walk(x, y):
            if isinstance(x, dict):
                for k in x:
                    walk(x[k], y[k])
            else:
                assert x.is_cuda and torch.equal(x.cpu(), y)
        walk(gp, cp)


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """Flash, decode and SSD are forward only on the card: inputs that
    require grad raise while grad mode is on, and run under no_grad."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    q, k, v = _attn_inputs([(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)],
                           torch.float32, cuda, 0)
    valid = torch.ones((1, 64), dtype=torch.int8, device=cuda)
    x, dt, a, bb, cc = _ssd_inputs(1, 64, 4, 16, 1, 32, torch.float32, cuda)
    qg = q.clone().requires_grad_()
    xg = x.clone().requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(qg, k, v)
    with pytest.raises(ValueError, match="forward only"):
        decode_attention(qg[:, :1], k, v, valid)
    with pytest.raises(ValueError, match="forward only"):
        ssd_scan(xg, dt, a, bb, cc, 16)
    with pytest.raises(ValueError, match="forward only"):
        ssd_scan(x, dt, a.clone().requires_grad_(), bb, cc, 16)
    with torch.no_grad():
        flash_attention(qg, k, v)
        decode_attention(qg[:, :1], k, v, valid)
        ssd_scan(xg, dt, a, bb, cc, 16)
    torch.cuda.synchronize()


def test_mamba2_engine_on_the_card_matches_the_cpu(cuda):
    """Reduced mamba2 at float32: the engine on the card returns the CPU's
    tokens, with one SSD launch per layer and prefill (prompts of 2 to 19
    tokens against chunk 8) and none on the CPU."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    cfg = reduced_config(get_config("mamba2-1.3b"))
    cpu_params = init_params(5, cfg, device="cpu")
    outputs, launches = {}, {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(_tree_to(cpu_params, dev), cfg,
                            ServeConfig(slots=4, max_seq=48), device=dev)
        rng = np.random.default_rng(2)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(
                2, cfg.vocab - 1, size=int(rng.integers(2, 20))).astype(
                    np.int32), max_new=8))
        s0 = ssd_scan.launches
        out = eng.run(ticks=30)
        launches[str(dev)] = ssd_scan.launches - s0
        outputs[str(dev)] = ({r.rid: r.output for r in eng.completed},
                             out["tokens_served"], out["completed"])
    assert outputs[str(cuda)] == outputs["cpu"]
    assert outputs["cpu"][2] == 6
    assert launches == {"cpu": 0, str(cuda): 6 * cfg.n_layers}


def test_hybrid_engine_on_the_card_matches_the_cpu(cuda):
    """Reduced zamba2 at float32 (4 Mamba2 layers, the shared block after
    every 2): the engine on the card returns the CPU's tokens, with one
    SSD launch per layer and one flash launch per application a prefill
    (prompts of 2 to 19 tokens against chunk 8), one decode launch per
    application a step, and none on the CPU."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    cfg = reduced_config(get_config("zamba2-1.2b"))
    n_apps = cfg.n_layers // cfg.hybrid_attn_every
    cpu_params = init_params(5, cfg, device="cpu")
    outputs, launches = {}, {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(_tree_to(cpu_params, dev), cfg,
                            ServeConfig(slots=4, max_seq=48), device=dev)
        rng = np.random.default_rng(2)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(
                2, cfg.vocab - 1, size=int(rng.integers(2, 20))).astype(
                    np.int32), max_new=8))
        before = (ssd_scan.launches, flash_attention.launches,
                  decode_attention.launches)
        out = eng.run(ticks=30)
        launches[str(dev)] = tuple(
            a - b for a, b in zip((ssd_scan.launches, flash_attention.launches,
                                   decode_attention.launches), before))
        outputs[str(dev)] = ({r.rid: r.output for r in eng.completed},
                             out["tokens_served"], out["completed"])
    assert outputs[str(cuda)] == outputs["cpu"]
    assert outputs["cpu"][2] == 6
    assert launches["cpu"] == (0, 0, 0)
    ssd, flash, dec = launches[str(cuda)]
    assert (ssd, flash) == (6 * cfg.n_layers, 6 * n_apps)
    assert dec > 0 and dec % n_apps == 0


# ---------------------------------------------------------------------------
# the training slice: the kernels under autograd, the batch, compression,
# a training step
# ---------------------------------------------------------------------------

def _rel_err(got, want) -> float:
    """max |got - want| over max(max |want|, 1): relative where the
    gradient is of order 1 or more, absolute below (one key gives q and k
    no gradient at all, which rounding leaves at ~1e-7)."""
    return float((got.float() - want.float()).abs().max()) \
        / max(float(want.float().abs().max()), 1.0)


GRAD_TOL_CARD = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


# B, S, H, G, Dh, causal, window, q_offset (Sq = S; Skv = S + q_offset)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 100, 16, 2, 64, True, 0, 0),
    (1, 64, 16, 16, 128, True, 24, 0),
    (1, 70, 8, 2, 64, True, 0, 130),
    (2, 1, 4, 4, 64, True, 0, 0)])
def test_attention_function_gradients_match_plain_autograd(cuda, case,
                                                           dtype):
    """On the card, `blockwise_attention` with inputs that require grad
    launches the flash kernel once and takes the Function's backward;
    dq, dk, dv agree with autograd through `flash_attention_plain`."""
    from repro_torch.models import attention
    b, s, h, g, dh, causal, win, qo = case
    q, k, v, w = _attn_inputs([(b, s, h, dh), (b, s + qo, g, dh),
                               (b, s + qo, g, dh), (b, s, h, dh)], dtype,
                              cuda, sum(case[:5]))
    cfg = reduced_config(get_config("qwen2.5-3b"))
    grads = []
    for route in ("kernel", "plain"):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        before = flash_attention.launches
        if route == "kernel":
            out = attention.blockwise_attention(*ins, cfg, causal=causal,
                                                window=win, q_offset=qo)
            assert flash_attention.launches == before + 1
        else:
            out = flash_attention_plain(*ins, causal=causal, window=win,
                                        q_offset=qo)
        (out.float() * w.float()).sum().backward()
        grads.append([t.grad for t in ins])
    torch.cuda.synchronize()
    for name, a, bb in zip("qkv", *grads):
        assert a.dtype == dtype
        assert _rel_err(a, bb) <= GRAD_TOL_CARD[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 300, 8, 64, 1, 128, 256, True),
                                  (1, 256, 4, 64, 4, 64, 128, False)])
def test_ssd_function_gradients_match_plain_autograd(cuda, case, dtype):
    """On the card, the model's `ssd_scan` with inputs that require grad
    launches the SSD kernel once and takes `SSDScan`'s backward; every
    input's gradient agrees with autograd through `ssd_scan_plain`."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel
    from repro_torch.models import ssm
    b, s, h, p, g, n, chunk, with_h0 = case
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, g, n, dtype, cuda, sum(case))
    rng = np.random.default_rng(1)
    h0 = torch.as_tensor(rng.normal(size=(b, h, p, n)).astype(np.float32),
                         device=cuda) if with_h0 else None
    wy = torch.randn((b, s, h, p), device=cuda)
    wh = torch.randn((b, h, p, n), device=cuda)
    grads = []
    for route in ("kernel", "plain"):
        ins = [t.clone().requires_grad_() for t in (x, dt, a, bb, cc)]
        hh = None if h0 is None else h0.clone().requires_grad_()
        before = ssd_kernel.launches
        fn = ssm.ssd_scan if route == "kernel" else ssd_scan_plain
        y, hl = fn(*ins, chunk, hh)
        if route == "kernel":
            assert ssd_kernel.launches == before + 1
        ((y * wy).sum() + (hl * wh).sum()).backward()
        grads.append([t.grad for t in ins] + ([hh.grad] if with_h0 else []))
    torch.cuda.synchronize()
    for name, ga, gb in zip(("x", "dt", "a", "b", "c", "h0"), *grads):
        assert _rel_err(ga, gb) <= GRAD_TOL_CARD[dtype], name


def test_batch_on_the_card_is_the_cpu_batch(cuda):
    from repro_torch.data import SyntheticLM
    ds = SyntheticLM(vocab=151936, seq_len=1024, global_batch=8, seed=0)
    for step in (0, 5):
        got, want = ds.batch_at(step, device=cuda), ds.batch_at(step,
                                                                  device="cpu")
        for k in want:
            assert got[k].is_cuda and torch.equal(got[k].cpu(), want[k]), k


def test_quantize_on_the_card_matches_the_cpu(cuda):
    from repro_torch.optim import dequantize, quantize_int8
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(1000, 37)).astype(np.float32))
    e = torch.as_tensor(rng.normal(size=(1000, 37)).astype(np.float32)) \
        * 1e-3
    for xx in (x, x.to(torch.bfloat16)):
        want = quantize_int8(xx, e)
        got = quantize_int8(xx.to(cuda), e.to(cuda))
        for a, bb in zip(got, want):
            assert torch.equal(a.cpu(), bb)
        assert torch.equal(dequantize(got[0], got[1]).cpu(),
                           dequantize(want[0], want[1]))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_training_step_on_the_kernels_matches_the_plain_route(cuda, arch):
    """2-layer reduced configs at float32 (remat full; zamba2 with one
    application of its shared block): one loss and every gradient leaf,
    each within 1e-4 of the leaf's largest entry, on the card through the
    kernels (the Functions) against
    the same with the model's attention and SSD call sites switched to
    their plain versions under plain autograd."""
    from repro_torch.models import attention, ssm
    from repro_torch.models.model import loss_fn
    from repro_torch.data import SyntheticLM
    cfg = reduced_config(get_config(arch)).replace(remat="full",
                                                   loss_chunk=16, n_layers=2)
    params = init_params(3, cfg, device=cuda)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                        seed=1, mean_doc_len=16).batch_at(0, device=cuda)

    def run():
        leaves = []

        def req(t):
            if isinstance(t, dict):
                return {k: req(v) for k, v in t.items()}
            leaves.append(t.detach().requires_grad_())
            return leaves[-1]
        loss, _ = loss_fn(req(params), batch, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    kern_loss, kern = run()
    saved = attention.blockwise_attention, ssm.ssd_scan
    attention.blockwise_attention = \
        lambda q, k, v, cfg, **kw: flash_attention_plain(q, k, v, **kw)
    ssm.ssd_scan = ssd_scan_plain
    try:
        plain_loss, plain = run()
    finally:
        attention.blockwise_attention, ssm.ssd_scan = saved
    torch.cuda.synchronize()
    assert float(abs(kern_loss - plain_loss)) <= 1e-5 * float(plain_loss)
    for i, (a, bb) in enumerate(zip(kern, plain)):
        # each leaf's worst error over its largest entry
        scale = float(bb.abs().max())
        assert float((a - bb).abs().max()) <= 1e-4 * scale, i


# ---------------------------------------------------------------------------
# the telemetry and live slices
# ---------------------------------------------------------------------------

def _telemetry_grid(dev, hours=2000):
    rng = np.random.default_rng(12)
    prices = np.abs(rng.normal(80.0, 40.0, (4, hours))).astype(np.float32)
    systems = [make_system(f, 1.0, float(hours), device=dev)
               for f in (5e4, 2e5)]
    policies = [PolicySpec("ao"), PolicySpec("x5", x=0.05),
                PolicySpec("h", x=0.1, hysteresis=0.9, off_level=0.3,
                           restart_energy_mwh=0.3, restart_time_h=0.25)]
    return build_grid(prices, systems, policies, device=dev)


def test_telemetry_on_equals_off_on_the_card(cuda, tmp_path):
    """The backtest (one fleet_scan launch a call, on or off) and a
    dispatch on the card, bit for bit with a telemetry run and without;
    the trace reproduces the dispatch totals exactly."""
    from repro_torch import obs
    from repro_torch.dispatch import build_problem, dispatch
    from repro_torch.obs import report

    grid = _telemetry_grid(cuda)
    cold = backtest(grid, device=cuda)
    before = fleet_scan.launches
    with obs.capture(tmp_path / "run"):
        hot = backtest(grid, device=cuda)
        assert fleet_scan.launches == before + 1
        rows = torch.arange(0, grid.n_rows, grid.n_policies, device=cuda)
        problem = build_problem(
            grid.prices[grid.market_idx[rows]], grid.p_on[rows],
            grid.p_off[rows], grid.off_level[rows], grid.power[rows],
            DispatchConfig(demand_frac=0.3, migrate_cost=3.0, min_dwell_h=2),
            fixed=grid.fixed[rows], device=cuda)
        d_hot = dispatch(problem, device=cuda)
    d_cold = dispatch(problem, device=cuda)
    for a, b in zip(cold, hot):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(d_cold.alloc_mw, d_hot.alloc_mw)
    assert d_cold.cpc == d_hot.cpc
    events = report.load_events(tmp_path / "run")
    rec = report.reconstruct_dispatch(events)
    assert rec["cpc"] == d_hot.cpc
    assert rec["n_migrations"] == d_hot.n_migrations
    back = next(e for e in events if e["kind"] == "fleet.backtest")
    assert back["use_pallas"] is True


def test_hourly_companion_matches_the_hour_loop_on_the_card(cuda):
    """`fleet_hourly_ref` (no hour loop) against a per-hour loop of
    `hard_hour_step` on the card: starts and stops exactly, the weighted
    sums within rtol 1e-5."""
    from repro_torch.kernels.ref import fleet_hourly_ref, hard_hour_step
    p, p_on, p_off, lvl, idle = _inputs(64, 2190, seed=5, dev=cuda)
    w = torch.rand(64, device=cuda) + 0.5
    got = fleet_hourly_ref(p, p_on, p_off, lvl, idle, w)
    on = torch.ones(64, device=cuda)
    cols = []
    for t in range(p.shape[1]):
        new, st, cap, draw = hard_hour_step(on, p[:, t], p_on, p_off, lvl,
                                            idle)
        cols.append(torch.stack([(w * cap).sum(), (w * draw * p[:, t]).sum(),
                                 st.sum(),
                                 torch.clamp(on - new, min=0.0).sum()]))
        on = new
    want = torch.stack(cols, 1)
    assert torch.equal(got.starts, want[2]) and torch.equal(got.stops,
                                                            want[3])
    torch.testing.assert_close(got.on_mw, want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got.draw_price, want[1], rtol=1e-5,
                               atol=1e-2)


def test_live_smoke_sweep_on_the_card_matches_the_cpu(cuda):
    """The live operator's smoke sweep (24 controllers x 336 h) on the card
    against the CPU: the quantile family under the exact forecasters equal
    in its decisions, every row's CPC, final threshold and realised
    shutdown fraction within rtol 1e-5, and start and stop counts equal on
    rows with no near-threshold hour."""
    import argparse

    from repro_torch.examples.live_operator import build
    from repro_torch.live import live_backtest
    from repro_torch.live.controller import near_threshold_hours

    args = argparse.Namespace(smoke=True)
    _, lg, cfg, _ = build(args, "cpu")
    got = live_backtest(lg, cfg, device=cuda)
    want = live_backtest(lg, cfg, device="cpu")
    fid, fam = lg.forecaster_id.numpy(), lg.family_id.numpy()
    exact = torch.as_tensor((fam == 0) & (fid != 1))
    near = near_threshold_hours(lg, cfg, 1e-5, device="cpu") \
        + near_threshold_hours(lg, cfg, 1e-5, device=cuda).cpu()
    calm = near == 0
    for name in ("n_starts", "n_stops"):
        g, w_ = getattr(got, name).cpu(), getattr(want, name)
        assert torch.equal(g[exact], w_[exact]), name
        assert torch.equal(g[calm], w_[calm]), name
    assert torch.equal(got.p_off_final.cpu()[exact], want.p_off_final[exact])
    # ratios: the card divides by a host number through its reciprocal
    for name in ("cpc", "p_off_final", "tco", "x_realized"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=1e-5, atol=0.0)


# ---------------------------------------------------------------------------
# the work ledger (csrc/queue_scan.cu) and the faults / workload slice
# ---------------------------------------------------------------------------

LEDGER_SHAPES = [  # (B, N, G, T, D, integer-valued)
    (1, 1, 1, 50, 2, True), (5, 3, 8, 400, 4, True), (7, 7, 3, 333, 0, False),
    (9, 4, 40, 250, 9, True), (6, 2, 5, 300, 9, False),
    (256, 16, 8, 1000, 4, False)]


def _ledger_inputs(b, n, g, t, integer, seed, dev):
    rng = np.random.default_rng(seed)
    if integer:
        prices = rng.integers(0, 100, (n, t)).astype(np.float32)
        dem = rng.integers(0, 5, (g, t)).astype(np.float32)
        lvl, dt = np.zeros(b, np.float32), np.ones(b, np.float32)
        cmwh = rng.integers(1, 6, b).astype(np.float32)
    else:
        prices = rng.normal(80, 30, (n, t)).astype(np.float32)
        dem = rng.uniform(0, 3, (g, t)).astype(np.float32)
        lvl = rng.uniform(0, 0.5, b).astype(np.float32)
        dt = rng.uniform(0.5, 2, b).astype(np.float32)
        cmwh = rng.uniform(1, 4, b).astype(np.float32)
    p_off = rng.uniform(60, 110, b).astype(np.float32)
    arrays = (prices, p_off * np.float32(0.9), p_off, lvl, cmwh, dem, dt)
    return ([torch.as_tensor(a, device=dev) for a in arrays],
            torch.as_tensor(rng.integers(0, n, b), device=dev))


@pytest.mark.parametrize("case", LEDGER_SHAPES)
def test_ledger_kernel_matches_plain_version(cuda, case):
    """`workload_ledger_fwd` against its plain version on the card: bit for
    bit on integer-valued work, within rtol 1e-5 otherwise; telemetry on
    changes no other output bit; one kernel a call (D = 0, D = 9 the
    memory form, B = 1 among the cases)."""
    from repro_torch.kernels.queue_scan import workload_ledger_fwd
    b, n, g, t, d, integer = case
    args, midx = _ledger_inputs(b, n, g, t, integer, sum(case[:5]), cuda)
    kw = dict(deadline=d, bound=3.0, market_idx=midx)
    before = workload_ledger_fwd.device_launches
    got, _ = workload_ledger_fwd(*args, **kw)
    got_t, hr = workload_ledger_fwd(*args, hourly=True, **kw)
    assert workload_ledger_fwd.device_launches - before == 2
    want, hr_w = workload_ledger_fwd(*args, hourly=True, use_kernel=False,
                                     **kw)
    for x, y, z in zip(got, got_t, want):
        assert torch.equal(x, y)
        if integer:
            assert torch.equal(x, z)
        else:
            torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hr, hr_w, rtol=1e-5, atol=1e-4)


# the kernel's window (ref.LEDGER_WINDOW, 16 hours) and one hour either
# side, one hour, rows of 100, 300 and 600 draws (blocks above 256 threads
# take 4-hour windows; 100 and 600 draws take more than 48 KB of shared
# memory with telemetry), and full one-warp blocks at 1, 2, 16 and 32
# draws (their telemetry sums take the one-warp form; 8 draws among
# LEDGER_SHAPES)
LEDGER_MIRROR_SHAPES = LEDGER_SHAPES + [
    (3, 2, 5, 15, 4, False), (3, 2, 5, 16, 4, False),
    (3, 2, 5, 17, 9, False), (1, 1, 1, 1, 4, False),
    (2, 1, 100, 40, 4, False), (2, 1, 300, 33, 4, False),
    (1, 1, 600, 20, 2, False), (40, 4, 1, 40, 4, False),
    (20, 4, 2, 33, 4, True), (4, 3, 16, 31, 9, False),
    (2, 2, 32, 50, 4, False)]


@pytest.mark.parametrize("case", LEDGER_MIRROR_SHAPES)
def test_ledger_kernel_matches_its_mirror(cuda, case):
    """`workload_ledger_fwd` equal bit for bit to its mirror
    (`ref.workload_ledger_seg_ref`: the kernel's closed-form hour and
    order, run on the card), its sums with telemetry off and on and its
    hourly series."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.queue_scan import workload_ledger_fwd
    b, n, g, t, d, integer = case
    args, midx = _ledger_inputs(b, n, g, t, integer, sum(case[:5]), cuda)
    kw = dict(deadline=d, bound=3.0, market_idx=midx)
    got, _ = workload_ledger_fwd(*args, **kw)
    got_t, hr = workload_ledger_fwd(*args, hourly=True, **kw)
    want, hr_w = ref.workload_ledger_seg_ref(*args, hourly=True, **kw)
    for x, y, z in zip(got, got_t, want):
        assert torch.equal(x, z)
        assert torch.equal(y, z)
    assert torch.equal(hr, hr_w)


@pytest.mark.parametrize("b,t,d", [(1, 60, 2), (5, 300, 0), (33, 200, 4),
                                   (7, 150, 9), (70, 500, 3), (32, 96, 4),
                                   (6, 200, 48), (16, 2190, 4)])
def test_soft_ledger_kernels_match_plain_autograd(cuda, b, t, d):
    """A differentiable soft `queue_scan` (`SoftLedger`, the kernel pair)
    against the plain hour loop and autograd through it on the card (with
    prices): float64 forward and backward within 1e-10 of max(1, each
    output's largest entry); float32 (the tuner's form) forward within
    rtol 1e-5, d cap and d demand within 1e-4 of max(1, their largest
    entry). The hard float64 forward (the live replay's ledger; 32 draws
    x 96 h among the shapes) equals the plain loop on integer-valued
    work. A two-day deadline (d 48: 32 lanes, 2 slots a lane) and
    `workload_fleet`'s 16 rows x 2190 h among the shapes."""
    from repro_torch.kernels import queue_scan as qs
    from repro_torch.kernels.ref import queue_scan_ref
    rng = np.random.default_rng(b * t + d)
    a = torch.as_tensor(rng.integers(0, 6, (b, t)).astype(np.float64),
                        device=cuda)
    c = torch.as_tensor(rng.integers(0, 6, (b, t)) + 0.5, device=cuda)
    p = torch.as_tensor(rng.normal(80, 20, (b, t)), device=cuda)
    g = torch.as_tensor(rng.normal(size=(4, b)), device=cuda)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        a_, c_, p_, g_ = (x.to(dtype) for x in (a, c, p, g))
        at, ct = (x.clone().requires_grad_(True) for x in (a_, c_))
        o = qs.queue_scan(at, ct, deadline=d, bound=3.0, tau=0.3, prices=p_)
        sums = (o.served, o.dropped, o.backlog, o.served_cost)
        loss = sum((g_[k] * sums[k]).sum() for k in range(4))
        d_a, d_c = torch.autograd.grad(loss, [at, ct])
        at2, ct2 = (x.clone().requires_grad_(True) for x in (a_, c_))
        out = queue_scan_ref(at2, ct2, deadline=d, bound=3.0, tau=0.3,
                             prices=p_)
        ref_sums = (out.served, out.dropped, out.backlog, out.served_cost)
        loss2 = sum((g_[k] * v).sum() for k, v in enumerate(ref_sums))
        w_a, w_c = torch.autograd.grad(loss2, [at2, ct2])
        pairs = list(zip([d_a, d_c], [w_a, w_c]))
        if dtype == torch.float32:
            for x, y in zip(sums, ref_sums):
                torch.testing.assert_close(x.detach(), y.detach(),
                                           rtol=1e-5, atol=1e-3)
        else:
            pairs += list(zip(sums, ref_sums))
        for x, y in pairs:
            scale = max(1.0, float(y.detach().abs().max()))
            torch.testing.assert_close(x.detach(), y.detach(), rtol=0,
                                       atol=tol * scale)
    hard = qs.queue_scan(a, c - 0.5, deadline=d, bound=3.0)
    want = queue_scan_ref(a, c - 0.5, deadline=d, bound=3.0)
    for x, y in zip(hard, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,t,d", [(3, 37, 0), (2, 30, 1), (33, 200, 4),
                                   (1, 1, 4), (3, 25, 9), (2, 20, 31),
                                   (7, 150, 48), (1, 6, 300),
                                   (16, 2190, 4)])
def test_soft_ledger_kernels_match_their_mirrors(cuda, b, t, d):
    """The soft pair against its mirrors run on the card
    (`ref.soft_ledger_fwd_seg_ref` / `soft_ledger_bwd_seg_ref`: the
    segment plan, the lanes' scans, the butterfly of the sums, the
    coefficient pass and the linear reverse chain in the kernels' order,
    every operation rounded once as the kernels, built without FMA
    contraction, round it, exp and log1p CUDA's own on both sides): every
    output bit for bit, in float64 and float32, with and without prices,
    the hourly series included; the hard forward on integer-valued work
    bit for bit against the mirror and the plain loop. d 0 to 31 put a
    slot on a lane, d 48 two (32 lanes), d 300 keeps its slots in the
    device scratch."""
    from repro_torch.kernels import queue_scan as qs
    from repro_torch.kernels import ref
    rng = np.random.default_rng(b * t + d)
    arrays = (rng.uniform(0, 1.5, (b, t)), rng.uniform(0, 2.0, (b, t)),
              rng.normal(80, 20, (b, t)), rng.normal(size=(4, b)))
    ints = (rng.integers(0, 6, (b, t)), rng.integers(0, 6, (b, t)),
            np.round(rng.normal(80, 20, (b, t))))
    for dtype in (torch.float64, torch.float32):
        a, c, p, g = (torch.as_tensor(x, device=cuda).to(dtype)
                      for x in arrays)
        tau = torch.tensor([0.3], dtype=dtype, device=cuda)
        for pr in (p, None):
            kw = dict(deadline=d, bound=3.0, prices=pr)
            got = qs.soft_ledger_fwd(a, c, tau, hourly=True, **kw)
            want = ref.soft_ledger_fwd_seg_ref(a, c, tau, hourly=True, **kw)
            got += qs.soft_ledger_bwd(a, c, tau, got[1], g, **kw)
            want += ref.soft_ledger_bwd_seg_ref(a, c, tau, want[1], g, **kw)
            for x, y in zip(got, want):
                assert torch.equal(x, y)
        ah, ch, ph = (torch.as_tensor(x, device=cuda).to(dtype)
                      for x in ints)
        kw = dict(deadline=d, bound=3.0, prices=ph, hard=True, hourly=True)
        got = qs.soft_ledger_fwd(ah, ch, None, **kw)
        for want in (ref.soft_ledger_fwd_seg_ref(ah, ch, None, **kw),
                     ref.soft_ledger_fwd_ref(ah, ch, None, **kw)):
            for i in (0, 2, 3):
                assert torch.equal(got[i], want[i])


def test_soft_ledger_backward_windows_carry_the_adjoint(cuda):
    """At 1024 rows x 8760 h x d 4 in float32 the backward's coefficients
    outgrow one window (128 MiB): several windows of hours, two kernels
    each, the queue's adjoint carried between them; d cap and d demand
    equal the mirror's (one pass over all hours) bit for bit."""
    from repro_torch.kernels import queue_scan as qs
    from repro_torch.kernels import ref
    b, t, d = 1024, 8760, 4
    rng = np.random.default_rng(5)
    a, c, p = (torch.as_tensor(x, device=cuda).float() for x in (
        rng.uniform(0, 1.5, (b, t)), rng.uniform(0, 2.0, (b, t)),
        rng.normal(80, 20, (b, t))))
    g = torch.as_tensor(rng.normal(size=(4, b)), device=cuda).float()
    tau = torch.tensor([0.3], device=cuda)
    kw = dict(deadline=d, bound=3.0, prices=p)
    hist = qs.soft_ledger_fwd(a, c, tau, **kw)[1]
    n0 = qs.soft_ledger_bwd.device_launches
    got = qs.soft_ledger_bwd(a, c, tau, hist, g, **kw)
    assert qs.soft_ledger_bwd.device_launches - n0 > 2
    want = ref.soft_ledger_bwd_seg_ref(a, c, tau, hist, g, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_workload_and_faulted_backtests_on_the_card(cuda):
    """The coupled backtest's report equals `backtest` on the card bit for
    bit and its ledger the CPU's within rtol 1e-5; a zero-fault
    `faulted_backtest` is `backtest` bit for bit; a storm's start counts
    equal the CPU's and its sums within rtol 1e-5."""
    from repro_torch.energy.markets import MarketParams
    from repro_torch.faults import faulted_backtest, random_storm
    from repro_torch.workload import Workload, workload_backtest
    grid = build_grid([MarketParams(n_hours=2190, seed=s) for s in range(4)],
                      [make_system(0.8 * 2190 * 80.0, 1.0, 2190.0,
                                   device="cpu")],
                      [PolicySpec("ao"), PolicySpec("x10", x=0.1,
                                                    off_level=0.3),
                       PolicySpec("x25", x=0.25, off_level=0.3)],
                      workload=Workload(n_draws=16, seed=2), device="cpu")
    got = workload_backtest(grid, device=cuda)
    plain = backtest(grid, device=cuda)
    for f in plain._fields:
        assert torch.equal(getattr(got.report, f), getattr(plain, f)), f
    want = workload_backtest(grid, device="cpu")
    for f in want.workload._fields:
        torch.testing.assert_close(getattr(got.workload, f).cpu(),
                                   getattr(want.workload, f), rtol=1e-5,
                                   atol=1e-3)
    for f, x in zip(plain._fields, faulted_backtest(grid, device=cuda)):
        assert torch.equal(x, getattr(plain, f)), f
    storm = random_storm(7, grid.n_rows, grid.n_markets, 2190,
                         max_duration=180)
    hit, hit_cpu = (faulted_backtest(grid, storm, device=dev)
                    for dev in (cuda, "cpu"))
    assert torch.equal(hit.n_starts.cpu(), hit_cpu.n_starts)
    torch.testing.assert_close(hit.cpc.cpu(), hit_cpu.cpc, rtol=1e-5,
                               atol=0.0)


# ---------------------------------------------------------------------------
# the MoE, audio and int8 slice: the attention kernels at its shapes, the
# engine over mixtral and an int8 pool, whisper's prefill and decode
# ---------------------------------------------------------------------------

# B, Sq, Skv, H, G, Dh, causal, window, dtype: whisper-large-v3's
# cross-attention (a 4-token prompt over the 1500 encoder frames: Sq != Skv,
# Skv not a multiple of the key tile) and its bidirectional encoder (20
# heads, each its own group, Dh 64), then mixtral's 48 / 8 heads at Dh 128
# with the window crossed (a 600-token prefill, window 512)
@pytest.mark.parametrize("case", [
    (8, 4, 1500, 20, 20, 64, False, 0, torch.bfloat16),
    (2, 37, 1500, 20, 20, 64, False, 0, torch.float32),
    (1, 1500, 1500, 20, 20, 64, False, 0, torch.bfloat16),
    (1, 600, 600, 48, 8, 128, True, 512, torch.bfloat16)])
def test_flash_kernel_at_the_slices_shapes(cuda, case):
    b, sq, skv, h, g, dh, causal, win, dt = case
    q, k, v = _attn_inputs([(b, sq, h, dh), (b, skv, g, dh),
                            (b, skv, g, dh)], dt, cuda, sq + skv + h)
    got = flash_attention(q, k, v, causal=causal, window=win,
                          use_kernel=True)
    want = flash_attention_plain(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dt])


# B, H, G, Dh, W, dtype: whisper's cross cache (1500 slots, every one
# valid: six 256-slot splits, the last partial) and mixtral's rolling pool
@pytest.mark.parametrize("case", [(8, 20, 20, 64, 1500, torch.bfloat16),
                                  (3, 20, 20, 64, 1500, torch.float32),
                                  (8, 48, 8, 128, 4096, torch.bfloat16)])
def test_decode_kernel_at_the_slices_shapes(cuda, case):
    b, h, g, dh, w, dt = case
    q, k, v = _attn_inputs([(b, 1, h, dh), (b, w, g, dh), (b, w, g, dh)],
                           dt, cuda, w + h)
    valid = torch.ones((b, w), dtype=torch.int8, device=cuda)
    got = decode_attention(q, k, v, valid, use_kernel=True)
    want = decode_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dt])


@pytest.mark.parametrize("arch, int8", [("mixtral-8x22b", False),
                                        ("mixtral-8x22b", True),
                                        ("qwen2.5-3b", True)])
def test_moe_and_int8_engines_on_the_card_match_the_cpu(cuda, arch, int8):
    """Reduced mixtral (window 8: prompts past it) and an int8 pool at
    float32: the engine on the card returns the CPU's tokens; one flash
    launch per layer and prefill; one decode launch per layer and step
    on a bf16 pool, and the plain int8 decode (the reference's route for
    an int8 cache) instead of it on an int8 pool."""
    from repro_torch.models.attention import decode_attention_int8
    cfg = reduced_config(get_config(arch))
    if int8:
        cfg = cfg.replace(kv_cache_dtype="int8")
    cpu_params = init_params(5, cfg, device="cpu")
    outputs, launches = {}, {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(_tree_to(cpu_params, dev), cfg,
                            ServeConfig(slots=4, max_seq=48), device=dev)
        rng = np.random.default_rng(2)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(
                2, cfg.vocab - 1, size=int(rng.integers(5, 20))).astype(
                    np.int32), max_new=8))
        before = (flash_attention.launches, decode_attention.launches,
                  decode_attention_int8.calls)
        out = eng.run(ticks=30)
        launches[str(dev)] = tuple(a - b for a, b in zip(
            (flash_attention.launches, decode_attention.launches,
             decode_attention_int8.calls), before))
        outputs[str(dev)] = ({r.rid: r.output for r in eng.completed},
                             out["tokens_served"], out["completed"])
    assert outputs[str(cuda)] == outputs["cpu"]
    assert outputs["cpu"][2] == 6
    flash, dec, dec8 = launches[str(cuda)]
    assert flash == 6 * cfg.n_layers and launches["cpu"][:2] == (0, 0)
    steps = (dec8 if int8 else dec) // cfg.n_layers
    assert steps > 0 and (dec if int8 else dec8) == 0
    assert launches["cpu"][2] == (steps * cfg.n_layers if int8 else 0)


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """Reduced whisper at float32: prefill (encoder, self- and
    cross-attention) and 6 decode steps on the card give the CPU's logits
    within 1e-4, with 3 flash launches per layer a prefill (encoder,
    self, cross) and 2 decode launches per layer a step (self, cross)."""
    from repro_torch.models.model import decode_step, prefill
    cfg = reduced_config(get_config("whisper-large-v3"))
    cpu_params = init_params(5, cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(2, cfg.vocab - 1, (2, 7))
    frames = rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    rows, launches = {}, {}
    for dev in ("cpu", cuda):
        params = _tree_to(cpu_params, dev)
        before = (flash_attention.launches, decode_attention.launches)
        logits, caches = prefill(params, {
            "tokens": torch.as_tensor(toks, device=dev),
            "frames": torch.as_tensor(frames, device=dev)}, cfg, max_seq=16)
        out = [logits.cpu()]
        for i in range(6):
            nxt = torch.argmax(out[-1], -1)[:, None]
            logits, caches = decode_step(
                params, nxt.to(dev), caches,
                torch.full((2,), 7 + i, device=dev), cfg)
            out.append(logits.cpu())
        rows[str(dev)] = torch.stack(out)
        launches[str(dev)] = (flash_attention.launches - before[0],
                              decode_attention.launches - before[1])
    torch.testing.assert_close(rows[str(cuda)], rows["cpu"], atol=1e-4,
                               rtol=1e-4)
    assert launches["cpu"] == (0, 0)
    assert launches[str(cuda)] == (3 * cfg.n_layers, 6 * 2 * cfg.n_layers)
