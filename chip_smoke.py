#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from `src/` (one nvcc per source, all
     started together; sm_90a), printing ptxas' registers and spills;
  3. each kernel against its plain PyTorch version on the card;
  4. the backtest path at full size: the Lichtenberg case study, then
     the fleet backtest and summary of the repo's benchmark grid (16
     German market draws x 8 systems x 8 policies = 1024 rows x 8760 h);
  5. the tuner path at full width: `optimize` on the tuner benchmark's
     grid (8 market draws x 4 systems x 8 policies = 256 rows x 2190 h,
     200 annealed Adam steps) with the hard-dispatch re-scoring of its 32
     cells, once more with relief and a demand above availability (each
     re-scoring's allocations held bit for bit against the plain version
     on the same problems), then the `tune_policies` demo;
  6. `tune_loop_checkpointed` stopped after stage 2 and resumed, against
     an uninterrupted run, bit for bit;
  7. the dispatch path at full width: the `fleet_dispatch` example (8
     sites x 8760 h) and `summarize(dispatch_cfg=)` over the dispatch
     benchmark's 64 sites x 8760 h;
  8. times (median of CUDA-event runs after warm-up): each kernel, its
     plain version and its bound, the backtest at 1024 and 8192 rows,
     market generation, the tuner loop's row-steps/s (hand-written VJP
     against autograd through the doubling scan), and one whole dispatch
     call split into its parts;
each path's kernel launch counts are set to 0 just before it and read
just after. Then one JSON line describing every ported kernel and, last,
one JSON line naming the device. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# the dispatch benchmark's constraints (`benchmarks/bench_dispatch.py`)
BENCH_DISPATCH = dict(demand_frac=0.4, migrate_cost=5.0, min_dwell_h=4)
TIMED_RUNS = 10


def _import_port():
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)


def _cuda_ms(fn, runs: int = TIMED_RUNS, flush: torch.Tensor | None = None,
             device_only: bool = False) -> float:
    """Median time of ``fn()`` over ``runs`` runs after one warm-up, each
    bracketed by CUDA events. ``flush`` is overwritten before each run so
    that its inputs come from device memory, not the L2 cache.
    ``device_only`` first queues a spin kernel, so the card is still busy
    when the host has queued the start event and ``fn``'s launches: the
    events then time the device work alone, not the host's enqueueing."""
    fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        if device_only:
            torch.cuda._sleep(2_000_000)          # ~1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _scan_inputs(b: int, t: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    p = rng.normal(80, 40, (b, t)).astype(np.float32)
    p_off = rng.uniform(40, 160, b).astype(np.float32)
    p_on = (p_off * rng.uniform(0.7, 1.0, b)).astype(np.float32)
    lvl = rng.uniform(0.0, 0.6, b).astype(np.float32)
    idle = rng.uniform(0.0, 0.3, b).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (p, p_on, p_off, lvl,
                                                     idle)]


def _bench_grid(n_markets: int, n_systems: int, dev, hours: int = 8760):
    """`benchmarks/bench_fleet.py`'s grid: German market draws x systems
    with Psi in geomspace(0.5, 6) x its 8 policies."""
    from repro_torch.core.tco import make_system
    from repro_torch.energy.presets import region_params
    from repro_torch.fleet import PolicySpec, build_grid, elastic_policy

    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(n_markets)]
    p_avg = markets[0].p_avg
    psis = np.geomspace(0.5, 6.0, n_systems)
    systems = [make_system(float(psi) * hours * 1.0 * p_avg, 1.0,
                           float(hours), device=dev) for psi in psis]
    policies = [
        PolicySpec("always_on"),
        PolicySpec("x1", x=0.01),
        PolicySpec("x2", x=0.02),
        PolicySpec("x5", x=0.05),
        PolicySpec("x2_hyst", x=0.02, hysteresis=0.9,
                   restart_energy_mwh=0.3, restart_time_h=0.25),
        PolicySpec("x5_hyst", x=0.05, hysteresis=0.85,
                   restart_energy_mwh=0.3, restart_time_h=0.25),
        PolicySpec("x5_idle", x=0.05, idle_frac=0.05),
        elastic_policy("x5_half_dp", level=0.5, dp_total=16, x=0.05),
    ]
    grid = build_grid(markets, systems, policies,
                      market_names=[f"de-seed{s}" for s in range(n_markets)],
                      system_names=[f"psi{psi:.2f}" for psi in psis],
                      device=dev)
    return markets, grid


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    return card


KERNEL_SOURCES = ("fleet_scan", "soft_scan", "dispatch_scan")

# A probe of the card, not a kernel of the port: one thread adds 1.0 to x
# n times, each addition waiting on the last, so a chain takes n times the
# latency of a dependent float64 addition (the step of dispatch_scan's
# serial prefix walk).
F64_CHAIN_SRC = r"""
#include <cuda_runtime.h>
__global__ void f64_add_chain_kernel(double* out, int n) {
  double x = out[0];
  for (int i = 0; i < n; ++i) x += 1.0;
  out[0] = x;
}
extern "C" int f64_add_chain(double* out, int n, void* stream) {
  f64_add_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
"""
PROBE_DIR = ROOT / "build" / "chip_smoke_probe"


def _build_probe() -> str:
    from repro_torch.kernels import build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src = PROBE_DIR / "f64_add_chain.cu"
    src.write_text(F64_CHAIN_SRC)
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         str(PROBE_DIR / "libf64_add_chain.so"), str(src)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probe:\n{proc.stdout}"
                           f"{proc.stderr}")
    return proc.stdout + proc.stderr


def phase_build() -> None:
    from repro_torch.kernels import build

    def one(name):
        t0 = time.perf_counter()
        log = _build_probe() if name is None else build.build(name)
        return name, log, time.perf_counter() - t0

    jobs = KERNEL_SOURCES + (None,)
    with ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(one, jobs))
    for name, log, secs in results:
        print(f"[build] {name or 'probe f64_add_chain'}.cu: {secs:.2f} s")
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"[build]   {line.strip()}")
        if name is not None:
            build.load(name)


def phase_kernel_vs_plain(dev) -> None:
    """n_starts equal to the plain float32 version; sums within rtol 2e-5
    of the plain version run in float64 on the same (float32) inputs,
    which follows the same trajectory without float32 accumulation error
    (at 8760 h the plain float32 running sum of a non-dyadic capacity
    level drifts by ~1e-4 relative, more than the kernel's chunked sums)."""
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.ref import fleet_scan_ref

    for i, (b, t) in enumerate([(1, 64), (5, 333), (130, 1000),
                                (1024, 8760), (64, 4097)]):
        args = _scan_inputs(b, t, seed=100 + i, dev=dev)
        got = fleet_scan(*args, use_kernel=True)
        plain = fleet_scan(*args, use_kernel=False)
        exact = fleet_scan_ref(args[0].double(), *args[1:])
        torch.cuda.synchronize()
        if not torch.equal(got.n_starts, plain.n_starts):
            raise AssertionError(f"fleet_scan {b}x{t}: n_starts differ")
        errs = []
        for name in got._fields:
            g, e = getattr(got, name).double(), getattr(exact, name)
            torch.testing.assert_close(g, e, rtol=2e-5, atol=1e-3,
                                       msg=f"fleet_scan {b}x{t} {name}")
            errs.append(f"{name} {float((g - e).abs().max()):.3g}/"
                        f"{float((getattr(plain, name).double() - e).abs().max()):.3g}")
        print(f"[kernel] fleet_scan {b}x{t}: max |err| kernel/plain-f32 vs "
              f"plain-f64: " + ", ".join(errs))


SOFT_SHAPES = [(1, 64, 64), (5, 333, 64), (130, 1000, 256),
               (256, 2190, 256), (64, 4097, 256), (1024, 8760, 256)]
SOFT_TAU = 3.0       # mid-anneal: gates neither flat nor saturated


def _soft_inputs(b: int, t: int, seed: int, dev):
    """Prices, thresholds, inv_tau [1] and a positive cotangent g [B, T]
    (g > 0 keeps every hour's d_p_on and d_p_off term of one sign, so
    their sums carry no cancellation and a relative tolerance holds)."""
    p, p_on, p_off = _scan_inputs(b, t, seed, dev)[:3]
    rng = np.random.default_rng(seed + 7)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, (b, t)).astype(np.float32),
                        device=dev)
    itau = torch.tensor([1.0 / SOFT_TAU], dtype=torch.float32, device=dev)
    return p, p_on, p_off, itau, g


def phase_soft_vs_plain(dev) -> dict:
    """Both soft-scan kernels against their plain blocked versions run in
    float64 on the same (float32) inputs. States and carries within atol
    1e-5; d_p within rtol 2e-5 + atol 1e-5 max|d_p|; the sums d_p_on,
    d_p_off and d_tau within rtol 2e-5 of their float64 values. The max
    |err| of the plain float32 run is printed beside the kernel's, and
    |d_tau| beside its tolerance."""
    from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,
                                                   soft_scan_fwd)

    out = {}
    for i, (b, t, bt) in enumerate(SOFT_SHAPES):
        p, p_on, p_off, itau, g = _soft_inputs(b, t, 200 + i, dev)
        f64 = [x.double() for x in (p, p_on, p_off, itau)]
        s, carr = soft_scan_fwd(p, p_on, p_off, itau, block_t=bt,
                                use_kernel=True)
        s32, c32 = soft_scan_fwd(p, p_on, p_off, itau, block_t=bt,
                                 use_kernel=False)
        s64, c64 = soft_scan_fwd(*f64, block_t=bt, use_kernel=False)
        got = soft_scan_bwd(p, p_on, p_off, itau, carr, g, block_t=bt,
                            use_kernel=True)
        plain = soft_scan_bwd(p, p_on, p_off, itau, c32, g, block_t=bt,
                              use_kernel=False)
        exact = soft_scan_bwd(*f64, c64, g.double(), block_t=bt,
                              use_kernel=False)
        torch.cuda.synchronize()
        lab = f"soft_scan {b}x{t}/{bt}"
        torch.testing.assert_close(s.double(), s64, rtol=0, atol=1e-5,
                                   msg=f"{lab} s")
        torch.testing.assert_close(carr.double(), c64, rtol=0, atol=1e-5,
                                   msg=f"{lab} carries")
        dp_scale = float(exact[0].abs().max())
        torch.testing.assert_close(got[0].double(), exact[0], rtol=2e-5,
                                   atol=1e-5 * dp_scale, msg=f"{lab} d_p")
        for k, name in ((1, "d_p_on"), (2, "d_p_off")):
            torch.testing.assert_close(got[k].double(), exact[k],
                                       rtol=2e-5, atol=0.0,
                                       msg=f"{lab} {name}")
        itau64 = float(f64[3][0])
        d_tau = [-(itau64 ** 2) * float(x[3]) for x in (got, plain, exact)]
        tol = 2e-5 * abs(d_tau[2])
        print(f"[kernel] {lab}: |d_tau| {abs(d_tau[2]):.6g}, tolerance "
              f"{tol:.3g}, kernel err {abs(d_tau[0] - d_tau[2]):.3g}")
        if abs(d_tau[0] - d_tau[2]) > tol:
            raise AssertionError(f"{lab} d_tau {d_tau[0]} vs {d_tau[2]}")

        def err(a, b_):
            return float((a.double() - b_).abs().max())
        errs = {"s": (err(s, s64), err(s32, s64)),
                "carries": (err(carr, c64), err(c32, c64)),
                "d_p": (err(got[0], exact[0]), err(plain[0], exact[0])),
                "d_p_on": (err(got[1], exact[1]), err(plain[1], exact[1])),
                "d_p_off": (err(got[2], exact[2]),
                            err(plain[2], exact[2])),
                "d_tau": (abs(d_tau[0] - d_tau[2]),
                          abs(d_tau[1] - d_tau[2]))}
        print(f"[kernel] {lab}: max |err| kernel/plain-f32 vs plain-f64: "
              + ", ".join(f"{k} {a:.3g}/{b_:.3g}"
                          for k, (a, b_) in errs.items()))
        out[(b, t)] = errs
    return out


def _dispatch_fleet(n_sites: int, dev, hours: int = 8760, **cfg):
    """`benchmarks/bench_dispatch.py`'s fleet: ``n_sites`` German market
    draws, one Psi = 2 system of 1 MW, the 5%-shutdown hysteresis policy
    at off level 0.25 (one row per site). Returns the grid and the
    `DispatchProblem` of ``cfg`` (default: the benchmark's) over it."""
    from repro_torch.core.tco import make_system
    from repro_torch.dispatch import DispatchConfig, build_problem
    from repro_torch.energy.presets import region_params
    from repro_torch.fleet import PolicySpec, build_grid

    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(n_sites)]
    system = make_system(2.0 * hours * 1.0 * markets[0].p_avg, 1.0,
                         float(hours), device=dev)
    grid = build_grid(markets, [system],
                      [PolicySpec("x5h", x=0.05, hysteresis=0.9,
                                  off_level=0.25)],
                      market_names=[f"de-seed{s}" for s in range(n_sites)],
                      system_names=["psi2.0"], device=dev)
    problem = build_problem(grid.prices, grid.p_on, grid.p_off,
                            grid.off_level, grid.power,
                            DispatchConfig(**(cfg or BENCH_DISPATCH)),
                            fixed=grid.fixed, device=dev)
    return grid, problem


def _random_dispatch(s: int, t: int, migrate_cost: float, min_dwell: int,
                     seed: int, relief=None):
    """Random prices and float32 availability with a demand between 30%
    and 90% of each hour's availability (above it in every 50th hour when
    ``relief`` is given)."""
    from repro_torch.dispatch import DispatchProblem, segment_rank

    rng = np.random.default_rng(seed)
    prices = rng.normal(80, 40, (s, t)).astype(np.float32)
    avail = rng.uniform(0.0, 400.0 / s, (s, t)).astype(np.float32)
    demand = rng.uniform(0.3, 0.9, t) * avail.sum(axis=0)
    if relief is not None:
        demand[::50] = 1.3 * avail.sum(axis=0)[::50]
    order, rank = segment_rank(prices, migrate_cost)
    return DispatchProblem(
        prices=prices, avail_mw=avail, demand_mw=demand.astype(np.float32),
        power_cap_mw=float("inf"), migrate_cost=migrate_cost,
        min_dwell_h=min_dwell, compute_floor_mwh=0.0, fixed_cost=1e4,
        order=order, rank=rank, relief=relief)


def phase_dispatch_vs_plain(dev) -> float:
    """`dispatch` on the card (the CUDA kernel) against the same call on
    the CPU (the plain `dispatch_ref`): the allocations must be bitwise
    equal, since the two share one summation order. Returns the largest
    |difference| (0)."""
    from repro_torch.dispatch import Relief, dispatch, diurnal_demand

    cases = [
        ("1 x 7", _random_dispatch(1, 7, 0.0, 0, 500)),
        ("8 x 1000, migrate 0, dwell 0",
         _random_dispatch(8, 1000, 0.0, 0, 501)),
        ("5 x 333 ragged, migrate 5, dwell 2",
         _random_dispatch(5, 333, 5.0, 2, 502)),
        ("bench_dispatch 64 x 8760, demand 0.4, migrate 5, dwell 4",
         _dispatch_fleet(64, dev)[1]),
        ("512 x 300, migrate 5, dwell 4",
         _random_dispatch(512, 300, 5.0, 4, 503)),
        ("relief 16 x 2000, short hours",
         _random_dispatch(16, 2000, 5.0, 4, 504, relief=Relief())),
        # 1.3 +- 0.6 MW: below the 8 x 0.25 MW the fleet offers when
        # every site is off, so feasible whatever the prices
        ("diurnal 8 x 8760, migrate 5, dwell 4",
         _dispatch_fleet(8, dev, demand_mw=diurnal_demand(
             8760, base_mw=1.3, swing_mw=0.6, peak_hour=18.0),
             migrate_cost=5.0, min_dwell_h=4)[1]),
    ]
    worst = 0.0
    for label, problem in cases:
        got = dispatch(problem, device=dev)
        plain = dispatch(problem, device="cpu")
        diff = float(np.abs(got.alloc_mw - plain.alloc_mw).max())
        worst = max(worst, diff)
        print(f"[kernel] dispatch_scan {label}: max |kernel - plain| "
              f"{diff:.3g}, n_migrations {got.n_migrations} / "
              f"{plain.n_migrations}, shed hours {got.n_shed_hours}")
        if not np.array_equal(got.alloc_mw, plain.alloc_mw) \
                or got.n_migrations != plain.n_migrations:
            raise AssertionError(f"dispatch_scan {label}: kernel differs "
                                 "from its plain version")
        if label.startswith("relief") and got.n_shed_hours == 0:
            raise AssertionError("the relief case shed nothing")
    return worst


def phase_main_path(dev) -> dict:
    from repro_torch.core.tco import make_system
    from repro_torch.examples.fleet_backtest import print_tables
    from repro_torch.examples.quickstart import lichtenberg, report
    from repro_torch.fleet import PolicySpec, backtest, build_grid, summarize
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.ref import fleet_scan_ref

    print("[main] Lichtenberg case study (Section IV-A) on the card:")
    report(lichtenberg(dev))

    # ---- counted run: the main path at full size through the entry points
    fleet_scan.launches = 0
    markets, grid = _bench_grid(16, 8, dev)
    rep = backtest(grid, device=dev)
    summ = summarize(grid, rep)
    torch.cuda.synchronize()
    launches = {"fleet_scan": fleet_scan.launches}
    print(f"[main] grid {grid.n_markets} x {grid.n_systems} x "
          f"{grid.n_policies} = {grid.n_rows} rows x {grid.n_hours} h; "
          f"launches {launches}")
    if launches["fleet_scan"] < 1:
        raise AssertionError("the main path never launched fleet_scan")

    for name in rep._fields:
        v = getattr(rep, name)
        if tuple(v.shape) != (grid.n_rows,) or not bool(
                torch.isfinite(v.double()).all()):
            raise AssertionError(f"FleetReport.{name}: not finite [B]")
    if not (np.all(np.isfinite(summ.oracle_reduction))
            and np.all(summ.best_policy >= 0)):
        raise AssertionError("FleetSummary: uncovered or non-finite cells")

    plain = backtest(grid, use_kernel=False, device=dev)
    torch.testing.assert_close(rep.cpc, plain.cpc, rtol=1e-5, atol=0.0)
    if not torch.equal(rep.n_starts, plain.n_starts):
        raise AssertionError("backtest: n_starts differ from the plain run")
    print(f"[main] per-row cpc vs use_kernel=False: max rel "
          f"{float(((rep.cpc - plain.cpc) / plain.cpc).abs().max()):.3g}, "
          f"n_starts equal")

    # small input: the card's backtest against the CPU's plain one
    rng = np.random.default_rng(11)
    prices = rng.lognormal(4.3, 0.5, (2, 1200)).astype(np.float32)
    small = {}
    for d in ("cpu", dev):
        sys_ = [make_system(f, 1.0, 1200.0, device=d)
                for f in (60_000.0, 150_000.0)]
        g = build_grid(prices, sys_, [PolicySpec("ao"),
                                      PolicySpec("x3", x=0.03),
                                      PolicySpec("h", x=0.05,
                                                 hysteresis=0.9)],
                       device=d)
        small[str(d)] = backtest(g, device=d)
    torch.testing.assert_close(small[str(dev)].cpc.cpu(), small["cpu"].cpc,
                               rtol=1e-5, atol=0.0)
    if not torch.equal(small[str(dev)].n_starts.cpu(),
                       small["cpu"].n_starts):
        raise AssertionError("small grid: n_starts differ card vs CPU")
    print("[main] 2x2x3 rows x 1200 h: card (kernel) == CPU (plain) "
          "within rtol 1e-5, n_starts equal")
    print_tables(grid, summ)

    # the kernel on the main path's own inputs, held as in phase 3
    p_rows = grid.prices[grid.market_idx].contiguous()
    scan_args = (p_rows, grid.p_on, grid.p_off, grid.off_level,
                 grid.idle_frac)
    got = fleet_scan(*scan_args, use_kernel=True)
    exact = fleet_scan_ref(p_rows.double(), *scan_args[1:])
    for g, e in zip(got, exact):
        torch.testing.assert_close(g.double(), e, rtol=2e-5, atol=1e-3)
    max_abs = max(float((g.double() - e).abs().max())
                  for g, e in zip(got, exact))
    print(f"[main] fleet_scan on the grid's {tuple(p_rows.shape)} block: "
          f"max |err| vs plain-f64 {max_abs:.3g}")
    return {"grid": grid, "launches": launches, "scan_args": scan_args,
            "max_abs_err": max_abs, "markets": markets}


def _tune_grid(dev, n_markets: int = 8, n_systems: int = 4,
               hours: int = 2190):
    """`benchmarks/bench_tune.py`'s grid: German market draws x systems
    with Psi in geomspace(0.5, 4) x its 8 policies (256 rows x 2190 h)."""
    from repro_torch.core.tco import make_system
    from repro_torch.energy.presets import region_params
    from repro_torch.fleet import PolicySpec, build_grid

    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(n_markets)]
    p_avg = markets[0].p_avg
    psis = np.geomspace(0.5, 4.0, n_systems)
    systems = [make_system(float(psi) * hours * 1.0 * p_avg, 1.0,
                           float(hours), device=dev) for psi in psis]
    policies = [
        PolicySpec("always_on"),
        PolicySpec("x1", x=0.01), PolicySpec("x3", x=0.03),
        PolicySpec("x8", x=0.08), PolicySpec("x15", x=0.15),
        PolicySpec("x25", x=0.25),
        PolicySpec("x3_hyst", x=0.03, hysteresis=0.9),
        PolicySpec("x8_hyst", x=0.08, hysteresis=0.85),
    ]
    return build_grid(markets, systems, policies, device=dev)


def _counters():
    from repro_torch.kernels.dispatch_scan import dispatch_scan
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,
                                                   soft_scan_fwd)
    return {"fleet_scan": fleet_scan, "soft_scan_fwd": soft_scan_fwd,
            "soft_scan_bwd": soft_scan_bwd, "dispatch_scan": dispatch_scan}


def _zero_counters() -> dict:
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def phase_tuner(dev) -> dict:
    """The tuner at full width through `optimize`, re-scored on feasible
    dispatch over its 32 (market, system) cells, with every kernel's
    launch count set to 0 just before and read just after; once more with
    relief and a demand above availability; then the `tune_policies` demo
    (48 rows x 4380 h, 300 steps, 8 resamples)."""
    from repro_torch.dispatch import DispatchConfig, Relief
    from repro_torch.examples import tune_policies
    from repro_torch.tune import Coupling, TuneConfig, cell_best_rows, optimize

    grid = _tune_grid(dev)
    reeval = DispatchConfig(demand_frac=0.3, migrate_cost=5.0, min_dwell_h=4)
    cfg = TuneConfig(steps=200, coupling=Coupling(reeval=reeval))
    counters = _zero_counters()
    t0 = time.perf_counter()
    res = optimize(grid, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"[tune] optimize {grid.n_rows} rows x {grid.n_hours} h x "
          f"{cfg.steps} steps: {wall:.2f} s wall (first call); launches "
          f"{launches}")
    for k in ("soft_scan_fwd", "soft_scan_bwd"):
        if launches[k] < cfg.steps:
            raise AssertionError(f"the tuner launched {k} {launches[k]} "
                                 f"times in {cfg.steps} steps")
    if launches["fleet_scan"] < 1:
        raise AssertionError("the hard re-evaluations never launched "
                             "fleet_scan")
    _check_reeval(res, launches["dispatch_scan"], grid, reeval, dev,
                  shed=False)
    for name in ("cpc", "cpc_tuned", "cpc_swept", "cpc_swept_best",
                 "improvement_vs_best", "improvement_vs_own", "stage_cpc"):
        v = np.asarray(getattr(res, name), np.float64)
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"TuneResult.{name} is not finite")
    for name, v in res.raw._asdict().items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"TuneResult.raw.{name} not finite")
    # a selected swept always-on policy keeps its thresholds at +inf;
    # everything else, off_level included, is finite
    chosen = np.where(res.source == 1, np.arange(grid.n_rows),
                      cell_best_rows(grid, res.cpc_swept))
    always_on = torch.as_tensor(res.source != 0, device=dev) & torch.isinf(
        grid.p_off[torch.as_tensor(chosen, device=dev)])
    for name, v in res.params._asdict().items():
        inf_ok = always_on if name in ("p_on", "p_off") \
            else torch.zeros_like(always_on)
        if not bool((torch.isfinite(v) | (inf_ok & (v == float("inf"))))
                    .all()):
            raise AssertionError(f"TuneResult.params.{name} not finite "
                                 "(p_on/p_off may be +inf only for a "
                                 "selected swept always-on policy)")
    for k, v in res.history.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"TuneResult.history[{k!r}] not finite")
    ok = res.cpc <= res.cpc_swept_best * (1 + 1e-6)
    if not ok.all():
        raise AssertionError(f"guarantee broken on {(~ok).sum()} rows")
    print(f"[tune] guarantee cpc <= cpc_swept_best on all {grid.n_rows} "
          f"rows; strictly better on "
          f"{int((res.cpc < res.cpc_swept_best * (1 - 1e-6)).sum())}; "
          f"mean improvement vs best swept "
          f"{res.improvement_vs_best.mean():.4%}; sources "
          f"{np.bincount(res.source, minlength=3).tolist()}; guard "
          f"{res.guard_count}; loss {res.history['loss'][0]:.6f} -> "
          f"{res.history['loss'][-1]:.6f}; stage cpc "
          f"{np.round(res.stage_cpc, 4).tolist()}")

    # relief: a demand above availability sheds instead of raising; the
    # Coupling-level relief covers the re-scoring
    reeval_r = DispatchConfig(demand_frac=0.95, migrate_cost=5.0,
                              min_dwell_h=4)
    relief_cfg = TuneConfig(steps=50, coupling=Coupling(reeval=reeval_r,
                                                        relief=Relief()))
    counters["dispatch_scan"].launches = 0
    res_r = optimize(grid, relief_cfg, device=dev)
    torch.cuda.synchronize()
    _check_reeval(res_r, counters["dispatch_scan"].launches, grid,
                  reeval_r._replace(relief=Relief()), dev, shed=True)

    print("[tune] repro_torch.examples.tune_policies (default demo) on "
          "the card:")
    t0 = time.perf_counter()
    rc = tune_policies.main(["--device", str(dev)])
    print(f"[tune] demo exit {rc}, {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError("tune_policies: guarantee broken")
    return {"grid": grid, "launches": launches}


def _check_reeval(res, launches: int, grid, dcfg, dev, *,
                  shed: bool) -> None:
    """The re-scoring of one `optimize`: both policy sets dispatched
    through the kernel (two launches), feasible (or shedding under
    relief), and each allocation bitwise equal to the plain version's on
    the same problem: the two problems are rebuilt as `_dispatch_reeval`
    builds them (its operated rows, the tuned and the cell-best swept
    policies, ``dcfg``) and solved on the CPU, where `dispatch` runs the
    plain `dispatch_ref`."""
    from repro_torch.dispatch import build_problem, dispatch
    from repro_torch.tune import cell_best_rows

    d = res.dispatch
    n_cells = grid.n_markets * grid.n_systems
    if launches != 2:
        raise AssertionError(f"optimize launched dispatch_scan {launches} "
                             "times; the re-scoring dispatches twice")
    for k in ("tuned", "swept"):
        r = d[k]
        if r is None:
            raise AssertionError(f"re-scoring: the {k} set is infeasible: "
                                 f"{d['infeasible_' + k]}")
        if r.alloc_mw.shape != (n_cells, grid.n_hours) \
                or not np.all(np.isfinite(r.alloc_mw)) \
                or (r.n_shed_hours > 0) != shed:
            raise AssertionError(f"re-scoring: {k} allocation malformed")
    rows = torch.as_tensor(d["rows"], device=dev)
    best = torch.as_tensor(cell_best_rows(grid, res.cpc_swept), device=dev)
    for k, pol, take in (("tuned", res.params, rows),
                         ("swept", grid, best[rows])):
        problem = build_problem(
            grid.prices[grid.market_idx[rows]], pol.p_on[take],
            pol.p_off[take], pol.off_level[take], grid.power[rows], dcfg,
            fixed=grid.fixed[rows], device=dev)
        got, plain = d[k], dispatch(problem, device="cpu")
        diff = float(np.abs(got.alloc_mw - plain.alloc_mw).max())
        print(f"[kernel] dispatch_scan re-scoring, {k} "
              f"{problem.avail_mw.shape[0]} x {problem.avail_mw.shape[1]}"
              f"{', relief' if shed else ''}: max |kernel - plain| "
              f"{diff:.3g}, n_migrations {got.n_migrations} / "
              f"{plain.n_migrations}, shed hours {got.n_shed_hours} / "
              f"{plain.n_shed_hours}")
        if not np.array_equal(got.alloc_mw, plain.alloc_mw) \
                or got.n_migrations != plain.n_migrations \
                or got.n_shed_hours != plain.n_shed_hours \
                or got.cpc != plain.cpc:
            raise AssertionError(f"re-scoring: the {k} dispatch differs "
                                 "from its plain version")
    print(f"[tune] dispatch re-scoring over {n_cells} cells x "
          f"{grid.n_hours} h ({'relief, ' if shed else ''}launches "
          f"{launches}): cpc tuned {d['cpc_tuned']:.4f}, swept "
          f"{d['cpc_swept']:.4f}, chosen {d['chosen']}; moves "
          f"{d['tuned'].n_migrations} / {d['swept'].n_migrations}; shed "
          f"hours {d['tuned'].n_shed_hours} / {d['swept'].n_shed_hours}")


def phase_dispatch_path(dev) -> dict:
    """The dispatch path at full width through its entry points, with the
    launch counts set to 0 just before and read just after: the
    `fleet_dispatch` example (8 sites x 8760 h, six dispatches), then
    `summarize(dispatch_cfg=)` over the dispatch benchmark's 64 sites x
    8760 h; the 64-site result is checked for feasibility and held
    against the same call on the CPU."""
    from repro_torch.dispatch import DispatchConfig
    from repro_torch.examples import fleet_dispatch
    from repro_torch.fleet import backtest, summarize

    grid, problem = _dispatch_fleet(64, dev)
    counters = _zero_counters()
    print("[dispatch] repro_torch.examples.fleet_dispatch on the card:")
    t0 = time.perf_counter()
    fleet_dispatch.run(dev)
    torch.cuda.synchronize()
    n_example = counters["dispatch_scan"].launches
    print(f"[dispatch] example: {time.perf_counter() - t0:.2f} s, "
          f"dispatch_scan launches {n_example}")
    if n_example != len(fleet_dispatch.SWEEP) + 2:
        raise AssertionError("the example dispatches once per summarize")
    cfg = DispatchConfig(**BENCH_DISPATCH)
    t0 = time.perf_counter()
    summ = summarize(grid, backtest(grid, device=dev), dispatch_cfg=cfg)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"[dispatch] summarize over {grid.n_markets} sites x "
          f"{grid.n_hours} h: {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}")
    if launches["dispatch_scan"] != n_example + 1:
        raise AssertionError("summarize(dispatch_cfg=) launched "
                             "dispatch_scan other than once")
    d = summ.dispatch
    demand = np.asarray(problem.demand_mw, np.float64)
    if d.alloc_mw.shape != (grid.n_markets, grid.n_hours) \
            or not np.all(np.isfinite(d.alloc_mw)) \
            or d.alloc_mw.min() < 0.0 \
            or np.any(d.alloc_mw > problem.avail_mw + 1e-5):
        raise AssertionError("dispatch: allocation outside [0, avail]")
    np.testing.assert_allclose(d.alloc_mw.sum(axis=0), demand, rtol=1e-5)
    plain = summarize(grid.to("cpu"), backtest(grid, device="cpu"),
                      dispatch_cfg=cfg).dispatch
    if not np.array_equal(d.alloc_mw, plain.alloc_mw) or d.cpc != plain.cpc:
        raise AssertionError("summarize(dispatch_cfg=): card and CPU differ")
    print(f"[dispatch] 64 sites: demand met every hour; cpc {d.cpc:.4f}, "
          f"energy {d.energy_cost:.1f}, moves {d.n_migrations}, migration "
          f"{d.migration_mw:.2f} MW, capacity slack "
          f"{d.slack_capacity_mw:.3f} MW; card == CPU bit for bit")
    return {"launches": launches["dispatch_scan"], "problem": problem}


def phase_checkpoint(dev, grid) -> None:
    """`tune_loop_checkpointed` on the card: an uninterrupted run, and a
    run whose checkpoints after stage 2 are deleted and which is then
    resumed; the two must agree bit for bit."""
    from repro_torch.tune import (TuneConfig, init_from_grid,
                                  problem_from_grid, tune_loop_checkpointed)

    cfg = TuneConfig(steps=40)
    problem = problem_from_grid(grid)
    raw0 = init_from_grid(grid)
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        ra, ha, ca = tune_loop_checkpointed(raw0, problem, cfg=cfg,
                                            directory=root / "a", keep=8)
        tune_loop_checkpointed(raw0, problem, cfg=cfg,
                               directory=root / "b", keep=8)
        for step_dir in sorted((root / "b").glob("step_*"))[2:]:
            shutil.rmtree(step_dir)
        rb, hb, cb = tune_loop_checkpointed(raw0, problem, cfg=cfg,
                                            directory=root / "b", keep=8)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for fa, fb in zip(ra, rb):
        if not torch.equal(fa, fb):
            raise AssertionError("checkpoint resume: raw params differ")
    if not torch.equal(ca, cb):
        raise AssertionError("checkpoint resume: cpc differs")
    for k in ha:
        if not np.array_equal(ha[k], hb[k]):
            raise AssertionError(f"checkpoint resume: history {k} differs")
    print(f"[ckpt] tune_loop_checkpointed {grid.n_rows} rows x "
          f"{grid.n_hours} h x {cfg.steps} steps: stopped after stage 2 "
          f"and resumed == uninterrupted, bit for bit")


def _soft_bound(b: int, t: int, block_t: int, backward: bool,
                with_dp: bool) -> tuple[float, str]:
    """Least time for the function on an H100 SXM: each input read once,
    each output written once, against 3.35 TB/s; ~20 (forward) or ~45
    (backward) float32 operations per row-hour against 67 TFLOP/s."""
    nb = -(-t // block_t)
    if backward:
        nbytes = 4 * b * t * (3 if with_dp else 2) + 4 * b * nb \
            + 4 * 2 * b + 4 * 3 * b + 4
        ops = 45 * b * t
    else:
        nbytes = 4 * b * t * 2 + 4 * b * nb + 4 * 2 * b + 4
        ops = 20 * b * t
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def phase_soft_times(dev, flush) -> dict:
    """Each soft-scan kernel (device only, L2 flushed) beside its bound
    and its plain version, at the tuner's 256 x 2190 and the backtest's
    1024 x 8760; the backward both as the tuner runs it (no d_p) and with
    d_p."""
    from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,
                                                   soft_scan_fwd)

    out = {}
    for b, t in ((256, 2190), (1024, 8760)):
        p, p_on, p_off, itau, g = _soft_inputs(b, t, 300, dev)
        _, carr = soft_scan_fwd(p, p_on, p_off, itau)
        rows = {}
        for label, fn, plain, bound in (
                ("fwd", lambda: soft_scan_fwd(p, p_on, p_off, itau),
                 lambda: soft_scan_fwd(p, p_on, p_off, itau,
                                       use_kernel=False),
                 _soft_bound(b, t, 256, False, False)),
                ("bwd", lambda: soft_scan_bwd(p, p_on, p_off, itau, carr, g,
                                              want_dp=False),
                 lambda: soft_scan_bwd(p, p_on, p_off, itau, carr, g,
                                       want_dp=False, use_kernel=False),
                 _soft_bound(b, t, 256, True, False)),
                ("bwd+d_p", lambda: soft_scan_bwd(p, p_on, p_off, itau,
                                                  carr, g),
                 None, _soft_bound(b, t, 256, True, True))):
            ms = _cuda_ms(fn, runs=20, flush=flush, device_only=True)
            hot = _cuda_ms(fn, runs=20, device_only=True)
            plain_ms = _cuda_ms(plain, runs=3) if plain else None
            rows[label] = {"ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound[0], "bound_by": bound[1]}
            print(f"[time] soft_scan {label} {b}x{t}: kernel {ms:.4f} ms "
                  f"(L2 flushed; {hot:.4f} ms L2-hot), plain "
                  + (f"{plain_ms:.2f} ms" if plain else "—")
                  + f", bound {bound[0]:.4f} ms ({bound[1]}), "
                  f"{bound[0] / ms:.1%} of bound")
        out[(b, t)] = rows
    return out


def phase_tune_times(dev, grid, steps: int = 200) -> None:
    """`tune_loop` at 256 x 2190 x 200 in row-steps/s: the hand-written
    VJP (fused) against autograd through the doubling scan (native), in
    turns within this one call; and the device's busy share over a
    profiled 20-step loop."""
    from repro_torch.tune import (TuneConfig, init_from_grid,
                                  problem_from_grid, tune_loop)

    problem = problem_from_grid(grid)
    raw0 = init_from_grid(grid)
    cfgs = {"fused": TuneConfig(steps=steps),
            "native": TuneConfig(steps=steps, fused=False)}
    times = {k: [] for k in cfgs}
    for k in ("fused", "native", "native", "fused"):
        times[k].append(_cuda_ms(lambda: tune_loop(raw0, problem,
                                                   cfg=cfgs[k]), runs=1))
    torch.cuda.reset_peak_memory_stats()
    for k in cfgs:
        torch.cuda.reset_peak_memory_stats()
        tune_loop(raw0, problem, cfg=cfgs[k])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        ms = statistics.median(times[k])
        print(f"[time] tune_loop {k} {grid.n_rows} rows x {grid.n_hours} h "
              f"x {steps} steps: {ms:.1f} ms (runs "
              f"{', '.join(f'{x:.1f}' for x in times[k])}), "
              f"{grid.n_rows * steps / (ms / 1e3):.4g} row-steps/s, peak "
              f"memory {peak:.1f} MiB")
    _profile(lambda: tune_loop(raw0, problem, cfg=TuneConfig(steps=20)),
             "tune_loop 20 steps", runs=1)


def phase_times(dev, main: dict) -> tuple[dict, torch.Tensor]:
    from repro_torch.energy.markets import generate_markets
    from repro_torch.fleet import backtest
    from repro_torch.kernels.fleet_scan import fleet_scan

    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32,
                        device=dev)          # 128 MB > the 50 MB L2
    args = main["scan_args"]
    b, t = args[0].shape
    ms = _cuda_ms(lambda: fleet_scan(*args, use_kernel=True), runs=20,
                  flush=flush, device_only=True)
    hot_ms = _cuda_ms(lambda: fleet_scan(*args, use_kernel=True), runs=20,
                      device_only=True)
    plain_ms = _cuda_ms(lambda: fleet_scan(*args, use_kernel=False))
    bytes_moved = b * t * 4 + 4 * b * 4 + 4 * b * 4
    ops = b * t * 10          # compares, selects and adds per row-hour
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= \
        ops / FP32_OPS_PER_S else "operations"
    print(f"[time] fleet_scan {b}x{t}: kernel {ms:.4f} ms (L2 flushed; "
          f"{hot_ms:.4f} ms with the block in L2), "
          f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({bytes_moved / 1e6:.1f} MB at 3.35 TB/s), "
          f"{bound_ms / ms:.1%} of bound")

    grid = main["grid"]
    e2e_ms = _cuda_ms(lambda: backtest(grid, device=dev))
    print(f"[time] backtest {grid.n_rows} rows x {grid.n_hours} h: "
          f"{e2e_ms:.3f} ms, {grid.n_rows / (e2e_ms / 1e3):.4g} rows/s")
    gen_ms = _cuda_ms(lambda: generate_markets(main["markets"], device=dev),
                      runs=5)
    print(f"[time] market generation (setup) {len(main['markets'])} x "
          f"{grid.n_hours} h: {gen_ms:.1f} ms")

    markets, big = _bench_grid(64, 16, dev)
    big_ms = _cuda_ms(lambda: backtest(big, device=dev))
    p_big = big.prices[big.market_idx].contiguous()
    big_args = (p_big, big.p_on, big.p_off, big.off_level, big.idle_frac)
    big_kernel_ms = _cuda_ms(lambda: fleet_scan(*big_args), flush=flush,
                             device_only=True)
    print(f"[time] backtest {big.n_rows} rows x {big.n_hours} h "
          f"({p_big.numel() * 4 / 1e6:.0f} MB gathered): {big_ms:.3f} ms, "
          f"{big.n_rows / (big_ms / 1e3):.4g} rows/s; kernel "
          f"{big_kernel_ms:.4f} ms, bound "
          f"{p_big.numel() * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms")
    gen64_ms = _cuda_ms(lambda: generate_markets(markets, device=dev),
                        runs=5)
    print(f"[time] market generation (setup) {len(markets)} x "
          f"{big.n_hours} h: {gen64_ms:.1f} ms")

    _profile(lambda: backtest(grid, device=dev),
             f"backtest {grid.n_rows} rows")
    return {
        "name": "fleet_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_scan.cu",
        "replaces": "src/repro/kernels/fleet_scan.py:40",
        "launches": main["launches"]["fleet_scan"],
        "max_abs_err": main["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }, flush


def _f64_add_ns(dev) -> float:
    """Latency of one dependent float64 addition on the card, in ns: the
    difference of two chains (1.1e6 and 1e5 additions) in one thread,
    timed by CUDA events."""
    import ctypes

    fn = ctypes.CDLL(str(PROBE_DIR / "libf64_add_chain.so")).f64_add_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.zeros(1, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chain(n):
        if fn(buf.data_ptr(), n, stream) != 0:
            raise RuntimeError("f64 add chain launch failed")

    lo, hi = 100_000, 1_100_000
    ms = {n: _cuda_ms(lambda: chain(n), runs=5) for n in (lo, hi)}
    return (ms[hi] - ms[lo]) * 1e6 / (hi - lo)


def _dispatch_bound(s: int, t: int) -> tuple[float, str]:
    """Least time for the function on an H100 SXM: read avail [S, T] f32,
    rank [T, 3S] i32 and demand [T], write alloc [S, T], against
    3.35 TB/s; ~20 float32 operations per site-hour against
    67 TFLOP/s."""
    tb = (20 * s * t + 4 * t) / HBM_BYTES_PER_S
    to = 20 * s * t / FP32_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def _host_ms(fn, runs: int) -> float:
    """Median host-clock time of ``fn()`` (which ends in a synchronise)
    over ``runs`` runs."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_dispatch_times(dev, flush, problem) -> dict:
    """The dispatch kernel (device only, L2 flushed) at S x 8760 for S in
    1, 8, 64 and 512, beside its bytes bound and the serial floor of its
    design (T x 3S dependent float64 additions); the plain version (on the
    CPU) at 8 and 64 sites; and one whole 64-site `dispatch` call split
    into the host segment sort, the kernel and `summarize_alloc`."""
    from repro_torch.dispatch import dispatch, segment_rank, summarize_alloc
    from repro_torch.kernels.dispatch_scan import dispatch_scan

    add_ns = _f64_add_ns(dev)
    print(f"[time] dependent float64 addition on the card: {add_ns:.3f} ns")
    out = {}
    for s in (1, 8, 64, 512):
        if s == 64:
            prob = problem
        else:
            prob = _random_dispatch(s, 8760, 5.0, 4, 600 + s)
        args = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for a in (prob.avail_mw, prob.rank, prob.demand_mw)]
        t = prob.avail_mw.shape[1]

        def kernel():
            return dispatch_scan(*args, min_dwell=prob.min_dwell_h)

        ms = _cuda_ms(kernel, runs=5, flush=flush, device_only=True)
        bound, by = _dispatch_bound(s, t)
        serial = t * 3 * s * add_ns * 1e-6
        rec = {"ms": ms, "bound_ms": bound, "bound_by": by,
               "serial_ms": serial, "plain_ms": None}
        if s in (8, 64):
            cpu_args = [a.cpu() for a in args]
            rec["plain_ms"] = _host_ms(
                lambda: dispatch_scan(*cpu_args, min_dwell=prob.min_dwell_h),
                runs=2)
        out[s] = rec
        print(f"[time] dispatch_scan {s} x {t}: kernel {ms:.4f} ms "
              f"({ms * 1e6 / t:.1f} ns per hour), plain "
              + (f"{rec['plain_ms']:.1f} ms" if rec["plain_ms"] else "—")
              + f", bound {bound:.4f} ms ({by}), serial floor of the design "
              f"{serial:.4f} ms (T x 3S x {add_ns:.3f} ns), {bound / ms:.2%} "
              f"of the bytes bound, {serial / ms:.1%} of the serial floor")

    prices = problem.prices
    rank_ms = _host_ms(lambda: segment_rank(prices, problem.migrate_cost),
                       runs=3)
    whole = problem._replace(order=None, rank=None)
    total_ms = _host_ms(lambda: dispatch(whole, device=dev), runs=3)
    alloc = dispatch(problem, device=dev).alloc_mw
    acc_ms = _host_ms(lambda: summarize_alloc(problem, alloc), runs=3)
    print(f"[time] dispatch 64 x {problem.avail_mw.shape[1]} (host clock): "
          f"whole call {total_ms:.2f} ms = segment_rank {rank_ms:.2f} ms + "
          f"kernel {out[64]['ms']:.3f} ms + summarize_alloc {acc_ms:.2f} ms "
          f"+ the rest (copies, checks) "
          f"{total_ms - rank_ms - out[64]['ms'] - acc_ms:.2f} ms")
    _profile(lambda: dispatch(problem, device=dev), "dispatch 64 sites",
             runs=3)
    return out


def _profile(fn, label: str, runs: int = 10) -> None:
    """Device time by kernel and the card's busy share over ``runs``
    back-to-back calls of ``fn``, from `torch.profiler` (CUPTI). The
    profiler slows the host, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's own row repeats its kernels' time
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[2] for r in rows)
    if busy_us == 0:
        print("[profile] the profiler recorded no device time: not measured")
        return
    print(f"[profile] {label} x {runs}: wall {wall_us / runs:.1f} us/run "
          f"under the profiler, device busy {busy_us / runs:.1f} us/run "
          f"({busy_us / wall_us:.1%})")
    for key, count, dev_us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"[profile]   {dev_us / runs:9.2f} us/run  "
              f"{count / runs:6.1f}x  {key[:70]}")


def _soft_records(errs: dict, times: dict, launches: dict) -> list[dict]:
    """The soft-scan kernels' entries of the ``kernels`` line, at the
    tuner's shape (256 x 2190; the backward as the tuner runs it, without
    d_p)."""
    e, t = errs[(256, 2190)], times[(256, 2190)]
    src = "src/repro_torch/kernels/csrc/soft_scan.cu"
    recs = []
    for name, line, key, err in (
            ("soft_scan_fwd", 185, "fwd", max(e["s"][0], e["carries"][0])),
            ("soft_scan_bwd", 216, "bwd",
             max(e["d_p_on"][0], e["d_p_off"][0], e["d_tau"][0]))):
        recs.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/soft_scan_vjp.py:{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": t[key]["ms"], "plain_ms": t[key]["plain_ms"],
            "bound_ms": t[key]["bound_ms"], "bound_by": t[key]["bound_by"],
            "library_ms": None})
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on "
              "a GPU", file=sys.stderr)
        return 1
    _import_port()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_device()
    phase_build()
    phase_kernel_vs_plain(dev)
    soft_errs = phase_soft_vs_plain(dev)
    dispatch_err = phase_dispatch_vs_plain(dev)
    main_run = phase_main_path(dev)
    tune = phase_tuner(dev)
    phase_checkpoint(dev, tune["grid"])
    disp = phase_dispatch_path(dev)
    fleet_rec, flush = phase_times(dev, main_run)
    soft_times = phase_soft_times(dev, flush)
    phase_tune_times(dev, tune["grid"])
    disp_times = phase_dispatch_times(dev, flush, disp["problem"])[64]
    kernels = [fleet_rec] + _soft_records(soft_errs, soft_times,
                                          tune["launches"]) + [{
        "name": "dispatch_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dispatch_scan.cu",
        "replaces": "src/repro/kernels/dispatch_scan.py:50",
        "launches": disp["launches"], "max_abs_err": dispatch_err,
        "ms": disp_times["ms"], "plain_ms": disp_times["plain_ms"],
        "bound_ms": disp_times["bound_ms"],
        "bound_by": disp_times["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
