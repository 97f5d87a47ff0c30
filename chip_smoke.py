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
     200 annealed Adam steps), then the `tune_policies` demo;
  6. `tune_loop_checkpointed` stopped after stage 2 and resumed, against
     an uninterrupted run, bit for bit;
  7. times (median of CUDA-event runs after warm-up): each kernel, its
     plain version and its bound, the backtest at 1024 and 8192 rows,
     market generation, and the tuner loop's row-steps/s (hand-written
     VJP against autograd through the doubling scan);
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


KERNEL_SOURCES = ("fleet_scan", "soft_scan")


def phase_build() -> None:
    from repro_torch.kernels import build

    def one(name):
        t0 = time.perf_counter()
        return name, build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(one, KERNEL_SOURCES))
    for name, log, secs in results:
        print(f"[build] {name}.cu: {secs:.2f} s")
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"[build]   {line.strip()}")
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
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,
                                                   soft_scan_fwd)
    return {"fleet_scan": fleet_scan, "soft_scan_fwd": soft_scan_fwd,
            "soft_scan_bwd": soft_scan_bwd}


def phase_tuner(dev) -> dict:
    """The tuner at full width through `optimize`, with every kernel's
    launch count set to 0 just before and read just after; then the
    `tune_policies` demo (48 rows x 4380 h, 300 steps, 8 resamples)."""
    from repro_torch.examples import tune_policies
    from repro_torch.tune import TuneConfig, cell_best_rows, optimize

    grid = _tune_grid(dev)
    cfg = TuneConfig(steps=200)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
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

    print("[tune] repro_torch.examples.tune_policies (default demo) on "
          "the card:")
    t0 = time.perf_counter()
    rc = tune_policies.main(["--device", str(dev)])
    print(f"[tune] demo exit {rc}, {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError("tune_policies: guarantee broken")
    return {"grid": grid, "launches": launches}


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
    main_run = phase_main_path(dev)
    tune = phase_tuner(dev)
    phase_checkpoint(dev, tune["grid"])
    fleet_rec, flush = phase_times(dev, main_run)
    soft_times = phase_soft_times(dev, flush)
    phase_tune_times(dev, tune["grid"])
    kernels = [fleet_rec] + _soft_records(soft_errs, soft_times,
                                          tune["launches"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
