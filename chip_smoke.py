#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel of the main path from `src/` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card;
  4. the main path at full size: the Lichtenberg case study, then the
     fleet backtest and summary of the repo's benchmark grid (16 German
     market draws x 8 systems x 8 policies = 1024 rows x 8760 h), with
     the kernels' launch counts read around that run;
  5. times (median of CUDA-event runs after warm-up): the kernel, its
     plain version and its bound, the end-to-end backtest at 1024 and
     8192 rows, and market generation;
then one JSON line describing every ported kernel and, last, one JSON
line naming the device. Without CUDA it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    log = build.build("fleet_scan")
    print(f"[build] fleet_scan.cu: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    build.load("fleet_scan")


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


def phase_times(dev, main: dict) -> list[dict]:
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

    phase_profile(dev, grid)
    return [{
        "name": "fleet_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_scan.cu",
        "replaces": "src/repro/kernels/fleet_scan.py:40",
        "launches": main["launches"]["fleet_scan"],
        "max_abs_err": main["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]


def phase_profile(dev, grid, runs: int = 10) -> None:
    """Device time by kernel and the card's busy share over ``runs``
    back-to-back backtests, from `torch.profiler` (CUPTI). The profiler
    slows the host, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import backtest

    backtest(grid, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            backtest(grid, device=dev)
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
    print(f"[profile] backtest {grid.n_rows} rows x {runs}: wall "
          f"{wall_us / runs:.1f} us/run under the profiler, device busy "
          f"{busy_us / runs:.1f} us/run ({busy_us / wall_us:.1%})")
    for key, count, dev_us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"[profile]   {dev_us / runs:9.2f} us/run  {count // runs:3d}x"
              f"  {key[:70]}")


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
    main_run = phase_main_path(dev)
    kernels = phase_times(dev, main_run)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
