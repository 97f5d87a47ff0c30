#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from `src/` (one nvcc per source, all
     started together; sm_90a), printing ptxas' registers and spills, for
     the eight bf16 attention kernels (flash and decode at Dh 16-128)
     their registers, spills and HMMA instructions in the SASS (they must
     run on the tensor cores), and for the ten soft-dispatch kernels
     (forward and backward chain, with and without dwell locks, for blocks
     of up to 512 and 1024 threads; the backward's coefficient kernel)
     their registers and spills, and for the SSD scan's output kernels
     (and the bf16 chunk-state kernel) their registers, spills and HMMA
     instructions in the SASS (the tensor-core ones, for bf16 inputs, must
     have some);
  3. each kernel against its plain PyTorch version on the card (the
     fleet scan also bit for bit against its segmented mirror run on the
     card, and read through ``market_idx`` against its gathered form);
  4. the backtest path at full size: the Lichtenberg case study, then
     the fleet backtest and summary of the repo's benchmark grid (16
     German market draws x 8 systems x 8 policies = 1024 rows x 8760 h),
     whose scan reads the 16 markets through the grid's index;
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
  8. the soft-dispatch kernels (forward, fused forward, fused backward)
     against their plain versions at the reference's four soft cases, the
     tuner's 32 sites x 2190 h at tau 30 and 0.3, a case with zero-demand
     hours and groups of more than one warp (64, 45, 130 and 1024 sites:
     four bisection levels a round down to one);
  9. soft -> hard convergence at full width: the forward kernel at
     tau 1e-3 against `dispatch_scan` on the dispatch benchmark's 64 sites
     x 8760 h;
 10. the dispatch-aware tuner at full width: `optimize` on the tuner grid
     with `Coupling(dispatch=)` (the fused soft-dispatch kernels every
     step), twice at 25 steps for determinism, the reference's acceptance
     grid (dispatch-aware <= re-score-only), and `tune_policies
     --dispatch-soft`; then telemetry (`repro_torch.obs.capture`): the
     bench grid's backtest and summary (one `fleet_scan` launch a call),
     a 64 x 8760 `dispatch` and a 200-step `optimize` on the tuner grid,
     each bit for bit against a run with telemetry off, the drained
     ``fleet.hourly`` against a per-hour loop of `hard_hour_step` on the
     card, the dispatch totals rebuilt from the trace exactly, the
     report's ``--validate``, wall times on and off; then the live
     operator: `live_operator --smoke`'s sweep (24 controllers x 336 h)
     on the card against the CPU (the near-threshold row-hours printed),
     the full sweep (384 controllers x 2190 h) twice and under telemetry
     bit for bit, the hindsight sandwich on every row, its wall time,
     controller-hours/s, device kernels an hour and busy share under the
     profiler, the perfect forecast at the full horizon against
     `offline_cpc` on the kernel (rtol 1e-5, the repo's CPC gate; start
     counts exact), `live_fleet_dispatch` never re-solving over 8 sites x
     2190 h against `dispatch` bit for bit, and `live_operator --smoke`
     and ``--retune --smoke``; then the faults and workload slice: the
     three ledger kernels (`csrc/queue_scan.cu`) against their plain
     hour loops on the card (the hard one at `bench_workload`'s 256 x
     4096 x 8 draws within rtol 1e-5 and bit for bit on integer work at
     d 0-9 and B = 1, telemetry on == off; the soft pair at 256 x 2190
     within 1e-10 of plain autograd in float64 and, the tuner's form,
     float32 gradients within 1e-4 of scale; the hard float64 forward
     of the live replay at 32 x 96 bit for bit on integer work), their
     times, bounds and one-lane serial floors, ptxas' registers and
     spills (build phase);
     `faulted_backtest` and `workload_backtest` at 256 x 4096 (a
     zero-fault run and the coupled report equal to `backtest` bit for
     bit, a storm's starts card == CPU, telemetry on == off), and
     `chaos_fleet` and `workload_fleet` at full size (exit 0; the latter
     counts the ledger kernels' launches on the main path);
 11. the attention kernels (flash, decode) against their plain versions
     on the card and against SDPA, at the reference's cases, the serving
     shapes (qwen2.5-3b's and zamba2-1.2b's: 32 heads each its own KV
     group, Dh 64) and the tensor-core (bf16) kernels' head dims and heads
     per group (run with phase 8's kernel checks); the decode kernel's
     ticket counters back at 0;
 12. the serving path at full width: `ServingEngine` on qwen2.5-3b (bf16,
     random parameters drawn from a seed on the CPU, copied to the card),
     8 slots x 2048, the price gate on and crossing a price spike (it
     must close and reopen), 16 requests of 128-1024 prompt tokens x 32
     new tokens, until all complete; one request teacher-forced through
     the kernels and through the plain attention;
 13. the SSD scan kernel against its plain version on the card (the
     reference's cases, mamba2-1.3b's serving shapes at 1024 and 1000
     positions in bf16 and float32, with h0 and without, several heads a
     group with ragged head sets, one head a group, rows that take no
     16-byte copies, zamba2-1.2b's N 64, a scan in two parts chained
     through h0); the Mamba2 serving path at full width:
     the same engine, gate and requests on mamba2-1.3b (48 layers, bf16),
     prompts of 2 to 1024 tokens, 48 SSD launches per prefill, no plain
     SSD and no attention; a 1000-token request teacher-forced through
     the kernel and through the plain scan; prefill of 2 and of 300 tokens
     then decode against the longer prefills; the hybrid serving path at
     full width: the same engine, gate and requests on zamba2-1.2b (38
     Mamba2 layers and 6 applications of one shared attention + MLP block,
     bf16), prompts of 1, 2, 3 and 1024 tokens and 12 of 128-1024, 38 SSD
     and 6 flash launches per prefill and 6 decode launches per step, no
     plain attention or SSD; a 1024-token request teacher-forced through
     the kernels and the plain versions; prefill of 2 and of 300 tokens
     then decode against the longer prefills; the `repro_torch.launch.
     serve` launcher at the reference's defaults and on reduced mamba2 and
     zamba2;
 14. times (median of CUDA-event runs after warm-up): each kernel, its
     plain version and its bound (the fleet scan through ``market_idx``
     and on the gathered block, and at the tuner's 256 x 2190), the
     backtest at 1024 and 8192 rows,
     market generation, the tuner loop's row-steps/s (hand-written VJP
     against autograd through the doubling scan), the dispatch kernel at
     1, 8, 64 and 512 sites with the positions its walk sums an hour and
     its design's serial floor, on the six instances phase 7's
     `fleet_dispatch` example gave it (the counted path's time), one
     whole dispatch call split into its parts, the soft-dispatch kernels at 32 x 2190 and
     64 x 8760 beside their bounds and the serial floors of their design
     and of the one-step design before it (the plain forward's run at
     64 x 8760 also holds phase 9's allocation), a dispatch-aware tuner
     step (dwell 4, as `optimize` runs it) against an uncoupled one, the
     attention kernels at the serving shapes (qwen2.5-3b's and
     zamba2-1.2b's) in turns with SDPA, and the SSD kernel at 1024 and
     2048 positions and at zamba2's N 64, each pass's device time (the
     tensor-core kernels must be among them), the work it issues, beside
     its plain version and bound;
 15. the training slice (after the serving phases): the flash and SSD
     kernels under autograd (`FlashAttention`, `SSDScan`: the kernel
     forward, the port's backward) against plain autograd through their
     plain versions on the card, at training shapes (one token to 1024,
     causal and windowed, an offset, GQA and MHA, Dh 64 and 128, float32
     and bf16; the SSD at 256-1024 positions, N 64 and 128, one head a
     group and a shared one, with h0 and without); one training step on a
     2-layer cut of qwen1.5-0.5b, mamba2-1.3b and zamba2-1.2b at full
     width, the kernel route against the plain route; qwen1.5-0.5b at full
     width trained by `Trainer` (batch 8 x 1024, 24 steps) under the
     energy-aware scheduler from a market hour chosen on the host so that
     a SHUTDOWN and a RESUME fall inside the run (the restored parameters
     held bit for bit against the saved ones; 48 flash launches and 24
     backward calls a step; step time, tokens/s, peak memory, the share of
     the bf16 peak, the busy share under the profiler, the checkpoint's
     times and the meter's summary); pause and resume bit for bit on a
     2-layer cut; `repro_torch.launch.train --full-config`;
each path's kernel launch counts are set to 0 just before it and read
just after. Then one JSON line describing every ported kernel (a counted
launch is one wrapper call; ``device_launches`` counts, in the same run,
the kernels those calls put on the card; flash, decode and the SSD scan
add the zamba2 run's launches and zamba2-shape times under ``hybrid_``
keys; flash adds the full-width training run's launches under
``train_``, flash and the SSD scan their Functions' worst gradient error
as ``train_max_grad_err``; the fleet scan adds the live sweep's launches
and `dispatch_scan` the live-fleet check's under ``live_``), the
script's total time, and, last, one JSON line naming the device. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import gc
import json
import re
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
T_START = time.perf_counter()


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
    return statistics.median(_cuda_times(fn, runs, flush, device_only))


def _cuda_times(fn, runs: int = TIMED_RUNS,
                flush: torch.Tensor | None = None,
                device_only: bool = False) -> list[float]:
    """`_cuda_ms`'s ``runs`` times of ``fn()`` in ms, each one."""
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
    return times


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


KERNEL_SOURCES = ("fleet_scan", "soft_scan", "dispatch_scan",
                  "soft_dispatch", "attention", "ssd_scan", "queue_scan")

# Probes of the card, not kernels of the port. f64_add_chain: one thread
# adds 1.0 to x n times, each addition waiting on the last, so a chain
# takes n times the latency of a dependent float64 addition (the step of
# dispatch_scan's serial prefix walk). warp_sum_chain: one warp runs n
# float64 butterfly sums (five dependent shuffle + add steps each, the
# reduction of the soft-dispatch kernels), each waiting on the last.
# barrier_chain: a block runs n block barriers back to back (the barrier
# after each round of the soft-dispatch forward's bisection).
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
__global__ void warp_sum_chain_kernel(double* out, int n) {
  double x = out[threadIdx.x] * 1e-9;
  for (int i = 0; i < n; ++i) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    x *= 1e-30;
  }
  out[threadIdx.x] = x;
}
extern "C" int warp_sum_chain(double* out, int n, void* stream) {
  warp_sum_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
__global__ void barrier_chain_kernel(double* out, int n) {
  for (int i = 0; i < n; ++i) __syncthreads();
  if (threadIdx.x == 0) out[0] += n;
}
extern "C" int barrier_chain(double* out, int n, int threads,
                             void* stream) {
  barrier_chain_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(out, n);
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
        if name == "attention":
            _report_tensor_core_kernels(log, build.library_path(name))
        if name == "ssd_scan":
            _report_ssd_kernels(log, build.library_path(name))
        if name == "soft_dispatch":
            _report_soft_dispatch_kernels(log)
        if name == "queue_scan":
            _report_ledger_kernels(log)


def _ptxas_records(log: str, pattern: re.Pattern) -> dict:
    """Registers and spills (ptxas) of the kernels whose mangled names
    ``pattern`` matches, keyed by the match's groups."""
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'|Function properties for "
                      r"(\S+)", line)
        if m:
            name = m.group(1) or m.group(2)
            continue
        k = pattern.search(name or "")
        if not k:
            continue
        rec = info.setdefault(k.groups(), {})
        if m := re.search(r"(\d+) bytes stack frame", line):
            rec["stack"] = int(m.group(1))
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            rec["spill"] = (int(m.group(1)), int(m.group(2)))
        if m := re.search(r"Used (\d+) registers", line):
            rec["registers"] = int(m.group(1))
    return info


SD_KERNEL = re.compile(r"soft_(fwd|bwd_coef|bwd_chain)_kernelILb([01])E"
                       r"(?:Li(\d+)E)?")


def _report_soft_dispatch_kernels(log: str) -> None:
    """Registers and spills (ptxas) of the soft-dispatch kernels: the
    forward and the backward's chain, with and without dwell locks, each
    built for blocks of up to 512 and of 1024 threads, and the backward's
    coefficient kernel with and without locks. Fails if one is missing."""
    info = _ptxas_records(log, SD_KERNEL)
    want = [(kind, locks, bound) for kind in ("fwd", "bwd_chain")
            for locks in "01" for bound in ("512", "1024")]
    want += [("bwd_coef", locks, None) for locks in "01"]
    for key in want:
        rec = info.get(key, {})
        if "registers" not in rec:
            raise AssertionError(f"build: no ptxas record of soft_{key[0]}"
                                 f"_kernel {key[1:]}")
        st, ld = rec.get("spill", (0, 0))
        print(f"[build] soft_{key[0]}_kernel, "
              f"{'dwell locks' if key[1] == '1' else 'no locks'}"
              + (f", blocks of up to {key[2]} threads" if key[2] else "")
              + f": {rec['registers']} registers, spill stores {st} B, "
              f"spill loads {ld} B")


def _sass_tensor_core_counts(lib: Path, pattern: re.Pattern) -> dict | None:
    """Tensor-core instructions (HMMA for mma.sync, HGMMA for wgmma) in the
    SASS of each kernel of ``lib`` whose name ``pattern`` matches, keyed by
    the match's groups (cuobjdump, from nvcc's toolkit); None without
    cuobjdump."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return None
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            k = pattern.search(m.group(1))
            name = k.groups() if k else None
            if name:
                counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def _report_mma(label: str, rec: dict, n) -> None:
    st, ld = rec.get("spill", (0, 0))
    print(f"[build] {label}: {rec['registers']} registers, spill stores "
          f"{st} B, spill loads {ld} B, "
          + (f"{n} HMMA/HGMMA instructions in its SASS" if n is not None
             else "SASS not read (no cuobjdump)"))


# the bf16 instantiations of the attention kernels (the tensor-core designs)
MMA_KERNEL = re.compile(r"(flash|decode)_mma_kernelILi(\d+)E")


def _report_tensor_core_kernels(log: str, lib: Path) -> None:
    """Registers and spills (ptxas) and the tensor-core instructions in the
    SASS (cuobjdump, from nvcc's toolkit: HMMA for mma.sync, HGMMA for
    wgmma) of the eight bf16 attention kernels, flash and decode at Dh 16,
    32, 64 and 128. Fails if one is missing or has no tensor-core
    instruction."""
    info = _ptxas_records(log, MMA_KERNEL)
    hmma = _sass_tensor_core_counts(lib, MMA_KERNEL)
    for kind in ("flash", "decode"):
        for dh in (16, 32, 64, 128):
            rec = info.get((kind, str(dh)), {})
            if "registers" not in rec:
                raise AssertionError(f"build: no ptxas record of the bf16 "
                                     f"{kind} kernel at Dh {dh}")
            n = None if hmma is None else hmma.get((kind, str(dh)), 0)
            if hmma is not None and not n:
                raise AssertionError(f"build: the bf16 {kind} kernel at Dh "
                                     f"{dh} has no tensor-core instruction "
                                     "(HMMA, HGMMA) in its SASS")
            _report_mma(f"bf16 {kind}_mma_kernel Dh {dh}", rec, n)


# the SSD scan's chunk-state and output kernels: the pass, tensor-core or
# not, x's type (the CUDA-core output kernel's: f float32, 13__nv_bfloat16
# bf16, for rows the tensor-core kernels do not take) and the heads a
# block (output kernels)
SSD_KERNEL = re.compile(r"ssd_chunk_(out|state)(_mma|)_kernel"
                        r"(?:I(f|13__nv_bfloat16|)(?:Li(\d+)E)?)?")


def _report_ssd_kernels(log: str, lib: Path) -> None:
    """Registers and spills of the SSD scan's chunk-state and output
    kernels (on the tensor cores for bf16, and on the CUDA cores in
    float32 for float32 and for bf16 rows the first do not take) and the
    tensor-core instructions in their SASS. Fails if one is missing or a
    tensor-core one (every product on mma.sync) has no tensor-core
    instruction."""
    info = _ptxas_records(log, SSD_KERNEL)
    hmma = _sass_tensor_core_counts(lib, SSD_KERNEL)
    for key, label in (
            (("state", "_mma", None, None),
             "bf16 ssd_chunk_state_mma_kernel"),
            (("out", "_mma", "", str(SSD_HEADS)),
             "bf16 ssd_chunk_out_mma_kernel"),
            (("out", "", "13__nv_bfloat16", str(SSD_HEADS)),
             "bf16 ssd_chunk_out_kernel"),
            (("out", "", "f", str(SSD_HEADS)),
             "float32 ssd_chunk_out_kernel")):
        rec = info.get(key, {})
        if "registers" not in rec:
            raise AssertionError(f"build: no ptxas record of the {label}")
        n = None if hmma is None else hmma.get(key, 0)
        if key[1] == "_mma" and hmma is not None and not n:
            raise AssertionError(f"build: the {label} has no tensor-core "
                                 "instruction (HMMA) in its SASS")
        _report_mma(label + (f", {SSD_HEADS} heads a block"
                             if key[0] == "out" else ""), rec, n)


# the chip check's shapes of phase 3, and two windows of 256 x 36 hours
FLEET_SHAPES = [(1, 64), (5, 333), (130, 1000), (1024, 8760), (64, 4097),
                (3, 9300)]


def _fleet_equal(lab: str, pairs) -> None:
    """Fails unless each (name, x, y) of ``pairs`` is equal bit for bit."""
    for name, x, y in pairs:
        for field, a, b in zip(x._fields, x, y):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{lab}: {field} differs from the {name} by up to "
                    f"{float((a.double() - b.double()).abs().max()):.3g}")


def phase_kernel_vs_plain(dev) -> None:
    """n_starts equal to the plain float32 version; sums within rtol 2e-5
    of the plain version run in float64 on the same (float32) inputs,
    which follows the same trajectory without float32 accumulation error
    (at 8760 h the plain float32 running sum of a non-dyadic capacity
    level drifts by ~1e-4 relative, more than the kernel's sums: each
    thread adds its hours in float32, a tree adds the threads in float64).
    Every output equal bit for bit to the segmented mirror
    (`ref.fleet_scan_seg_ref`, the kernel's runs, max-scan, replays and
    tree in plain PyTorch) run on the card, to a second launch, and, read
    through ``market_idx`` from an [N, T] block (N = B / 8), to the same
    kernel on the gathered [B, T] block; one kernel on the card a call."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.ref import (FLEET_SCAN_THREADS, fleet_scan_ref,
                                         fleet_scan_seg, fleet_scan_seg_ref)

    lib = build.load("fleet_scan")
    lib.fleet_scan_threads.argtypes = []
    lib.fleet_scan_seg.argtypes = [ctypes.c_int]
    lib.fleet_scan_threads.restype = lib.fleet_scan_seg.restype = ctypes.c_int
    for t in (1, 64, 256, 257, 2190, 8760, 9216, 9217, 20000):
        layout = (lib.fleet_scan_threads(), lib.fleet_scan_seg(t))
        if layout != (FLEET_SCAN_THREADS, fleet_scan_seg(t)):
            raise AssertionError(f"fleet_scan: the kernel's layout {layout} "
                                 f"at T {t} is not its mirror's")
    for i, (b, t) in enumerate(FLEET_SHAPES):
        args = _scan_inputs(b, t, seed=100 + i, dev=dev)
        n0 = fleet_scan.device_launches
        got = fleet_scan(*args, use_kernel=True)
        if fleet_scan.device_launches - n0 != 1:
            raise AssertionError(f"fleet_scan {b}x{t}: a call put other "
                                 "than one kernel on the card")
        plain = fleet_scan(*args, use_kernel=False)
        exact = fleet_scan_ref(args[0].double(), *args[1:])
        mirror = fleet_scan_seg_ref(*args)
        again = fleet_scan(*args, use_kernel=True)
        n = max(1, b // 8)
        markets = _scan_inputs(n, t, seed=150 + i, dev=dev)[0]
        mi = torch.as_tensor(np.random.default_rng(160 + i).integers(
            0, n, b), device=dev)
        indexed = fleet_scan(markets, *args[1:], market_idx=mi,
                             use_kernel=True)
        gathered = fleet_scan(markets[mi].contiguous(), *args[1:],
                              use_kernel=True)
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
        lab = f"fleet_scan {b}x{t}"
        _fleet_equal(lab, [("segmented mirror on the card", got, mirror),
                           ("second launch", got, again),
                           (f"gathered form ({n} markets)", indexed,
                            gathered)])
        print(f"[kernel] {lab}: equal to the segmented mirror on the card "
              f"and to a second launch, bit for bit; read through "
              f"market_idx from {n} markets equal to the gathered form; "
              "one kernel a call")


# (B, T, block_t): the tuner's 256 x 2190 (one window of 256 x 9 hours)
# and the backtest's 1024 x 8760 (three of 256 x 12); rows that cross
# windows and end ragged, block_t 1, 48 and 100 (windows that start inside
# a block: the backward sweeps from its carry) and block_t >= T (one
# window; or, at 6000 h, two windows inside one block)
SOFT_SHAPES = [(1, 64, 64), (5, 333, 64), (130, 1000, 256),
               (256, 2190, 256), (64, 4097, 256), (1024, 8760, 256),
               (3, 5000, 100), (2, 8761, 48), (1, 31, 256), (4, 700, 1),
               (2, 6000, 8192)]
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
    |d_tau| beside its tolerance. Each kernel also equals, bit for bit,
    its segmented mirror (`ref.soft_scan_fwd_seg_ref` / `_bwd_seg_ref`,
    the kernel's windows, maps, scans and sums in plain PyTorch) run on the
    card, and a second launch equals the first; each call puts one kernel
    on the card."""
    from repro_torch.kernels.ref import (soft_scan_bwd_seg_ref,
                                         soft_scan_fwd_seg_ref)
    from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,
                                                   soft_scan_fwd)

    out = {}
    for i, (b, t, bt) in enumerate(SOFT_SHAPES):
        p, p_on, p_off, itau, g = _soft_inputs(b, t, 200 + i, dev)
        f64 = [x.double() for x in (p, p_on, p_off, itau)]
        n0 = (soft_scan_fwd.device_launches, soft_scan_bwd.device_launches)
        s, carr = soft_scan_fwd(p, p_on, p_off, itau, block_t=bt,
                                use_kernel=True)
        s32, c32 = soft_scan_fwd(p, p_on, p_off, itau, block_t=bt,
                                 use_kernel=False)
        s64, c64 = soft_scan_fwd(*f64, block_t=bt, use_kernel=False)
        got = soft_scan_bwd(p, p_on, p_off, itau, carr, g, block_t=bt,
                            use_kernel=True)
        if (soft_scan_fwd.device_launches - n0[0],
                soft_scan_bwd.device_launches - n0[1]) != (1, 1):
            raise AssertionError(f"soft_scan {b}x{t}/{bt}: a call put "
                                 "other than one kernel on the card")
        mirror = (*soft_scan_fwd_seg_ref(p, p_on, p_off, itau, bt),
                  *soft_scan_bwd_seg_ref(p, p_on, p_off, itau, carr, g, bt))
        again = (*soft_scan_fwd(p, p_on, p_off, itau, block_t=bt,
                                use_kernel=True),
                 *soft_scan_bwd(p, p_on, p_off, itau, carr, g, block_t=bt,
                                use_kernel=True))
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
        names = ("s", "carries", "d_p", "d_p_on", "d_p_off", "d_inv_tau")
        kernel = (s, carr, *got)
        for name, x, m, y in zip(names, kernel, mirror, again):
            if not torch.equal(x, m):
                raise AssertionError(
                    f"{lab} {name}: the kernel differs from its segmented "
                    f"mirror on the card by up to "
                    f"{float((x.double() - m.double()).abs().max()):.3g}")
            if not torch.equal(x, y):
                raise AssertionError(f"{lab} {name}: two launches differ")
        print(f"[kernel] {lab}: equal to the segmented mirror on the card "
              f"and to a second launch, bit for bit; one kernel a call")
        out[(b, t, bt)] = errs
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
    from repro_torch.kernels.ref import fleet_scan_ref, fleet_scan_seg_ref

    print("[main] Lichtenberg case study (Section IV-A) on the card:")
    report(lichtenberg(dev))

    # ---- counted run: the main path at full size through the entry points
    fleet_scan.launches = fleet_scan.device_launches = 0
    markets, grid = _bench_grid(16, 8, dev)
    rep = backtest(grid, device=dev)
    summ = summarize(grid, rep)
    torch.cuda.synchronize()
    launches = {"fleet_scan": fleet_scan.launches}
    device = {"fleet_scan": fleet_scan.device_launches}
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

    # the kernel on the main path's own inputs, as the backtest calls it
    # (the grid's markets read through its index), held as in phase 3
    scan_args = (grid.prices, grid.p_on, grid.p_off, grid.off_level,
                 grid.idle_frac)
    got = fleet_scan(*scan_args, market_idx=grid.market_idx,
                     use_kernel=True)
    p_rows = grid.prices[grid.market_idx].contiguous()
    exact = fleet_scan_ref(p_rows.double(), *scan_args[1:])
    plain = fleet_scan_ref(p_rows, *scan_args[1:])
    if not torch.equal(got.n_starts, plain.n_starts):
        raise AssertionError("fleet_scan on the grid: n_starts differ")
    for g, e in zip(got, exact):
        torch.testing.assert_close(g.double(), e, rtol=2e-5, atol=1e-3)
    _fleet_equal("fleet_scan on the grid", [
        ("gathered form", got, fleet_scan(p_rows, *scan_args[1:],
                                          use_kernel=True)),
        ("segmented mirror on the card", got,
         fleet_scan_seg_ref(p_rows, *scan_args[1:]))])
    max_abs = max(float((g.double() - e).abs().max())
                  for g, e in zip(got, exact))
    print(f"[main] fleet_scan on the grid's {tuple(grid.prices.shape)} "
          f"markets through its {grid.n_rows}-row index: max |err| vs "
          f"plain-f64 {max_abs:.3g}; equal bit for bit to the kernel on "
          f"the gathered {tuple(p_rows.shape)} block and to the segmented "
          "mirror on the card")
    return {"grid": grid, "launches": launches, "device_launches": device,
            "max_abs_err": max_abs,
            "markets": markets}


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
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dispatch_scan import dispatch_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.queue_scan import (soft_ledger_bwd,
                                                soft_ledger_fwd,
                                                workload_ledger_fwd)
    from repro_torch.kernels.soft_dispatch import (soft_dispatch_fused_bwd,
                                                   soft_dispatch_fused_fwd,
                                                   soft_dispatch_scan)
    from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,
                                                   soft_scan_fwd)
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"fleet_scan": fleet_scan, "soft_scan_fwd": soft_scan_fwd,
            "soft_scan_bwd": soft_scan_bwd, "dispatch_scan": dispatch_scan,
            "soft_dispatch": soft_dispatch_scan,
            "soft_dispatch_fused_fwd": soft_dispatch_fused_fwd,
            "soft_dispatch_fused_bwd": soft_dispatch_fused_bwd,
            "flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd_scan": ssd_scan,
            "workload_ledger_fwd": workload_ledger_fwd,
            "soft_ledger_fwd": soft_ledger_fwd,
            "soft_ledger_bwd": soft_ledger_bwd}


def _zero_counters() -> dict:
    counters = _counters()
    for fn in counters.values():
        fn.launches = fn.device_launches = 0
    return counters


def _device_launches(counters: dict) -> dict:
    """The kernels each wrapper's counted calls put on the card, read from
    the C side's count of the launches it issued."""
    return {k: fn.device_launches for k, fn in counters.items()}


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
    device = _device_launches(counters)
    print(f"[tune] optimize {grid.n_rows} rows x {grid.n_hours} h x "
          f"{cfg.steps} steps: {wall:.2f} s wall (first call); launches "
          f"{launches}")
    for k in ("soft_scan_fwd", "soft_scan_bwd"):
        if launches[k] < cfg.steps:
            raise AssertionError(f"the tuner launched {k} {launches[k]} "
                                 f"times in {cfg.steps} steps")
        if device[k] != launches[k]:
            raise AssertionError(f"{k}: {launches[k]} calls put {device[k]} "
                                 "kernels on the card, not one each")
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
    return {"grid": grid, "launches": launches, "device_launches": device,
            "res": res}


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
    against the same call on the CPU. The inputs `dispatch` hands the
    kernel in the example are kept (``example``) for phase 14 to time."""
    from repro_torch.dispatch import DispatchConfig, allocate
    from repro_torch.examples import fleet_dispatch
    from repro_torch.fleet import backtest, summarize

    grid, problem = _dispatch_fleet(64, dev)
    example, kernel_fn = [], allocate.dispatch_scan

    def keeping(avail, rank, demand, *, min_dwell=0):
        example.append(((avail, rank, demand), min_dwell))
        return kernel_fn(avail, rank, demand, min_dwell=min_dwell)

    counters = _zero_counters()
    print("[dispatch] repro_torch.examples.fleet_dispatch on the card:")
    t0 = time.perf_counter()
    allocate.dispatch_scan = keeping
    try:
        fleet_dispatch.run(dev)
    finally:
        allocate.dispatch_scan = kernel_fn
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
    device = _device_launches(counters)
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
    return {"launches": launches["dispatch_scan"], "device_launches": device,
            "problem": problem, "example": example}


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


# (S, T, migrate_cost, min_dwell, tau): the reference's SOFT_CASES
# (tests/test_soft_dispatch.py)
SOFT_DISPATCH_CASES = [(1, 64, 0.0, 0, 5.0), (5, 333, 5.0, 0, 2.0),
                       (8, 500, 5.0, 6, 0.5), (16, 700, 3.0, 3, 20.0)]
# tolerances of the soft-dispatch kernels against their plain versions:
# MW for the allocation, counts for the entering dwell, EUR/MWh for the
# level; gradients relative to the larger of their own scale and the
# cotangent's; d tau relative (see phase_soft_dispatch_vs_plain)
SD_TOL = {"alloc": 1e-5, "dwell_in": 1e-4, "lam": 1e-3, "grad": 1e-4}


def _soft_dispatch_case(s: int, t: int, mc: float, seed: int = 0,
                        zero_hours=()):
    """The reference's `_random_case` (normal prices, sites of 1-3 MW at
    20% or 100% availability, a flat demand at half the leanest hour) with
    its segment keys and order, and a positive cotangent g; CPU tensors."""
    from repro_torch.dispatch import segment_keys, segment_rank

    rng = np.random.default_rng(29 + seed)
    prices = rng.normal(80, 40, (s, t)).astype(np.float32)
    power = rng.uniform(1.0, 3.0, s).astype(np.float32)
    on = (rng.uniform(size=(s, t)) > 0.3).astype(np.float32)
    avail = power[:, None] * (0.2 + 0.8 * on)
    demand = np.full(t, 0.5 * float(avail.sum(axis=0).min()), np.float32)
    demand[list(zero_hours)] = 0.0
    keys = segment_keys(prices, mc).astype(np.float32)
    order = segment_rank(prices, mc)[0]
    g = rng.uniform(0.5, 1.5, (s, t)).astype(np.float32)
    return [torch.as_tensor(np.ascontiguousarray(x))
            for x in (avail, keys, order, demand, g)]


def _inv_taus(tau: float):
    """(1 / tau, 1 / (tau mw_scale)) as float32 [1] tensors, rounded as
    `soft_dispatch` rounds them (the reciprocal of the float32 tau)."""
    it = 1.0 / torch.tensor([tau], dtype=torch.float32)
    return it, it / torch.tensor(0.05)


def _level_error(cpu, plain_fwd, lam_k, it, itm, dwell) -> tuple:
    """The largest |kernel level - plain level| over the hours where the
    two differ by at most SD_TOL["lam"], and the count of the other hours,
    the gap hours. An hour may differ by more only where it is a gap hour
    by structure (`soft_level_in_gap` at the plain version's state: the
    fill flat at the demand between the two levels), and there the plain
    hour at the kernel's level must place the same allocation (within
    SD_TOL["alloc"]) as at its own. Any other hour off by more than
    SD_TOL["lam"] fails."""
    from repro_torch.kernels.ref import (soft_dispatch_hour_fixed,
                                         soft_level_in_gap)

    avail, keys, _, demand, _ = cpu
    p_alloc, p_dwin, p_lam = plain_fwd
    diff = (lam_k.double() - p_lam.double()).abs()
    gap = torch.nonzero(diff > SD_TOL["lam"]).flatten().tolist()
    for h in gap:
        prev = p_alloc[:, h - 1] if h > 0 else torch.zeros_like(avail[:, 0])
        if not soft_level_in_gap(prev, p_dwin[:, h], avail[:, h], keys[h],
                                 demand[h], p_lam[h], lam_k[h], it[0],
                                 min_dwell=dwell):
            raise AssertionError(
                f"hour {h}: the kernel's level {float(lam_k[h])} is off the "
                f"plain version's {float(p_lam[h])} by {float(diff[h]):.3g} "
                f"> {SD_TOL['lam']} outside a gap of the fill")
        a, _ = soft_dispatch_hour_fixed(
            prev, p_dwin[:, h], avail[:, h], keys[h], demand[h], lam_k[h],
            it[0], itm[0], min_dwell=dwell)
        if float((a - p_alloc[:, h]).abs().max()) > SD_TOL["alloc"]:
            raise AssertionError(
                f"hour {h}: the kernel's level {float(lam_k[h])} and the "
                f"plain version's {float(p_lam[h])} place different loads")
    well = diff[diff <= SD_TOL["lam"]]
    return (float(well.max()) if well.numel() else 0.0), len(gap)


def _err(a, b) -> float:
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def _bwd_error(lab: str, back, want, g, it, itm) -> dict:
    """The backward kernel's outputs against the plain version's: d avail,
    d keys and d demand within SD_TOL["grad"] of the larger of their own
    largest magnitude and the cotangent's, d tau within SD_TOL["grad"]
    relative (floored at 1e-6 of the cotangent's sum). Returns the
    errors."""
    floor = float(g.abs().max())
    out = {}
    for name, x, w in zip(("d_avail", "d_keys", "d_demand"), back[:3],
                          want[:3]):
        out[name] = _err(x, w)
        tol = SD_TOL["grad"] * max(float(w.abs().max()), floor)
        if out[name] > tol:
            raise AssertionError(f"{lab}: backward {name} off by "
                                 f"{out[name]:.3g} > {tol:.3g}")
    f_it, f_itm = float(it), float(itm)
    d_tau = [-(f_it ** 2) * float(b[3]) - f_it * f_itm * float(b[4])
             for b in (back, want)]
    out["d_tau"] = abs(d_tau[0] - d_tau[1])
    tol = SD_TOL["grad"] * max(abs(d_tau[1]), 1e-6 * float(g.abs().sum()))
    if out["d_tau"] > tol:
        raise AssertionError(f"{lab}: backward d_tau {d_tau[0]} vs "
                             f"{d_tau[1]} (tolerance {tol:.3g})")
    return out


def phase_soft_dispatch_vs_plain(dev) -> dict:
    """The three soft-dispatch kernels against their plain versions, run on
    the CPU on the same inputs: the forward kernel against
    `soft_dispatch_ref`, the fused forward against `soft_dispatch_fwd_ref`
    (allocation within 1e-5 MW, entering dwell within 1e-4, level within
    1e-3 EUR/MWh except in gap hours; see `_level_error`), the backward
    against `soft_dispatch_bwd_ref` twice, on the kernel's own residuals
    and on the plain version's (see `_bwd_error`), and the forward
    kernel's allocation equal to the fused forward's bit for bit. Cases:
    the reference's four soft cases, the tuner's 32 sites x 2190 h at
    tau 30 and 0.3, zero-demand hours, and groups of more than one warp
    (64 sites, 45 and 130, which are not multiples of 32, and 1024: four
    bisection levels a round down to one). Returns each case's largest
    error per kernel and its count of gap hours."""
    from repro_torch.kernels.ref import (soft_dispatch_bwd_ref,
                                         soft_dispatch_fwd_ref,
                                         soft_dispatch_ref)
    from repro_torch.kernels.soft_dispatch import (soft_dispatch_fused_bwd,
                                                   soft_dispatch_fused_fwd,
                                                   soft_dispatch_scan)

    cases = [(f"{s} x {t}, fee {mc}, dwell {dw}, tau {tau}",
              (s, t, mc, dw, tau, 0, ()))
             for s, t, mc, dw, tau in SOFT_DISPATCH_CASES]
    cases += [("tuner shape 32 x 2190, fee 5, dwell 4, tau 30",
               (32, 2190, 5.0, 4, 30.0, 1, ())),
              ("tuner shape 32 x 2190, fee 5, dwell 4, tau 0.3",
               (32, 2190, 5.0, 4, 0.3, 1, ())),
              ("zero-demand hours 8 x 300, fee 5, dwell 4, tau 3",
               (8, 300, 5.0, 4, 3.0, 2, (0, 50, 51, 299))),
              ("two warps 64 x 300, fee 5, dwell 4, tau 3",
               (64, 300, 5.0, 4, 3.0, 3, ())),
              ("a part warp 45 x 300, fee 5, dwell 4, tau 1",
               (45, 300, 5.0, 4, 1.0, 4, ())),
              ("five warps 130 x 200, fee 3, dwell 0, tau 2",
               (130, 200, 3.0, 0, 2.0, 5, ())),
              ("32 warps 1024 x 16, fee 3, dwell 4, tau 3",
               (1024, 16, 3.0, 4, 3.0, 6, ()))]
    out = {}
    for label, (s, t, mc, dw, tau, seed, zero) in cases:
        cpu = _soft_dispatch_case(s, t, mc, seed, zero)
        avail, keys, order, demand, g = (x.to(dev) for x in cpu)
        it, itm = _inv_taus(tau)
        itd, itmd = it.to(dev), itm.to(dev)
        alone = soft_dispatch_scan(avail, keys, order, demand, tau=tau,
                                   min_dwell=dw)
        alloc, dwin, lam = soft_dispatch_fused_fwd(
            avail, keys, order, demand, itd, itmd, min_dwell=dw)
        back = soft_dispatch_fused_bwd(avail, keys, demand, itd, itmd, alloc,
                                       dwin, lam, g, min_dwell=dw)
        p5 = soft_dispatch_ref(*cpu[:4], tau=tau, min_dwell=dw)
        p6 = soft_dispatch_fwd_ref(*cpu[:4], it, itm, min_dwell=dw)
        back_p = soft_dispatch_fused_bwd(avail, keys, demand, itd, itmd,
                                         *(x.to(dev) for x in p6), g,
                                         min_dwell=dw)
        torch.cuda.synchronize()
        lab = f"soft_dispatch {label}"
        if not torch.equal(alone, alloc):
            raise AssertionError(f"{lab}: the forward kernel's allocation "
                                 "differs from the fused forward's")
        if zero and bool((alloc[:, list(zero)] != 0.0).any()):
            raise AssertionError(f"{lab}: load placed in a zero hour")
        for x in back[:3] + back_p[:3]:
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{lab}: non-finite gradient")
        e5 = _err(alone, p5)
        e6 = {"alloc": _err(alloc, p6[0]), "dwell_in": _err(dwin, p6[1])}
        e6["lam"], n_gap = _level_error(cpu, p6, lam.cpu(), it, itm, dw)
        if e5 > SD_TOL["alloc"]:
            raise AssertionError(f"{lab}: forward kernel alloc off by "
                                 f"{e5:.3g} > {SD_TOL['alloc']}")
        for name, e in e6.items():
            if e > SD_TOL[name]:
                raise AssertionError(f"{lab}: fused forward {name} off by "
                                     f"{e:.3g} > {SD_TOL[name]}")
        e7 = _bwd_error(f"{lab}, own residuals", back, soft_dispatch_bwd_ref(
            cpu[0], cpu[1], cpu[3], it, itm, alloc.cpu(), dwin.cpu(),
            lam.cpu(), cpu[4], min_dwell=dw), cpu[4], it, itm)
        e7p = _bwd_error(f"{lab}, plain residuals", back_p,
                         soft_dispatch_bwd_ref(cpu[0], cpu[1], cpu[3], it,
                                               itm, *p6, cpu[4],
                                               min_dwell=dw), cpu[4], it, itm)
        print(f"[kernel] {lab}: max |kernel - plain| forward alloc "
              f"{e5:.3g}; fused forward "
              + ", ".join(f"{k} {v:.3g}" for k, v in e6.items())
              + "; backward on its own residuals "
              + ", ".join(f"{k} {v:.3g}" for k, v in e7.items())
              + ", on the plain version's "
              + ", ".join(f"{k} {v:.3g}" for k, v in e7p.items())
              + f"; {n_gap} gap hours of {t}; kernel 5 == kernel 6 bitwise")
        out[label] = {"k5": e5, "k6": max(e6.values()),
                      "k7": max(*e7.values(), *e7p.values()),
                      "gap_hours": n_gap}
    return out


def phase_soft_to_hard(dev) -> dict:
    """Soft -> hard convergence at full width through the entry points,
    with the launch counts set to 0 just before and read just after: the
    dispatch benchmark's 64 sites x 8760 h relaxed at tau 1e-3
    (`soft_dispatch`, the forward kernel) against feasible `dispatch`
    (`dispatch_scan`): CPC within rel 1e-3, delivered MWh within rel 1e-5,
    as the reference's `test_soft_converges_to_hard_cpc` holds them."""
    from repro_torch.dispatch import (dispatch, segment_keys, segment_rank,
                                      summarize_alloc)
    from repro_torch.kernels.soft_dispatch import soft_dispatch

    _, problem = _dispatch_fleet(64, dev)
    keys64 = segment_keys(problem.prices, problem.migrate_cost)
    order, _ = segment_rank(problem.prices, problem.migrate_cost,
                            keys=keys64)
    args = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
            for x in (problem.avail_mw, keys64.astype(np.float32), order,
                      problem.demand_mw)]
    tau = 1e-3
    counters = _zero_counters()
    t0 = time.perf_counter()
    soft = soft_dispatch(*args, tau=tau, min_dwell=problem.min_dwell_h)
    hard = dispatch(problem, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    device = _device_launches(counters)
    if launches["soft_dispatch"] != 1 or launches["dispatch_scan"] != 1:
        raise AssertionError(f"soft -> hard: launches {launches}")
    soft_np = soft.cpu().numpy()
    res = summarize_alloc(problem, soft_np)
    rel_cpc = res.cpc / hard.cpc - 1.0
    rel_mwh = res.delivered_mwh / hard.delivered_mwh - 1.0
    print(f"[soft] soft_dispatch tau 1e-3 vs dispatch on 64 sites x "
          f"{problem.avail_mw.shape[1]} h ({wall:.2f} s; launches "
          f"{launches}): cpc {res.cpc:.6f} vs {hard.cpc:.6f} (rel "
          f"{rel_cpc:.3g}), delivered {res.delivered_mwh:.3f} vs "
          f"{hard.delivered_mwh:.3f} MWh (rel {rel_mwh:.3g}), largest "
          f"allocation difference {np.abs(soft_np - hard.alloc_mw).max():.4g}"
          " MW")
    if not (abs(rel_cpc) <= 1e-3 and abs(rel_mwh) <= 1e-5):
        raise AssertionError("soft -> hard: CPC or delivered MWh apart")
    return {"launches": launches["soft_dispatch"], "device_launches": device,
            "args": args,
            "soft": soft, "tau": tau, "min_dwell": problem.min_dwell_h}


def _count_plain_calls(names):
    """Wraps the named plain versions in `repro_torch.kernels.soft_dispatch`
    with call counters; returns (counts, restore)."""
    from repro_torch.kernels import soft_dispatch as mod

    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(mod, n) for n in names}

    def wrap(n):
        def fn(*a, **k):
            counts[n] += 1
            return saved[n](*a, **k)
        return fn
    for n in names:
        setattr(mod, n, wrap(n))

    def restore():
        for n, f in saved.items():
            setattr(mod, n, f)
    return counts, restore


def phase_dispatch_aware_tuner(dev, rescore) -> dict:
    """The dispatch-aware tuner at full width: `optimize` on the tuner grid
    (256 rows x 2190 h, 200 steps) with `Coupling(dispatch=)` at the
    config `phase_tuner`'s re-scoring used, launch counts set to 0 just
    before and read just after (the fused soft-dispatch kernels once a
    step each, their plain versions never); then 25 steps twice, bit for
    bit equal."""
    from repro_torch.dispatch import DispatchConfig
    from repro_torch.tune import Coupling, TuneConfig, optimize

    grid = _tune_grid(dev)
    dcfg = DispatchConfig(demand_frac=0.3, migrate_cost=5.0, min_dwell_h=4)
    cfg = TuneConfig(steps=200, coupling=Coupling(dispatch=dcfg))
    plain, restore = _count_plain_calls(("soft_dispatch_ref",
                                         "soft_dispatch_fwd_ref",
                                         "soft_dispatch_bwd_ref"))
    try:
        counters = _zero_counters()
        t0 = time.perf_counter()
        res = optimize(grid, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        device = _device_launches(counters)
    finally:
        restore()
    print(f"[aware] optimize with Coupling(dispatch=) {grid.n_rows} rows x "
          f"{grid.n_hours} h x {cfg.steps} steps: {wall:.2f} s wall "
          f"({wall / cfg.steps * 1e3:.1f} ms per step, first call); "
          f"launches {launches}; plain versions called {plain}")
    for k in ("soft_dispatch_fused_fwd", "soft_dispatch_fused_bwd"):
        if launches[k] != cfg.steps:
            raise AssertionError(f"the dispatch-aware tuner launched {k} "
                                 f"{launches[k]} times in {cfg.steps} steps")
    if launches["soft_dispatch"] or any(plain.values()):
        raise AssertionError("a plain soft-dispatch version (or the "
                             "forward-only kernel) ran on the tuner path")
    for k in ("loss", "dispatch_ratio"):
        if not np.all(np.isfinite(res.history[k])):
            raise AssertionError(f"history[{k!r}] not finite")
    d = res.dispatch
    best = min(d["cpc_tuned"], d["cpc_swept"])
    if not (np.isfinite(best) and best <= d["cpc_swept"] * (1 + 1e-9)):
        raise AssertionError("dispatch-aware: fleet CPC not finite or above "
                             "the swept set's")
    r = rescore.dispatch
    print(f"[aware] fleet CPC on feasible dispatch: dispatch-aware tuned "
          f"{d['cpc_tuned']:.4f}, swept {d['cpc_swept']:.4f}, chosen "
          f"{d['chosen']}; re-score-only (phase_tuner) tuned "
          f"{r['cpc_tuned']:.4f}, swept {r['cpc_swept']:.4f}; "
          f"dispatch_ratio {res.history['dispatch_ratio'][0]:.4f} -> "
          f"{res.history['dispatch_ratio'][-1]:.4f}; guard "
          f"{res.guard_count}")

    cfg25 = TuneConfig(steps=25, coupling=Coupling(dispatch=dcfg))
    a, b = (optimize(grid, cfg25, device=dev) for _ in range(2))
    same = all(torch.equal(x, y) for x, y in zip(a.params, b.params)) \
        and np.array_equal(a.cpc, b.cpc) \
        and a.dispatch["cpc_tuned"] == b.dispatch["cpc_tuned"] \
        and a.dispatch["cpc_swept"] == b.dispatch["cpc_swept"] \
        and np.array_equal(a.dispatch["tuned"].alloc_mw,
                           b.dispatch["tuned"].alloc_mw)
    if not same:
        raise AssertionError("dispatch-aware optimize is not deterministic")
    print("[aware] 25 steps twice: parameters, CPCs and the hard allocation "
          "equal bit for bit")
    return {"launches": launches, "device_launches": device, "grid": grid}


def _acceptance_grid(dev):
    """The reference's `_acceptance_grid` (tests/test_soft_dispatch.py): 4
    markets x 4 systems x 16 policies = 256 rows x 600 h."""
    from repro_torch.core.tco import make_system
    from repro_torch.energy.markets import MarketParams
    from repro_torch.fleet import PolicySpec, build_grid

    t = 600
    markets = [MarketParams(n_hours=t, seed=s) for s in range(4)]
    systems = [make_system(float(psi) * t * 1.0 * 80.0, 1.0, float(t),
                           device=dev) for psi in (0.5, 1.0, 2.0, 4.0)]
    xs = (0.01, 0.02, 0.03, 0.05, 0.08, 0.10, 0.12, 0.15, 0.20, 0.25, 0.30,
          0.40)
    policies = [PolicySpec("ao")] + \
        [PolicySpec(f"x{int(x * 100)}", x=x, off_level=0.25) for x in xs] + \
        [PolicySpec("x3h", x=0.03, hysteresis=0.9, off_level=0.25),
         PolicySpec("x8h", x=0.08, hysteresis=0.85, off_level=0.25),
         PolicySpec("x15h", x=0.15, hysteresis=0.9, off_level=0.25)]
    return build_grid(markets, systems, policies, device=dev)


def phase_acceptance(dev) -> None:
    """The reference's acceptance: on its 256-row grid (150 steps,
    DispatchConfig(0.3, 4.0, 3)) the dispatch-aware fleet CPC on feasible
    dispatch is no worse than the re-score-only path's; then the
    `tune_policies --dispatch-soft` demo on the card, exit code 0."""
    from repro_torch.dispatch import DispatchConfig
    from repro_torch.examples import tune_policies
    from repro_torch.tune import Coupling, TuneConfig, optimize

    grid = _acceptance_grid(dev)
    dcfg = DispatchConfig(demand_frac=0.3, migrate_cost=4.0, min_dwell_h=3)
    t0 = time.perf_counter()
    rescore = optimize(grid, TuneConfig(steps=150,
                                        coupling=Coupling(reeval=dcfg)),
                       device=dev)
    aware = optimize(grid, TuneConfig(steps=150,
                                      coupling=Coupling(dispatch=dcfg)),
                     device=dev)
    torch.cuda.synchronize()
    cr = min(rescore.dispatch["cpc_tuned"], rescore.dispatch["cpc_swept"])
    ca = min(aware.dispatch["cpc_tuned"], aware.dispatch["cpc_swept"])
    print(f"[aware] acceptance grid {grid.n_rows} rows x {grid.n_hours} h x "
          f"150 steps ({time.perf_counter() - t0:.2f} s): re-score-only "
          f"{cr:.4f} (tuned {rescore.dispatch['cpc_tuned']:.4f}), "
          f"dispatch-aware {ca:.4f} (tuned {aware.dispatch['cpc_tuned']:.4f}"
          f"), swept {aware.dispatch['cpc_swept']:.4f}")
    if not (np.isfinite(ca) and ca <= cr * (1 + 1e-9)
            and ca <= aware.dispatch["cpc_swept"] * (1 + 1e-9)):
        raise AssertionError("acceptance: dispatch-aware fleet CPC above "
                             "the re-score-only path's")
    print("[aware] repro_torch.examples.tune_policies --dispatch-soft on "
          "the card:")
    t0 = time.perf_counter()
    rc = tune_policies.main(["--dispatch-soft", "--device", str(dev)])
    print(f"[aware] demo exit {rc}, {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError("tune_policies --dispatch-soft: dispatch-aware "
                             "fleet CPC above re-score-only")


def _same(label: str, a, b) -> None:
    """Every field of two results (NamedTuples of tensors / arrays /
    numbers, or tensors) equal bit for bit, or raise."""
    for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
        if isinstance(x, torch.Tensor):
            ok = x.shape == y.shape and torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            ok = np.array_equal(x, y, equal_nan=True)
        elif isinstance(x, tuple):
            _same(f"{label}.{name}", x, y)
            ok = True
        elif isinstance(x, dict) or x is None:
            ok = True                 # compared field by field elsewhere
        else:
            ok = x == y or (x != x and y != y)
        if not ok:
            raise AssertionError(f"{label}.{name}: telemetry on != off")


def _validate_run(run: Path) -> None:
    """``python -m repro_torch.obs.report <run> --validate`` exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(run),
         "--validate", "-o", str(run / "digest.md")],
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"repro_torch.obs.report --validate exit "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")


def phase_telemetry(dev) -> None:
    """Everything under `repro_torch.obs.capture`, each run against a run
    with telemetry off: the benchmark grid's 1024 x 8760 backtest and
    summary (every field bit for bit, one `fleet_scan` launch a call on
    or off; the drained ``fleet.hourly`` against a per-hour loop of
    `hard_hour_step` on the card over the first 64 rows), a 64 x 8760
    `dispatch` (allocations bit for bit; the trace's `reconstruct_dispatch`
    gives its ``cpc`` and ``n_migrations`` exactly), a 200-step
    `optimize` on the tuner grid (parameters and CPC bit for bit, the
    same kernels as many times, 200 ``tune.step`` events with
    ``grad_norm``); the report's ``--validate`` exits 0. Prints the wall
    times with telemetry on and off."""
    import tempfile

    from repro_torch import obs
    from repro_torch.dispatch import dispatch
    from repro_torch.fleet import backtest, summarize
    from repro_torch.kernels.ref import fleet_hourly_ref, hard_hour_step
    from repro_torch.obs import report
    from repro_torch.tune import TuneConfig, optimize

    run = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_")) / "run"
    _, grid = _bench_grid(16, 8, dev)
    counters = _zero_counters()
    walls = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        return out

    def bt():
        rep = backtest(grid, device=dev)
        return rep, summarize(grid, rep)

    bt()                                   # warm: both timed runs hot
    before_off = counters["fleet_scan"].launches
    rep_off, summ_off = timed("backtest off", bt)
    n_off = counters["fleet_scan"].launches - before_off
    dgrid, problem = _dispatch_fleet(64, dev)
    d_off = dispatch(problem, device=dev)
    tgrid = _tune_grid(dev)
    tcfg = TuneConfig(steps=200)
    optimize(tgrid, tcfg._replace(steps=20), device=dev)          # warm
    before = {k: fn.launches for k, fn in counters.items()}
    tune_off = timed("optimize off", lambda: optimize(tgrid, tcfg,
                                                      device=dev))
    tune_n_off = {k: fn.launches - before[k] for k, fn in counters.items()}
    with obs.capture(run, run_id="chip_smoke"):
        before_on = counters["fleet_scan"].launches
        rep_on, summ_on = timed("backtest on", bt)
        n_on = counters["fleet_scan"].launches - before_on
        d_on = dispatch(problem, device=dev)
        before = {k: fn.launches for k, fn in counters.items()}
        tune_on = timed("optimize on", lambda: optimize(tgrid, tcfg,
                                                        device=dev))
        tune_n_on = {k: fn.launches - before[k]
                     for k, fn in counters.items()}
    if n_off != 1 or n_on != 1:
        raise AssertionError(f"backtest: {n_off} / {n_on} fleet_scan "
                             "launches off / on, not one a call")
    _same("FleetReport", rep_off, rep_on)
    _same("FleetSummary", summ_off, summ_on)
    _same("DispatchResult", d_off, d_on)
    _same("TuneResult", tune_off, tune_on)
    for k, v in tune_off.history.items():
        if not np.array_equal(v, tune_on.history[k]):
            raise AssertionError(f"optimize history[{k!r}]: on != off")
    if tune_n_off != tune_n_on:
        raise AssertionError(f"optimize launches off {tune_n_off} != on "
                             f"{tune_n_on}")
    events = report.load_events(run)

    def kind(k):
        return [e for e in events if e["kind"] == k]

    hourly = kind("fleet.hourly")[0]
    full = fleet_hourly_ref(grid.prices[grid.market_idx], grid.p_on,
                            grid.p_off, grid.off_level, grid.idle_frac,
                            grid.power)
    for name, v in full._asdict().items():
        if not np.array_equal(np.asarray(hourly[name], np.float32),
                              v.cpu().numpy()):
            raise AssertionError(f"fleet.hourly.{name}: not the companion")
    # the companion against the per-hour loop over the first 64 rows
    rows = torch.arange(min(64, grid.n_rows), device=dev)
    p = grid.prices[grid.market_idx[rows]]
    args = [v[rows] for v in (grid.p_on, grid.p_off, grid.off_level,
                              grid.idle_frac, grid.power)]
    got = fleet_hourly_ref(p, *args)
    on = torch.ones(rows.shape[0], device=dev)
    cols = []
    for t in range(p.shape[1]):
        new, st, cap, draw = hard_hour_step(on, p[:, t], *args[:4])
        cols.append(torch.stack([
            (args[4] * cap).sum(), (args[4] * draw * p[:, t]).sum(),
            st.sum(), torch.clamp(on - new, min=0.0).sum()]))
        on = new
    loop = torch.stack(cols, 1)
    if not (torch.equal(got.starts, loop[2])
            and torch.equal(got.stops, loop[3])):
        raise AssertionError("fleet_hourly_ref: starts / stops differ from "
                             "the per-hour loop")
    torch.testing.assert_close(got.on_mw, loop[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got.draw_price, loop[1], rtol=1e-5,
                               atol=1e-2)
    rec = report.reconstruct_dispatch(events)
    if rec["cpc"] != d_on.cpc or rec["n_migrations"] != d_on.n_migrations:
        raise AssertionError("reconstruct_dispatch: not the emitted result")
    steps = kind("tune.step")
    if len(steps) != 200 or not all("grad_norm" in e for e in steps):
        raise AssertionError(f"{len(steps)} tune.step events, not 200 "
                             "with grad_norm")
    _validate_run(run)
    print(f"[obs] backtest {grid.n_rows} x {grid.n_hours}: FleetReport and "
          f"FleetSummary on == off bit for bit, fleet_scan launches "
          f"{n_off} / {n_on} a call; fleet.hourly == fleet_hourly_ref; "
          f"vs the per-hour loop ({rows.shape[0]} rows): starts, stops "
          f"equal, on_mw max "
          f"rel {float(((got.on_mw - loop[0]) / loop[0]).abs().max()):.3g}")
    print(f"[obs] dispatch {problem.avail_mw.shape[0]} x "
          f"{problem.avail_mw.shape[1]}: allocations on == off bit for bit; "
          f"trace reconstructs cpc {rec['cpc']:.6f} and "
          f"{rec['n_migrations']} moves exactly")
    print(f"[obs] optimize {tgrid.n_rows} x {tgrid.n_hours} x {tcfg.steps}: "
          f"params, raw, cpc on == off bit for bit; launches {tune_n_on}; "
          f"{len(steps)} tune.step events, grad_norm "
          f"{steps[0]['grad_norm']:.4g} -> {steps[-1]['grad_norm']:.4g}; "
          f"report --validate exit 0 ({len(events)} events)")
    print("[obs] wall: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in walls.items()))


def phase_live(dev) -> dict:
    """The live operator on the card: the ``--smoke`` sweep (24 controllers
    x 336 h) against the same sweep on the CPU, the example's full sweep
    (384 controllers x 2190 h: 4 markets x 3 policies x 4 forecasters x
    horizons {24, 168} x cadences {1, 24} x 2 families) twice and once
    under telemetry (all bit for bit), the hindsight sandwich on every
    row, the perfect forecast at the full horizon against `offline_cpc`
    on the kernel; `live_fleet_dispatch` never re-solving over 8 sites x
    2190 h against `dispatch` (bit for bit; that call launches
    `dispatch_scan`); ``live_operator --retune --smoke`` and ``--smoke``
    exit 0. Prints the sweep's wall time, controller-hours/s, device
    kernels an hour and busy share under the profiler."""
    import argparse
    import tempfile

    from repro_torch import obs
    from repro_torch.dispatch import dispatch
    from repro_torch.examples import live_operator
    from repro_torch.fleet import backtest
    from repro_torch.live import (build_live_grid,
                                  live_backtest, live_fleet_dispatch,
                                  offline_cpc, summarize_live)
    from repro_torch.live.controller import near_threshold_hours

    near_rtol = 1e-5
    # ---- the smoke sweep, card against CPU
    _, lg, cfg, _ = live_operator.build(argparse.Namespace(smoke=True), dev)
    t0 = time.perf_counter()
    got = live_backtest(lg, cfg, device=dev)
    torch.cuda.synchronize()
    t_smoke = time.perf_counter() - t0
    want = live_backtest(lg, cfg, device="cpu")
    fid, fam = lg.forecaster_id.cpu(), lg.family_id.cpu()
    exact = (fam == 0) & (fid != 1)           # quantile, exact forecasters
    near = near_threshold_hours(lg, cfg, near_rtol, device=dev).cpu() \
        + near_threshold_hours(lg, cfg, near_rtol, device="cpu")
    calm = near == 0
    # decisions exactly: the quantile family under exact forecasts (a
    # sort and a gather), every row without a near-threshold hour; the
    # ratios within rtol (the card divides a tensor by a host number
    # through its reciprocal, the CPU exactly)
    for name in ("n_starts", "n_stops", "p_off_final", "threshold_updates"):
        g, w = getattr(got, name).cpu(), getattr(want, name)
        if not torch.equal(g[exact], w[exact]):
            raise AssertionError(f"live smoke {name}: the quantile family "
                                 "under exact forecasts differs card vs CPU")
    for name in ("n_starts", "n_stops"):
        g, w = getattr(got, name).cpu(), getattr(want, name)
        if not torch.equal(g[calm], w[calm]):
            raise AssertionError(f"live smoke {name}: differs card vs CPU "
                                 "on a row with no near-threshold hour")
    for name in ("cpc", "p_off_final", "tco", "x_realized", "cpc_ao",
                 "mae1", "mae_h"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=near_rtol,
                                   atol=0.0)
    n_diff = int((got.n_starts.cpu() != want.n_starts).sum())
    print(f"[live] smoke sweep {lg.n_rows} x {cfg.hours} h on the card "
          f"({t_smoke:.2f} s) vs the CPU: quantile rows under exact "
          f"forecasts equal; cpc / thresholds within rtol {near_rtol}; "
          f"near-threshold row-hours {int(near.sum())} on "
          f"{int((near > 0).sum())} rows; rows whose starts differ "
          f"{n_diff} (all near-threshold)")

    # ---- the full sweep
    grid, lg, cfg, _ = live_operator.build(argparse.Namespace(smoke=False),
                                           dev)
    counters = _zero_counters()
    t0 = time.perf_counter()
    res = live_backtest(lg, cfg, device=dev)
    summ = summarize_live(lg, res, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    device = _device_launches(counters)
    if launches["fleet_scan"] < 1:
        raise AssertionError("the live sweep's offline_cpc never launched "
                             "fleet_scan")
    t0 = time.perf_counter()
    again = live_backtest(lg, cfg, device=dev)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    _same("LiveResult (rerun)", res, again)
    run = Path(tempfile.mkdtemp(prefix="chip_smoke_live_")) / "run"
    with obs.capture(run, run_id="chip_smoke_live"):
        hot = live_backtest(lg, cfg, device=dev)
        summarize_live(lg, hot, cfg)
    _same("LiveResult", res, hot)
    _validate_run(run)
    keeps = lg.x <= 0.0       # rows that never re-solve keep +inf as is
    for name, v in res._asdict().items():
        ok = torch.isfinite(v.double())
        if name == "p_off_final":
            ok |= keeps & (v == float("inf"))
        if tuple(v.shape) != (lg.n_rows,) or not bool(ok.all()):
            raise AssertionError(f"LiveResult.{name}: not finite [B]")
    bad = ~(summ.cpc_oracle <= summ.cpc_live * (1 + 1e-5) + 1e-6)
    if bad.any():
        raise AssertionError(f"hindsight sandwich broken on {bad.sum()} "
                             "rows")
    ch_s = lg.n_rows * cfg.hours / wall2
    print(f"[live] full sweep {lg.n_rows} controllers x {cfg.hours} h: "
          f"{wall:.2f} s with summarize_live (first call), {wall2:.2f} s "
          f"again ({ch_s:.0f} controller-hours/s); rerun and telemetry "
          f"run bit for bit; sandwich on all rows; launches {launches}; "
          f"best {summ.table[0]['forecaster']} H={summ.table[0]['horizon']}"
          f" cadence={summ.table[0]['cadence']} {summ.table[0]['family']} "
          f"cpc {summ.table[0]['cpc']:.3f}")
    # two days of the same sweep: every hour runs the same operations
    window = cfg._replace(hours=48)
    prof = _profile(lambda: live_backtest(lg, window, device=dev),
                    f"live_backtest {lg.n_rows} x {window.hours} h", runs=1)
    if prof:
        print(f"[live] the hour loop: "
              f"{prof['kernels'] / window.hours:.1f} device kernels an "
              f"hour, {prof['busy']:.1%} busy under the profiler, "
              f"{prof['wall_us'] / window.hours / 1e3:.3f} ms an hour")

    # ---- perfect forecast at the full horizon against the offline kernel
    policies = list(live_operator.POLICIES)
    lp = build_live_grid(grid, policies, forecasters=("perfect",),
                         horizons=(cfg.hours,), cadences=(1,),
                         families=("quantile",))
    counters = _zero_counters()
    perf = live_backtest(lp, cfg, device=dev)
    off = offline_cpc(lp, cfg)
    off_rep = backtest(lp.grid, device=dev)      # the window is the trace
    torch.cuda.synchronize()
    if counters["fleet_scan"].launches != 2:
        raise AssertionError("offline_cpc / backtest did not launch "
                             "fleet_scan once each")
    live_cpc = perf.cpc.double().cpu().numpy()
    np.testing.assert_allclose(live_cpc, off, rtol=1e-5)
    if not torch.equal(perf.n_starts, off_rep.n_starts):
        raise AssertionError("perfect forecast, full horizon: n_starts "
                             "differ from the offline backtest")
    print(f"[live] perfect forecast at H = {cfg.hours} ({lp.n_rows} rows): "
          f"cpc vs offline_cpc on the kernel max rel "
          f"{float(np.max(np.abs(live_cpc - off) / off)):.3g} (gate rtol "
          f"1e-5), n_starts equal")

    # ---- live fleet dispatch, never re-solving, against dispatch()
    fgrid, problem = _dispatch_fleet(8, dev, hours=2190)
    t0 = time.perf_counter()
    lf = live_fleet_dispatch(
        fgrid.prices, fgrid.power, fgrid.p_on, fgrid.p_off, fgrid.off_level,
        fgrid.idle_frac, 0.0, problem.demand_mw, hours=fgrid.n_hours,
        horizon=24, cadence=10 ** 6, season=168,
        migrate_cost=problem.migrate_cost, min_dwell=problem.min_dwell_h,
        device=dev)
    torch.cuda.synchronize()
    t_fleet = time.perf_counter() - t0
    counters = _zero_counters()
    d = dispatch(problem, device=dev)
    torch.cuda.synchronize()
    fleet_launches = counters["dispatch_scan"].launches
    fleet_device = _device_launches(counters)
    if fleet_launches != 1:
        raise AssertionError("dispatch did not launch dispatch_scan once")
    if not np.array_equal(lf.alloc_mw.cpu().numpy(), d.alloc_mw):
        raise AssertionError("live_fleet_dispatch (never re-solving) != "
                             "dispatch bit for bit")
    print(f"[live] live_fleet_dispatch {fgrid.n_markets} sites x "
          f"{fgrid.n_hours} h "
          f"({t_fleet:.2f} s): allocations == dispatch() (dispatch_scan "
          f"launches {fleet_launches}) bit for bit; replan "
          f"{float(lf.replan_mw):.3f} MW, shed {float(lf.shed_mwh):.3g} MWh")

    for flags in (["--smoke"], ["--retune", "--smoke"]):
        t0 = time.perf_counter()
        rc = live_operator.main(flags + ["--device", str(dev)])
        print(f"[live] live_operator {' '.join(flags)} exit {rc}, "
              f"{time.perf_counter() - t0:.2f} s")
        if rc != 0:
            raise AssertionError(f"live_operator {flags}: exit {rc}")
    return {"launches": launches["fleet_scan"],
            "device_launches": device,
            "fleet_launches": fleet_launches,
            "fleet_device_launches": fleet_device}


# ---------------------------------------------------------------------------
# the faults and workload slice: the ledger kernels, the two backtests at
# their benchmarks' shapes, and the two examples at full size
# ---------------------------------------------------------------------------

LEDGER_SOURCE = "src/repro_torch/kernels/csrc/queue_scan.cu"
LEDGER_REPLACES = "src/repro/kernels/queue_scan.py:170"     # the lax.scan
# `benchmarks/bench_workload.py:29` / `bench_faults.py`: 8 German draws x
# 4 systems x 8 policies = 256 rows x 4096 h, 8 demand draws, seed 7, the
# default Workload's deadline 4 h and bound 4 MWh
LEDGER_BENCH = dict(n_markets=8, n_systems=4, hours=4096, n_draws=8,
                    seed=7)
SOFT_LEDGER_SHAPE = (256, 2190, 4)     # rows x hours x deadline (tuner)
LIVE_REPLAY_SHAPE = (32, 96)           # draws x hours (the live replay)
LEDGER_KERNEL = re.compile(r"(workload_ledger|soft_ledger_fwd|"
                           r"soft_ledger_bwd)_kernelI(?:([fd]))?"
                           r"Li(n?\d+)E")


def _report_ledger_kernels(log: str) -> None:
    """Registers, spills and stack (ptxas) of the ledger kernels at the
    deadline the benchmarks and the tuner use (d = 4, the queue in
    registers) and in the memory form (d > 8). Fails if one is missing."""
    info = _ptxas_records(log, LEDGER_KERNEL)
    for kind, dtype in (("workload_ledger", None), ("soft_ledger_fwd", "f"),
                        ("soft_ledger_fwd", "d"), ("soft_ledger_bwd", "f"),
                        ("soft_ledger_bwd", "d")):
        for d in ("4", "n1"):
            rec = info.get((kind, dtype, d), {})
            if "registers" not in rec:
                raise AssertionError(f"build: no ptxas record of {kind} "
                                     f"({dtype}, d {d})")
            st, ld = rec.get("spill", (0, 0))
            print(f"[build] {kind}_kernel"
                  + (f" {'float32' if dtype == 'f' else 'float64'}"
                     if dtype else "")
                  + f", {'d 4 in registers' if d == '4' else 'd > 8'}: "
                  f"{rec['registers']} registers, stack "
                  f"{rec.get('stack', 0)} B, spill stores {st} B, spill "
                  f"loads {ld} B")


LEDGER_KERNELS = ("workload_ledger_fwd", "soft_ledger_fwd",
                  "soft_ledger_bwd")


def _ledger_bound(kind: str, b: int, t: int, d: int, g: int = 1,
                  n: int = 0, itemsize: int = 4) -> tuple[float, str, int]:
    """Least time for one ledger kernel's work on an H100 SXM: each input
    read once and each output written once at 3.35 TB/s, against its
    float operations at 67 TFLOP/s (a softplus or sigmoid's exp and log1p
    counted as one operation each). Returns (ms, what bounds it, bytes).

      hard: the [N, T] prices, [G, T] demand, the int64 index and five [B]
        parameters in, [4, B, G] out; a lane-hour ~14 + 7 (d + 1) + 8 d
        operations (the state machine, the serve and re-queue passes, the
        four sums);
      soft forward: [B, T] demand and capacity in, [4, B] sums, the [T, d,
        B] queue history and [B, d] final queue out; a row-hour ~10 + 11
        (2 d + 1) + 4 (2 d + 1) operations (each smoothclip two softplus);
      soft backward: demand, capacity and the history in, [B, T] d cap
        and d demand out; a row-hour about three times the forward's
        (the forward again, two sigmoids a clip, the adjoint)."""
    if kind == "hard":
        nbytes = 4 * (n * t + g * t) + b * (8 + 20) + 16 * b * g
        ops = (14 + 7 * (d + 1) + 8 * d) * b * g * t
    else:
        fwd_ops = (10 + 15 * (2 * d + 1)) * b * t
        if kind == "fwd":
            nbytes = itemsize * (2 * b * t + t * d * b + 4 * b + b * d)
            ops = fwd_ops
        else:
            nbytes = itemsize * (2 * b * t + t * d * b + 4 * b + 2 * b * t)
            ops = 3 * fwd_ops
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations", nbytes


def _max_err(got, want, scaled: bool = False) -> float:
    """max |got - want| over the pairs; ``scaled`` divides each pair's by
    max(1, max |want|)."""
    return max(float((x.double() - y.double()).abs().max())
               / (max(1.0, float(y.double().abs().max())) if scaled else 1.0)
               for x, y in zip(got, want))


def phase_ledger_vs_plain(dev) -> dict:
    """The three ledger kernels against their plain versions on the card,
    with times (CUDA events, L2 flushed, device only), bounds and the
    design's serial floor (the kernel's time on one lane over the same
    hours).

    `workload_ledger_fwd` at the benchmark shape (256 rows x 4096 h x 8
    draws through the index of 8 markets, deadline 4, bound 4 MWh) within
    rtol 1e-5 (bucket sums in another order), bit for bit on
    integer-valued work, at d = 0 and d = 9 (the memory form) and B = 1,
    telemetry on == off bit for bit; the soft pair through a
    differentiable soft `queue_scan` at the tuner's 256 x 2190 x d 4:
    float64 within 1e-10 of max(1, each output's largest entry) of the
    plain loop and of autograd through it, float32 (the tuner's form)
    forward within rtol 1e-5 and d cap / d demand within 1e-4 of max(1,
    their largest entry); the hard float64 forward (the live replay's
    ledger) at 32 draws x 96 h bit for bit on integer-valued work and
    within 1e-10 of max(1, each sum's largest entry) on sampled demand."""
    from repro_torch.kernels import queue_scan as qs
    from repro_torch.kernels.ref import queue_scan_ref
    from repro_torch.workload import Workload

    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32,
                        device=dev)          # 128 MB > the 50 MB L2
    cfg = LEDGER_BENCH
    _, grid = _bench_grid(cfg["n_markets"], cfg["n_systems"], dev,
                          hours=cfg["hours"])
    wl = Workload(n_draws=cfg["n_draws"], seed=cfg["seed"])
    b, t, d, g = grid.n_rows, grid.n_hours, wl.deadline_h, wl.n_draws
    dt = grid.period / t
    dem = torch.as_tensor(wl.sample_demand_mw(t), dtype=torch.float32,
                          device=dev)
    args = (grid.prices, grid.p_on, grid.p_off, grid.off_level,
            grid.power * dt, dem, dt)
    kw = dict(deadline=d, bound=wl.queue_bound_mwh,
              market_idx=grid.market_idx)
    t0 = time.perf_counter()
    got, _ = qs.workload_ledger_fwd(*args, **kw)
    got_t, hr = qs.workload_ledger_fwd(*args, hourly=True, **kw)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, hr_w = qs.workload_ledger_fwd(*args, hourly=True,
                                        use_kernel=False, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for x, y, z in zip(got, got_t, want):
        if not torch.equal(x, y):
            raise AssertionError("workload_ledger_fwd: telemetry changed "
                                 "the sums")
        torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(hr, hr_w, rtol=1e-5, atol=1e-4)
    hard_err = _max_err(got, want)
    same = all(torch.equal(x, z) for x, z in zip(got, want))
    print(f"[ledger] workload_ledger_fwd {b} x {t} h x {g} draws, d {d} "
          f"(first calls {t_kernel:.2f} s, build included): max |kernel - "
          f"plain| {hard_err:.3g} (rtol 1e-5), "
          f"{'bit for bit' if same else 'not bit for bit'}; telemetry "
          f"on == off bit for bit; plain hour loop {plain_s:.2f} s")
    # integer-valued work: bit for bit, at d 0, 4, 9 and B = 1
    rng = np.random.default_rng(7)
    for bb, nn, gg, tt, dd in ((1, 1, 1, 300, 2), (64, 8, 8, 1000, 4),
                               (33, 4, 40, 500, 0), (50, 5, 5, 700, 9)):
        iargs = [torch.as_tensor(a, device=dev) for a in (
            rng.integers(0, 100, (nn, tt)).astype(np.float32),
            np.full(bb, 40.0, np.float32), np.full(bb, 60.0, np.float32),
            np.zeros(bb, np.float32),
            rng.integers(1, 6, bb).astype(np.float32),
            rng.integers(0, 5, (gg, tt)).astype(np.float32),
            np.ones(bb, np.float32))]
        ik = dict(deadline=dd, bound=3.0, market_idx=torch.as_tensor(
            rng.integers(0, nn, bb), device=dev))
        x = qs.workload_ledger_fwd(*iargs, **ik)[0]
        y = qs.workload_ledger_fwd(*iargs, use_kernel=False, **ik)[0]
        if not all(torch.equal(u, v) for u, v in zip(x, y)):
            raise AssertionError(f"workload_ledger_fwd not bit for bit on "
                                 f"integer work at B {bb}, G {gg}, d {dd}")
    print("[ledger] workload_ledger_fwd on integer-valued work (B 1, 64, "
          "33, 50; G 1-40; d 0, 2, 4, 9): bit for bit")

    # the soft pair at the tuner's shape, through a differentiable soft
    # `queue_scan` (`SoftLedger`), against autograd through the plain loop
    sb, st, sd = SOFT_LEDGER_SHAPE
    rng = np.random.default_rng(11)
    a64 = torch.as_tensor(rng.uniform(0.0, 1.5, (sb, st)), device=dev)
    c64 = torch.as_tensor(rng.uniform(0.0, 2.0, (sb, st)), device=dev)
    gg64 = torch.as_tensor(rng.normal(size=(4, sb)), device=dev)
    p64 = torch.as_tensor(rng.normal(80, 20, (sb, st)), device=dev)
    tau = 0.3
    soft_err = {}
    for dtype in (torch.float64, torch.float32):
        a_, c_, g_, p_ = (x.to(dtype) for x in (a64, c64, gg64, p64))
        at, ct = (x.clone().requires_grad_(True) for x in (a_, c_))
        o = qs.queue_scan(at, ct, deadline=sd, bound=4.0, tau=tau,
                          prices=p_)
        sums = [x.detach() for x in (o.served, o.dropped, o.backlog,
                                     o.served_cost)]
        d_a, d_c = torch.autograd.grad(
            sum((g_[k] * v).sum() for k, v in enumerate(
                (o.served, o.dropped, o.backlog, o.served_cost))), [at, ct])
        at2, ct2 = (x.clone().requires_grad_(True) for x in (a_, c_))
        t0 = time.perf_counter()
        out = queue_scan_ref(at2, ct2, deadline=sd, bound=4.0, tau=tau,
                             prices=p_)
        ref_sums = (out.served, out.dropped, out.backlog, out.served_cost)
        w_a, w_c = torch.autograd.grad(
            sum((g_[k] * v).sum() for k, v in enumerate(ref_sums)),
            [at2, ct2])
        torch.cuda.synchronize()
        auto_s = time.perf_counter() - t0
        ref_sums = [s.detach() for s in ref_sums]
        err = {"fwd": _max_err(sums, ref_sums, scaled=True),
               "bwd": _max_err([d_a, d_c], [w_a, w_c], scaled=True),
               "fwd_abs": _max_err(sums, ref_sums),
               "bwd_abs": _max_err([d_a, d_c], [w_a, w_c])}
        if dtype == torch.float64:
            if err["fwd"] > 1e-10 or err["bwd"] > 1e-10:
                raise AssertionError(f"soft ledger float64: forward "
                                     f"{err['fwd']:.3g}, backward "
                                     f"{err['bwd']:.3g} from plain autograd "
                                     "(gate 1e-10 of max(1, the output's "
                                     "largest entry))")
        else:
            for x, y in zip(sums, ref_sums):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-3)
            if err["bwd"] > 1e-4:
                raise AssertionError(f"soft ledger float32: d cap / d "
                                     f"demand {err['bwd']:.3g} from plain "
                                     "autograd (gate 1e-4 of max(1, the "
                                     "gradient's largest entry))")
        soft_err[dtype] = err
        print(f"[ledger] soft ledger {sb} x {st} h, d {sd}, {dtype}: max "
              f"|kernel - plain| / max(1, max |plain|) forward "
              f"{err['fwd']:.3g}, d cap and d demand against autograd "
              f"{err['bwd']:.3g} (gate "
              f"{'1e-10' if dtype == torch.float64 else '1e-4'}); max "
              f"|kernel - plain| forward {err['fwd_abs']:.3g}, backward "
              f"{err['bwd_abs']:.3g} (plain autograd {auto_s:.2f} s)")

    # the hard float64 forward at the live replay's shape (32 draws x 96 h
    # against one [T] capacity): bit for bit on integer-valued work,
    # within 1e-10 of max(1, each sum's largest entry) on sampled demand
    rg, rt = LIVE_REPLAY_SHAPE
    lw = Workload(n_draws=rg, seed=cfg["seed"])
    rk = dict(deadline=lw.deadline_h, bound=lw.queue_bound_mwh)
    cases = {"integer": (
        torch.as_tensor(rng.integers(0, 6, (rg, rt)).astype(np.float64),
                        device=dev),
        torch.as_tensor(rng.integers(0, 8, rt).astype(np.float64),
                        device=dev)), "sampled": (
        torch.as_tensor(lw.sample_demand_mw(rt), device=dev),
        torch.as_tensor(rng.uniform(0.0, 2.0, rt), device=dev))}
    hard64 = {}
    for label, (dr, cap) in cases.items():
        x = qs.queue_scan(dr, cap, **rk)
        y = qs.queue_scan(dr, cap, use_kernel=False, **rk)
        hard64[label] = _max_err(list(x), list(y))
        if label == "integer" and not all(torch.equal(u, v)
                                          for u, v in zip(x, y)):
            raise AssertionError("hard float64 queue_scan not bit for bit "
                                 "on integer work at the live replay's "
                                 "shape")
        if _max_err(list(x), list(y), scaled=True) > 1e-10:
            raise AssertionError(f"hard float64 queue_scan ({label}): "
                                 f"{hard64[label]:.3g} from the plain loop")
    print(f"[ledger] hard float64 queue_scan (soft_ledger_fwd, hard) {rg} "
          f"draws x {rt} h, d {lw.deadline_h}: integer work bit for bit; "
          f"sampled demand max |kernel - plain| {hard64['sampled']:.3g} "
          f"(gate 1e-10 of max(1, the largest sum))")

    # times: the kernels (device only, L2 flushed), their plain versions
    # once, the bounds and the one-lane serial floor
    def hard_call(use_kernel=True, **extra):
        return qs.workload_ledger_fwd(*args, use_kernel=use_kernel,
                                      **{**kw, **extra})
    one = [x[:1] for x in args[1:5]] + [dem[:1], args[6][:1]]
    one_idx = grid.market_idx[:1].contiguous()
    times = {}
    hb = _ledger_bound("hard", b, t, d, g=g, n=grid.n_markets)
    times["workload_ledger_fwd"] = {
        "ms": _cuda_ms(hard_call, runs=5, flush=flush, device_only=True),
        "plain_ms": _host_ms(lambda: hard_call(False), 1),
        "floor_ms": _cuda_ms(lambda: qs.workload_ledger_fwd(
            grid.prices, *one[:4], one[4], one[5], deadline=d,
            bound=wl.queue_bound_mwh, market_idx=one_idx), runs=3,
            device_only=True),
        "telemetry_ms": _cuda_ms(lambda: hard_call(hourly=True), runs=3,
                                 flush=flush, device_only=True),
        "bound": hb}
    a32, c32 = a64.float(), c64.float()
    tau32 = torch.tensor([tau], dtype=torch.float32, device=dev)
    fwd_out = qs.soft_ledger_fwd(a32, c32, tau32, deadline=sd, bound=4.0)
    g32 = gg64.float().contiguous()

    def fwd(a_=a32, c_=c32, use_kernel=True):
        return qs.soft_ledger_fwd(a_, c_, tau32, deadline=sd, bound=4.0,
                                  use_kernel=use_kernel)

    def bwd(use_kernel=True, hist=fwd_out[1]):
        return qs.soft_ledger_bwd(a32, c32, tau32, hist, g32, deadline=sd,
                                  bound=4.0, want_demand=False,
                                  use_kernel=use_kernel)
    plain_hist = fwd(use_kernel=False)[1]
    a1, c1 = a32[:1].contiguous(), c32[:1].contiguous()
    times["soft_ledger_fwd"] = {
        "ms": _cuda_ms(fwd, runs=5, flush=flush, device_only=True),
        "plain_ms": _host_ms(lambda: fwd(use_kernel=False), 1),
        "floor_ms": _cuda_ms(lambda: fwd(a1, c1), runs=3,
                             device_only=True),
        "bound": _ledger_bound("fwd", sb, st, sd)}
    hist1 = fwd(a1, c1)[1]
    times["soft_ledger_bwd"] = {
        "ms": _cuda_ms(bwd, runs=5, flush=flush, device_only=True),
        "plain_ms": _host_ms(lambda: bwd(False, plain_hist), 1),
        "floor_ms": _cuda_ms(lambda: qs.soft_ledger_bwd(
            a1, c1, tau32, hist1, g32[:, :1].contiguous(), deadline=sd,
            bound=4.0, want_demand=False), runs=3, device_only=True),
        "bound": _ledger_bound("bwd", sb, st, sd)}
    for name, tm in times.items():
        ms, by, nbytes = tm["bound"]
        shape = (f"{b} x {t} h x {g} draws" if name == "workload_ledger_fwd"
                 else f"{sb} x {st} h")
        print(f"[time] {name} {shape}, d {d if name[0] == 'w' else sd}: "
              f"kernel {tm['ms']:.4f} ms (L2 flushed), plain "
              f"{tm['plain_ms']:.1f} ms, bound {ms:.5f} ms ({by}; "
              f"{nbytes / 1e6:.2f} MB), {ms / tm['ms']:.2%} of bound; "
              f"serial floor (one lane, the same hours) "
              f"{tm['floor_ms']:.4f} ms"
              + (f"; with telemetry {tm['telemetry_ms']:.4f} ms"
                 if "telemetry_ms" in tm else ""))
    # the kernels line's errors: those of the forms timed and counted (the
    # hard ledger; the soft pair in float32), the float64 checks beside
    f32, f64 = soft_err[torch.float32], soft_err[torch.float64]
    return {"times": times, "errs": {
        "workload_ledger_fwd": {"max_abs_err": hard_err},
        "soft_ledger_fwd": {
            "max_abs_err": f32["fwd_abs"], "max_scaled_err": f32["fwd"],
            "float64_max_scaled_err": f64["fwd"],
            "hard_float64_max_abs_err": hard64["sampled"]},
        "soft_ledger_bwd": {
            "max_abs_err": f32["bwd_abs"], "max_scaled_err": f32["bwd"],
            "float64_max_scaled_err": f64["bwd"]}}}


def phase_faults_workload(dev) -> None:
    """`bench_faults` and `bench_workload` end to end at their shape (256
    rows x 4096 h): the zero-fault `faulted_backtest` equal to `backtest`
    bit for bit, the masked path on identity masks with the same start
    counts and sums within rtol 1e-5, a `random_storm(7, ...)` run on the
    card against the CPU (start counts exact, CPC within rtol 1e-5); the
    workload-coupled backtest's report equal to `backtest` bit for bit,
    one `fleet_scan` and one `workload_ledger_fwd` launch a call, its
    results under telemetry equal bit for bit; wall times (synchronised)
    of each, twice after a warm-up."""
    import tempfile

    from repro_torch import obs
    from repro_torch.faults import (faulted_backtest, identity_masks,
                                    random_storm)
    from repro_torch.fleet import backtest
    from repro_torch.workload import Workload, workload_backtest

    cfg = LEDGER_BENCH
    _, grid = _bench_grid(cfg["n_markets"], cfg["n_systems"], dev,
                          hours=cfg["hours"])
    b, n, t = grid.n_rows, grid.n_markets, grid.n_hours
    plain = backtest(grid, device=dev)

    def same(label, got):
        for f in plain._fields:
            if not torch.equal(getattr(got, f), getattr(plain, f)):
                raise AssertionError(f"{label}: {f} differs from backtest")

    same("faulted_backtest (no faults)", faulted_backtest(grid, device=dev))
    same("faulted_backtest (identity masks)",
         faulted_backtest(grid, identity_masks(b, n, t), device=dev))
    masked = faulted_backtest(grid, identity_masks(b, n, t),
                              _force_masked=True, device=dev)
    if not torch.equal(masked.n_starts, plain.n_starts):
        raise AssertionError("masked path on identity masks: starts differ")
    torch.testing.assert_close(masked.cpc, plain.cpc, rtol=1e-5, atol=0.0)
    storm = random_storm(7, b, n, t)
    hit = faulted_backtest(grid, storm, device=dev)
    hit_cpu = faulted_backtest(grid.to("cpu"), storm, device="cpu")
    if not torch.equal(hit.n_starts.cpu(), hit_cpu.n_starts):
        raise AssertionError("faulted_backtest: card and CPU starts differ")
    torch.testing.assert_close(hit.cpc.cpu(), hit_cpu.cpc, rtol=1e-5,
                               atol=0.0)

    def wall(fn, runs=2):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out
    w_plain = wall(lambda: backtest(grid, device=dev))
    w_storm = wall(lambda: faulted_backtest(grid, storm, device=dev))
    w_masked = wall(lambda: faulted_backtest(
        grid, identity_masks(b, n, t), _force_masked=True, device=dev))
    print(f"[faults] {b} rows x {t} h: zero-fault faulted_backtest == "
          f"backtest bit for bit; masked identity: starts equal, CPC "
          f"within rtol 1e-5; storm ({len(storm)} faults) card == CPU "
          f"starts, CPC rtol 1e-5, mean CPC "
          f"{float(plain.cpc.mean()):.4f} -> {float(hit.cpc.mean()):.4f}; "
          f"wall s: healthy {w_plain}, storm {w_storm}, masked identity "
          f"{w_masked}")

    wl = Workload(n_draws=cfg["n_draws"], seed=cfg["seed"])
    counters = _zero_counters()
    run = workload_backtest(grid, wl, device=dev)
    torch.cuda.synchronize()
    launched = {k: counters[k].launches
                for k in ("fleet_scan", "workload_ledger_fwd")}
    if launched != {"fleet_scan": 1, "workload_ledger_fwd": 1}:
        raise AssertionError(f"workload_backtest launched {launched}")
    same("workload_backtest's report", run.report)
    with tempfile.TemporaryDirectory() as tmp:
        with obs.capture(tmp):
            on = workload_backtest(grid, wl, device=dev)
    same("workload_backtest's report under telemetry", on.report)
    for f in run.workload._fields:
        if not torch.equal(getattr(on.workload, f),
                           getattr(run.workload, f)):
            raise AssertionError(f"workload_backtest: {f} differs with "
                                 "telemetry on")
    w_wl = wall(lambda: workload_backtest(grid, wl, device=dev))
    res = run.workload
    drop = float(res.dropped_mwh.sum() / res.arrivals_mwh.sum())
    print(f"[workload] {b} rows x {t} h x {wl.n_draws} draws (d "
          f"{wl.deadline_h}, bound {wl.queue_bound_mwh:g} MWh): report == "
          f"backtest bit for bit, one fleet_scan and one "
          f"workload_ledger_fwd launch a call, telemetry on == off bit for "
          f"bit; CPC p50 mean {float(res.cpc_p50.mean()):.4f}, drop "
          f"fraction {drop:.4f}; "
          f"wall s: coupled {w_wl} against plain {w_plain}")


def phase_slice_examples(dev) -> dict:
    """`chaos_fleet` and `workload_fleet` at full size on the card (16 and
    12 rows x 2190 h; 32 draws, 200 tuner steps, the live surge over 96 h
    at 3 sites; the chaos storm and the live storm over 2022 h): wall
    seconds and exit status (both must PASS, exit 0). Every kernel's
    count is set to 0 just before `workload_fleet` and read just after:
    the ledger kernels' launches on the main path."""
    from repro_torch.examples import chaos_fleet, workload_fleet

    t0 = time.perf_counter()
    rc = chaos_fleet.main(["--device", str(dev)])
    torch.cuda.synchronize()
    print(f"[examples] chaos_fleet (full storm) exit {rc}, "
          f"{time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError(f"chaos_fleet: exit {rc}")
    counters = _zero_counters()
    t0 = time.perf_counter()
    rc = workload_fleet.main(["--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    device = {k: fn.device_launches for k, fn in counters.items()}
    print(f"[examples] workload_fleet (full size) exit {rc}, {secs:.2f} s; "
          "kernel calls (kernels on the card): "
          + ", ".join(f"{k} {launches[k]} ({device[k]})" for k in launches
                      if launches[k] or device[k]))
    if rc != 0:
        raise AssertionError(f"workload_fleet: exit {rc}")
    for k in LEDGER_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"workload_fleet launched no {k}")
    return {"launches": launches, "device_launches": device}


def _ledger_records(ledger: dict, examples: dict) -> list[dict]:
    """The ledger kernels' entries of the ``kernels`` line: errors and
    times from `phase_ledger_vs_plain`, launches from the full-size
    `workload_fleet` run."""
    recs = []
    for name, tm in ledger["times"].items():
        ms, by, _ = tm["bound"]
        recs.append({
            "name": name, "route": "cuda", "source": LEDGER_SOURCE,
            "replaces": LEDGER_REPLACES,
            "launches": examples["launches"][name],
            **ledger["errs"][name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": ms, "bound_by": by,
            "library_ms": None, "serial_floor_ms": tm["floor_ms"]})
    return recs


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


def _fleet_bound(b: int, t: int, n: int | None = None
                 ) -> tuple[float, str, int]:
    """Least time for `fleet_scan` on an H100 SXM: each input read once
    (with ``n`` markets, the [N, T] block, the int64 index and the four
    [B] parameters; without, the [B, T] block and the parameters) and the
    [4, B] sums written once, at 3.35 TB/s; 10 float32 operations a
    row-hour (compares, selects, adds) at 67 TFLOP/s. Returns (ms, what
    bounds it, bytes)."""
    nbytes = (n * t * 4 + b * (8 + 16) if n is not None
              else b * t * 4 + b * 16) + b * 16
    tb, to = nbytes / HBM_BYTES_PER_S, 10 * b * t / FP32_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations", nbytes


def phase_times(dev, main: dict) -> tuple[dict, torch.Tensor]:
    from repro_torch.energy.markets import generate_markets
    from repro_torch.fleet import backtest
    from repro_torch.kernels.fleet_scan import fleet_scan

    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32,
                        device=dev)          # 128 MB > the 50 MB L2

    def fleet_times(grid, plain_runs: int = 0) -> dict:
        """The kernel (device only) on ``grid``'s markets through its
        index, L2 flushed and L2-hot, and on the gathered [B, T] block,
        L2 flushed; the plain version (gather and `fleet_scan_ref`) on the
        same inputs where ``plain_runs``."""
        args = (grid.prices, grid.p_on, grid.p_off, grid.off_level,
                grid.idle_frac)
        mi = grid.market_idx
        rows = grid.prices[mi].contiguous()

        def call():
            fleet_scan(*args, market_idx=mi, use_kernel=True)
        out = {"ms": _cuda_ms(call, runs=20, flush=flush, device_only=True),
               "hot_ms": _cuda_ms(call, runs=20, device_only=True),
               "gathered_ms": _cuda_ms(
                   lambda: fleet_scan(rows, *args[1:], use_kernel=True),
                   runs=20, flush=flush, device_only=True),
               "plain_ms": _cuda_ms(
                   lambda: fleet_scan(*args, market_idx=mi,
                                      use_kernel=False),
                   runs=plain_runs) if plain_runs else None}
        b, (n, t) = grid.n_rows, grid.prices.shape
        out["bound"], out["gathered_bound"] = (_fleet_bound(b, t, n),
                                               _fleet_bound(b, t))
        bd, gb = out["bound"], out["gathered_bound"]
        print(f"[time] fleet_scan {b}x{t} through market_idx ({n} "
              f"markets): kernel {out['ms']:.4f} ms (L2 flushed; "
              f"{out['hot_ms']:.4f} ms L2-hot)"
              + (f", plain {out['plain_ms']:.2f} ms" if plain_runs else "")
              + f", bound {bd[0]:.5f} ms ({bd[1]}: {bd[2] / 1e6:.2f} MB, "
              f"{10 * b * t / 1e9:.3f} GFLOP at 67 TFLOP/s), "
              f"{bd[0] / out['ms']:.1%} of bound; gathered [B, T] "
              f"{out['gathered_ms']:.4f} ms (L2 flushed), its bound "
              f"{gb[0]:.4f} ms ({gb[1]}: {gb[2] / 1e6:.1f} MB at 3.35 TB/s)")
        return out

    grid = main["grid"]
    main_t = fleet_times(grid, plain_runs=3)
    # the tuner's hard re-scoring takes the [B, T] form at its 256 x 2190
    tune = _scan_inputs(256, 2190, seed=400, dev=dev)
    tune_ms = _cuda_ms(lambda: fleet_scan(*tune, use_kernel=True), runs=20,
                       flush=flush, device_only=True)
    tb = _fleet_bound(256, 2190)
    print(f"[time] fleet_scan 256x2190 gathered [B, T] (the tuner's "
          f"re-scoring): kernel {tune_ms:.4f} ms (L2 flushed), bound "
          f"{tb[0]:.5f} ms ({tb[1]}: {tb[2] / 1e6:.2f} MB at 3.35 TB/s), "
          f"{tb[0] / tune_ms:.1%} of bound")

    e2e_ms = _cuda_ms(lambda: backtest(grid, device=dev))
    print(f"[time] backtest {grid.n_rows} rows x {grid.n_hours} h: "
          f"{e2e_ms:.3f} ms, {grid.n_rows / (e2e_ms / 1e3):.4g} rows/s")
    gen_ms = _cuda_ms(lambda: generate_markets(main["markets"], device=dev),
                      runs=5)
    print(f"[time] market generation (setup) {len(main['markets'])} x "
          f"{grid.n_hours} h: {gen_ms:.1f} ms")

    markets, big = _bench_grid(64, 16, dev)
    big_ms = _cuda_ms(lambda: backtest(big, device=dev))
    print(f"[time] backtest {big.n_rows} rows x {big.n_hours} h "
          f"({big.n_markets} markets read through market_idx): "
          f"{big_ms:.3f} ms, {big.n_rows / (big_ms / 1e3):.4g} rows/s")
    fleet_times(big)
    gen64_ms = _cuda_ms(lambda: generate_markets(markets, device=dev),
                        runs=5)
    print(f"[time] market generation (setup) {len(markets)} x "
          f"{big.n_hours} h: {gen64_ms:.1f} ms")

    _profile(lambda: backtest(grid, device=dev),
             f"backtest {grid.n_rows} rows")
    bound_ms, bound_by, _ = main_t["bound"]
    return {
        "name": "fleet_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_scan.cu",
        "replaces": "src/repro/kernels/fleet_scan.py:40",
        "launches": main["launches"]["fleet_scan"],
        "max_abs_err": main["max_abs_err"], "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }, flush


def _chain_ns(name: str, lo: int, hi: int, dev, *extra) -> float:
    """Latency of one step of the probe library's chain ``name`` on the
    card, in ns: the difference of two chains (``lo`` and ``hi`` steps)
    timed by CUDA events."""
    import ctypes

    fn = getattr(ctypes.CDLL(str(PROBE_DIR / "libf64_add_chain.so")), name)
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * (1 + len(extra)) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.ones(32, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chain(n):
        if fn(buf.data_ptr(), n, *extra, stream) != 0:
            raise RuntimeError(f"{name} launch failed")

    ms = {n: _cuda_ms(lambda: chain(n), runs=5) for n in (lo, hi)}
    return (ms[hi] - ms[lo]) * 1e6 / (hi - lo)


def _f64_add_ns(dev) -> float:
    """Latency of one dependent float64 addition on the card, in ns: the
    difference of two chains (1.1e6 and 1e5 additions) in one thread,
    timed by CUDA events."""
    return _chain_ns("f64_add_chain", 100_000, 1_100_000, dev)


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


def phase_dispatch_times(dev, flush, problem, example) -> dict:
    """The dispatch kernel (device only, L2 flushed) at S x 8760 for S in
    1, 8, 64 and 512, each run also held bit for bit against the plain
    mirror of its walk (`dispatch_cut_ref`, on the host), which counts the
    sorted positions the walk sums each hour before it stops at the demand;
    beside its bytes bound and the serial floor of its design: the walked
    positions times a dependent float64 addition, plus two block barriers
    an hour above 32 sites (one warp runs the hour at 32 or fewer); the
    floor of the design before it (T x 3S additions) for comparison; the
    plain version (on the CPU) at 8 and 64 sites. Then the same on the
    six instances of the `fleet_dispatch` example (``example``: the inputs
    phase 7's counted run gave the kernel), and the counted path's kernel
    time: those six and the 64-site instance. Last, one whole 64-site
    `dispatch` call split into the host segment sort, the kernel and
    `summarize_alloc`."""
    from repro_torch.dispatch import dispatch, segment_rank, summarize_alloc
    from repro_torch.kernels.dispatch_scan import dispatch_scan
    from repro_torch.kernels.ref import dispatch_cut_ref

    add_ns = _f64_add_ns(dev)
    print(f"[time] dependent float64 addition on the card: {add_ns:.3f} ns")
    cases = []
    for s in (1, 8, 64, 512):
        prob = problem if s == 64 \
            else _random_dispatch(s, 8760, 5.0, 4, 600 + s)
        cases.append((s, f"{s} x {prob.avail_mw.shape[1]}",
                      [torch.as_tensor(np.ascontiguousarray(a)) for a in
                       (prob.avail_mw, prob.rank, prob.demand_mw)],
                      prob.min_dwell_h))
    for k, (args, dwell) in enumerate(example):
        s, t = args[0].shape
        cases.append((f"example {k}", f"{s} x {t}, fleet_dispatch "
                      f"instance {k + 1} of {len(example)}, dwell {dwell}",
                      [a.cpu() for a in args], dwell))
    out = {}
    for key, label, cpu_args, dwell in cases:
        s, t = cpu_args[0].shape
        args = [a.to(dev) for a in cpu_args]

        def kernel():
            return dispatch_scan(*args, min_dwell=dwell)

        want, walked = dispatch_cut_ref(*cpu_args, min_dwell=dwell)
        if not torch.equal(kernel().cpu(), want):
            raise AssertionError(f"dispatch_scan {label}: kernel differs "
                                 "from the mirror of its walk")
        ms = _cuda_ms(kernel, runs=5, flush=flush, device_only=True)
        bound, by = _dispatch_bound(s, t)
        threads = min(-(-s // 32) * 32, 1024)
        bar_ns = _barrier_ns(dev, threads) if s > 32 else 0.0
        n_bar = 2 if s > 32 else 0
        walked_sum = int(walked.sum())
        serial = (walked_sum * add_ns + t * n_bar * bar_ns) * 1e-6
        old = t * 3 * s * add_ns * 1e-6
        rec = {"ms": ms, "bound_ms": bound, "bound_by": by,
               "serial_ms": serial, "plain_ms": None,
               "walked": walked_sum / (t * 3 * s)}
        if key in (8, 64):
            rec["plain_ms"] = _host_ms(
                lambda: dispatch_scan(*cpu_args, min_dwell=dwell), runs=2)
        out[key] = rec
        print(f"[time] dispatch_scan {label}: kernel {ms:.4f} ms "
              f"({ms * 1e6 / t:.1f} ns per hour), plain "
              + (f"{rec['plain_ms']:.1f} ms" if rec["plain_ms"] else "—")
              + f", bound {bound:.4f} ms ({by}); the walk sums "
              f"{walked_sum / t:.1f} of {3 * s} positions an hour "
              f"({rec['walked']:.3f} of 3S); serial floor of the design "
              f"{serial:.4f} ms (walked positions x {add_ns:.3f} ns"
              + (f" + {n_bar} x {bar_ns:.2f} ns barriers an hour" if n_bar
                 else ", one warp") + f"), {serial / ms:.1%} of it; the "
              f"previous design's floor {old:.4f} ms (T x 3S additions); "
              f"{bound / ms:.2%} of the bytes bound")
    inst = [out[f"example {k}"]["ms"] for k in range(len(example))]
    print(f"[time] dispatch_scan on the counted path: {sum(inst):.4f} ms "
          f"on the example's {len(inst)} instances + {out[64]['ms']:.4f} ms "
          f"at 64 sites = {sum(inst) + out[64]['ms']:.4f} ms")

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


def _warp_sum_ns(dev) -> float:
    """Latency of one dependent float64 warp butterfly sum (five shuffle +
    add steps, and the probe's one multiply) on the card, in ns."""
    return _chain_ns("warp_sum_chain", 20_000, 200_000, dev)


def _barrier_ns(dev, threads: int) -> float:
    """Latency of one block barrier of ``threads`` threads on the card,
    every thread arriving at once, in ns."""
    return _chain_ns("barrier_chain", 20_000, 200_000, dev, threads)


def _soft_dispatch_bound(s: int, t: int, kernel: str,
                         n_bisect: int = 30) -> tuple[float, str]:
    """Least time for the function on an H100 SXM. Bytes, each input read
    once and each output written once: the forward reads avail, keys,
    order and demand and writes the allocation (32 S T + 4 T; the fused
    forward also the entering dwell and the level, 36 S T + 8 T); the
    backward as the tuner runs it (no d keys) reads avail, keys, demand,
    alloc, dwell-in, level and the cotangent and writes d avail and
    d demand (32 S T + 12 T). Operations: ~12 float32 operations per
    segment evaluation, 3 S segments, n_bisect + 2 evaluations an hour
    forward, ~60 per segment backward, against 67 TFLOP/s."""
    if kernel == "bwd":
        nbytes, ops = 32 * s * t + 12 * t, 60 * 3 * s * t
    else:
        nbytes = 32 * s * t + 4 * t if kernel == "fwd" \
            else 36 * s * t + 8 * t
        ops = 12 * 3 * s * t * (n_bisect + 2)
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def _soft_dispatch_floors(s: int, t: int, kernel: str, red_ns: float,
                          bar_ns: float, n_bisect: int = 30) -> dict:
    """The serial floors of a soft-dispatch kernel at S x T, in ms. The
    forward's: T x ((rounds + 2) x the warp sum + rounds x the block
    barrier), rounds = ceil(n_bisect / k) bisection rounds of k levels (the
    kernel's own k at S sites) and the Newton step's two sums; the design
    before it, one bisection step a sum, took T x (n_bisect + 3) = T x 33
    warp sums. The backward's chain: T x 2 warp sums (the design before
    it, which recomputed the Newton step and the fill each hour: T x 4)."""
    if kernel == "bwd":
        return {"floor_ms": t * 2 * red_ns * 1e-6,
                "floor": "T x 2 warp sums",
                "one_step_floor_ms": t * 4 * red_ns * 1e-6}
    from repro_torch.kernels.soft_dispatch import _library

    k = _library().soft_dispatch_fwd_levels(s)
    rounds = -(-n_bisect // k)
    return {"floor_ms": t * ((rounds + 2) * red_ns + rounds * bar_ns) * 1e-6,
            "floor": f"T x ({rounds} + 2 warp sums + {rounds} barriers), "
                     f"k = {k}",
            "one_step_floor_ms": t * (n_bisect + 3) * red_ns * 1e-6}


def phase_soft_dispatch_times(dev, flush, big) -> dict:
    """The three soft-dispatch kernels (device only, L2 flushed) at the
    tuner's 32 x 2190 (tau 3, dwell 4) and at the soft -> hard phase's
    64 x 8760 (its problem, tau and dwell, ``big``), beside their bytes
    bound and the serial floors of the design and of the one-step design
    before it (see
    `_soft_dispatch_floors`); the plain versions on the host at 32 x 2190,
    and the forward's at 64 x 8760 (one run each). That plain run's
    allocation holds the main path's (the forward kernel's at 64 x 8760)
    within SD_TOL["alloc"], and the fused forward's allocation there
    equals it bit for bit. Returns the rows by shape, with the forward
    kernel's error at 64 x 8760."""
    from repro_torch.kernels.ref import (soft_dispatch_bwd_ref,
                                         soft_dispatch_fwd_ref,
                                         soft_dispatch_ref)
    from repro_torch.kernels.soft_dispatch import (_library,
                                                   soft_dispatch_fused_bwd,
                                                   soft_dispatch_fused_fwd,
                                                   soft_dispatch_scan)

    red_ns = _warp_sum_ns(dev)
    print(f"[time] dependent float64 warp sum on the card: {red_ns:.2f} ns")
    out = {}
    for label, s, t in (("32 x 2190", 32, 2190), ("64 x 8760", 64, 8760)):
        if s == 64:
            tau, dwell = big["tau"], big["min_dwell"]
            avail, keys, order, demand = big["args"]
            g = torch.ones_like(avail)
            cpu = [x.cpu() for x in (avail, keys, order, demand, g)]
        else:
            tau, dwell = 3.0, 4
            cpu = _soft_dispatch_case(s, t, 5.0, seed=1)
            avail, keys, order, demand, g = (x.to(dev) for x in cpu)
        threads = _library().soft_dispatch_fwd_threads(s)
        bar_ns = _barrier_ns(dev, threads)
        print(f"[time] block barrier of {threads} threads on the card: "
              f"{bar_ns:.2f} ns")
        it, itm = _inv_taus(tau)
        itd, itmd = it.to(dev), itm.to(dev)
        alloc, dwin, lam = soft_dispatch_fused_fwd(avail, keys, order,
                                                   demand, itd, itmd,
                                                   min_dwell=dwell)
        kept = {}

        def plain_fwd():
            kept["alloc"] = soft_dispatch_ref(*cpu[:4], tau=tau,
                                              min_dwell=dwell)
        fns = {
            "fwd": (lambda: soft_dispatch_scan(avail, keys, order, demand,
                                               tau=tau, min_dwell=dwell),
                    plain_fwd),
            "fused_fwd": (lambda: soft_dispatch_fused_fwd(
                avail, keys, order, demand, itd, itmd, min_dwell=dwell),
                lambda: soft_dispatch_fwd_ref(*cpu[:4], it, itm,
                                              min_dwell=dwell)),
            "bwd": (lambda: soft_dispatch_fused_bwd(
                avail, keys, demand, itd, itmd, alloc, dwin, lam, g,
                min_dwell=dwell, want_dkeys=False),
                lambda: soft_dispatch_bwd_ref(
                    cpu[0], cpu[1], cpu[3], it, itm, alloc.cpu(),
                    dwin.cpu(), lam.cpu(), cpu[4], min_dwell=dwell,
                    want_dkeys=False))}
        rows = {}
        for name, (kernel, plain) in fns.items():
            ms = _cuda_ms(kernel, runs=3, flush=flush, device_only=True)
            plain_ms = _host_ms(plain, runs=1) \
                if s == 32 or name == "fwd" else None
            bound, by = _soft_dispatch_bound(s, t, name)
            fl = _soft_dispatch_floors(s, t, name, red_ns, bar_ns)
            rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, **fl}
            print(f"[time] soft_dispatch {name} {label} (tau {tau}, dwell "
                  f"{dwell}): kernel {ms:.3f} ms "
                  f"({ms * 1e6 / t:.0f} ns per hour), plain "
                  + (f"{plain_ms:.1f} ms (host)" if plain_ms else "—")
                  + f", bound {bound:.4f} ms ({by}), {bound / ms:.3%} of the "
                  f"bound; serial floor of the design {fl['floor_ms']:.3f} "
                  f"ms ({fl['floor']}), {fl['floor_ms'] / ms:.1%} of it; "
                  f"the one-step design's floor "
                  f"{fl['one_step_floor_ms']:.3f} ms")
        if s == 64:
            if not torch.equal(alloc, big["soft"]):
                raise AssertionError("soft_dispatch 64 x 8760: the fused "
                                     "forward's allocation differs from the "
                                     "forward kernel's")
            rows["fwd"]["max_abs_err"] = _err(big["soft"], kept["alloc"])
            print(f"[kernel] soft_dispatch 64 x 8760, tau {tau}, dwell "
                  f"{dwell} (the soft -> hard run): max |kernel - plain| "
                  f"alloc {rows['fwd']['max_abs_err']:.3g} MW; kernel 5 == "
                  "kernel 6 bitwise")
            if rows["fwd"]["max_abs_err"] > SD_TOL["alloc"]:
                raise AssertionError(
                    f"soft_dispatch 64 x 8760: the main path's allocation is "
                    f"off the plain version's by "
                    f"{rows['fwd']['max_abs_err']:.3g} > {SD_TOL['alloc']}")
        out[label] = rows
    return out


def phase_aware_step_times(dev, grid, steps: int = 50) -> None:
    """`tune_loop` at 256 x 2190 with the dispatch term against the same
    loop without it, in turns within this call (coupled, uncoupled,
    uncoupled, coupled), per step; and the device's busy share over a
    profiled 10-step coupled loop. The coupled loop runs the config
    `optimize` runs on the main path (`Coupling(dispatch=)` at dwell 4, so
    the dwell-locked kernels)."""
    from repro_torch.dispatch import DispatchConfig
    from repro_torch.tune import (Coupling, TuneConfig,
                                  dispatch_coupling_from_grid,
                                  init_from_grid, problem_from_grid,
                                  tune_loop)

    problem = problem_from_grid(grid)
    raw0 = init_from_grid(grid)
    dcfg = DispatchConfig(demand_frac=0.3, migrate_cost=5.0, min_dwell_h=4)
    coupling = dispatch_coupling_from_grid(grid, dcfg)
    runs = {"coupled": (coupling, TuneConfig(
                steps=steps, coupling=Coupling(dispatch=dcfg))),
            "uncoupled": (None, TuneConfig(steps=steps))}
    times = {k: [] for k in runs}
    for k in ("coupled", "uncoupled", "uncoupled", "coupled"):
        c, cfg = runs[k]
        times[k].append(_host_ms(lambda: tune_loop(raw0, problem, c,
                                                   cfg=cfg), runs=1))
    for k, v in times.items():
        ms = statistics.median(v) / steps
        print(f"[time] tune_loop {k} {grid.n_rows} rows x {grid.n_hours} h: "
              f"{ms:.2f} ms per step (runs of {steps} steps: "
              f"{', '.join(f'{x:.1f}' for x in v)} ms), "
              f"{grid.n_rows / (ms / 1e3):.4g} row-steps/s")
    _profile(lambda: tune_loop(raw0, problem, coupling,
                               cfg=TuneConfig(steps=10,
                                              coupling=Coupling(
                                                  dispatch=dcfg))),
             "dispatch-aware tune_loop 10 steps (dwell 4)", runs=1)


def _profile(fn, label: str, runs: int = 10) -> dict | None:
    """Device time by kernel and the card's busy share over ``runs``
    back-to-back calls of ``fn``, from `torch.profiler` (CUPTI). The
    profiler slows the host, so the busy share is a lower bound. Returns
    the busy share, the wall time and the device operations a run (None
    when the profiler saw no device time)."""
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
        return None
    print(f"[profile] {label} x {runs}: wall {wall_us / runs:.1f} us/run "
          f"under the profiler, device busy {busy_us / runs:.1f} us/run "
          f"({busy_us / wall_us:.1%})")
    for key, count, dev_us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"[profile]   {dev_us / runs:9.2f} us/run  "
              f"{count / runs:6.1f}x  {key[:70]}")
    return {"busy": busy_us / wall_us, "wall_us": wall_us / runs,
            "kernels": sum(r[1] for r in rows) / runs}


def _soft_records(errs: dict, times: dict, launches: dict) -> list[dict]:
    """The soft-scan kernels' entries of the ``kernels`` line, at the
    tuner's shape (256 x 2190; the backward as the tuner runs it, without
    d_p)."""
    e, t = errs[(256, 2190, 256)], times[(256, 2190)]
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


def _soft_dispatch_records(errs: dict, times: dict, launches: dict,
                           k5_launches: int) -> list[dict]:
    """The soft-dispatch kernels' entries of the ``kernels`` line: the
    forward kernel at its main path's 64 x 8760 (soft -> hard), the fused
    pair at the tuner's 32 x 2190 (the backward as the tuner runs it); the
    errors are the largest over the cases of `phase_soft_dispatch_vs_plain`
    and the main path's run at 64 x 8760 for the forward, over the
    tuner-shape cases for the fused pair."""
    src = "src/repro_torch/kernels/csrc/soft_dispatch.cu"
    tuner = [e for k, e in errs.items() if k.startswith("tuner shape")]
    recs = []
    for name, line, shape, key, launch, err in (
            ("soft_dispatch", 57, "64 x 8760", "fwd", k5_launches,
             max(times["64 x 8760"]["fwd"]["max_abs_err"],
                 *(e["k5"] for e in errs.values()))),
            ("soft_dispatch_fused_fwd", 226, "32 x 2190", "fused_fwd",
             launches["soft_dispatch_fused_fwd"],
             max(e["k6"] for e in tuner)),
            ("soft_dispatch_fused_bwd", 292, "32 x 2190", "bwd",
             launches["soft_dispatch_fused_bwd"],
             max(e["k7"] for e in tuner))):
        t = times[shape][key]
        recs.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/soft_dispatch.py:{line}",
            "launches": launch, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    return recs


# ---------------------------------------------------------------------------
# the serving path: flash and decode attention (kernels 8 and 9)
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the reference's
BF16 = torch.bfloat16
# B, Sq, Skv, H, G, Dh, causal, window, q_offset, dtype: the reference's
# FLASH_CASES and its bf16 case (tests/test_kernels.py), the serving shapes
# of qwen2.5-3b (16 heads in 2 KV groups, Dh 128) and a chunked prefill,
# the longest serving shape and the chunked prefill also at float32, where
# the tolerance (2e-5) is far below the outputs' size (~0.04 at 2048 keys),
# then the tensor-core (bf16) kernel at Dh 16 and 32, a window with an
# offset, a non-causal case and a window edge inside a tile, and last
# zamba2-1.2b's serving shapes (32 heads, each its own KV group, Dh 64) at
# bf16 and float32, whole tiles and ragged
FLASH_SMOKE_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0, torch.float32),
    (1, 100, 100, 8, 2, 64, True, 0, 0, torch.float32),
    (2, 64, 256, 4, 4, 32, False, 0, 0, torch.float32),
    (1, 128, 128, 4, 1, 64, True, 32, 0, torch.float32),
    (1, 16, 144, 4, 2, 64, True, 0, 128, torch.float32),
    (1, 128, 128, 4, 2, 64, True, 100, 0, torch.float32),
    (2, 96, 96, 6, 3, 128, True, 0, 0, torch.float32),
    (1, 64, 64, 4, 4, 64, True, 0, 0, BF16),
    (1, 128, 128, 16, 2, 128, True, 0, 0, BF16),
    (1, 1000, 1000, 16, 2, 128, True, 0, 0, BF16),
    (1, 2048, 2048, 16, 2, 128, True, 0, 0, BF16),
    (1, 256, 1280, 16, 2, 128, True, 0, 1024, BF16),
    (1, 2048, 2048, 16, 2, 128, True, 0, 0, torch.float32),
    (1, 256, 1280, 16, 2, 128, True, 0, 1024, torch.float32),
    (1, 130, 130, 16, 2, 16, True, 0, 0, BF16),
    (1, 70, 200, 16, 2, 32, True, 40, 130, BF16),
    (2, 64, 256, 4, 4, 32, False, 0, 0, BF16),
    (1, 128, 128, 4, 2, 64, True, 100, 0, BF16),
    (1, 1024, 1024, 32, 32, 64, True, 0, 0, BF16),
    (1, 1000, 1000, 32, 32, 64, True, 0, 0, BF16),
    (1, 1024, 1024, 32, 32, 64, True, 0, 0, torch.float32),
]
# B, H, G, Dh, W, dtype, mask: the reference's DECODE_CASES, then the
# serving pool (8 slots of 2048, 16 heads in 2 groups) with a linear
# cache's mask and a rolling one's, at bf16 and at float32 (eight 256-slot
# splits folded, and whole tiles and splits with no valid slot skipped),
# then the tensor-core (bf16) kernel at 1, 16 and 32 heads a group, and
# zamba2-1.2b's pool (8 slots of 2048, 32 heads each its own group, Dh 64:
# one real query row of the 16 an mma tile holds) at bf16 and float32
DECODE_SMOKE_CASES = [
    (2, 8, 2, 64, 100, torch.float32, "random"),
    (1, 4, 4, 32, 256, torch.float32, "random"),
    (3, 16, 2, 128, 77, torch.float32, "random"),
    (1, 4, 1, 64, 513, torch.float32, "random"),
    (8, 16, 2, 128, 2048, BF16, "linear"),
    (8, 16, 2, 128, 2048, BF16, "rolling"),
    (8, 16, 2, 128, 2048, torch.float32, "linear"),
    (8, 16, 2, 128, 2048, torch.float32, "rolling"),
    (2, 2, 2, 64, 300, BF16, "random"),
    (3, 32, 2, 128, 700, BF16, "random"),
    (2, 32, 1, 64, 1000, BF16, "random"),
    (8, 32, 32, 64, 2048, BF16, "linear"),
    (8, 32, 32, 64, 2048, BF16, "random"),
    (8, 32, 32, 64, 2048, torch.float32, "linear"),
]
SERVE_ARCH = "qwen2.5-3b"
SSM_ARCH = "mamba2-1.3b"
# the mamba2 run's fixed prompt lengths: one chunk, two, a ragged third,
# two whole, ragged ones, four chunks less 24 and four whole, and a prompt
# shorter than the conv (its conv tail is left-padded)
SSM_PROMPTS = (128, 256, 300, 512, 700, 1000, 1024, 2)
HYBRID_ARCH = "zamba2-1.2b"
# the zamba2 run's fixed prompt lengths: three shorter than the conv's K - 1
# = 3 inputs and K - 1 itself (the conv-tail path), and four whole chunks
HYBRID_PROMPTS = (1, 2, 3, 1024)
SERVE_REQUESTS, SERVE_MAX_NEW, SERVE_SEED = 16, 32, 0
# teacher-forced kernel vs plain logits at bf16, full width (PERF.md)
TF_STEPS, TF_MAX_ABS = 16, 0.25


def _attn_inputs(shapes, dtype, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in shapes]


def _flash_mask(sq, skv, causal, window, q_offset, dev):
    """[Sq, Skv] bool, True where query row i may see key j."""
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _decode_valid(b, w, kind, dev, seed):
    """[B, W] int8 slot validity: random (slot 0 always valid), a linear
    cache filled to a per-row length, or a rolling cache past its wrap
    with a 1500-position window."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        valid = rng.random((b, w)) > 0.3
        valid[:, 0] = True
    elif kind == "linear":
        lens = rng.integers(129, w + 1, b)
        valid = np.arange(w)[None] < lens[:, None]
    else:
        pos = rng.integers(w, 3 * w, b)
        pb = pos[:, None] - ((pos[:, None] - np.arange(w)[None]) % w)
        valid = (pb <= pos[:, None]) & (pb > pos[:, None] - 1500)
    return torch.as_tensor(valid, device=dev).to(torch.int8)


def _sdpa(q, k, v, mask=None, *, causal=False):
    """`torch.nn.functional.scaled_dot_product_attention` on the model's
    layout (the yardstick; the port never calls it). mask: broadcastable
    to [B, H, Sq, Skv] bool, True = attend."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               attn_mask=mask, is_causal=causal, enable_gqa=True)
    return out.transpose(1, 2)


def _sdpa_oracle(q, k, v, mask):
    """SDPA as an extra oracle: its math backend at float32 (full float32
    matrix products), its default backends at bf16."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if q.dtype == torch.float32:
        with sdpa_kernel([SDPBackend.MATH]):
            return _sdpa(q, k, v, mask)
    return _sdpa(q, k, v, mask)


def _attn_err(got, want, rows=None) -> float:
    d = (got.float() - want.float()).abs()
    if rows is not None:
        d = d[:, rows]
    return float(d.max())


def _attn_check(label, got, want, dtype, rows=None) -> float:
    tol = ATTN_TOL[dtype]
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[:, rows], w[:, rows]
    torch.testing.assert_close(g, w, atol=tol, rtol=tol, msg=label)
    return _attn_err(got, want, rows)


def phase_attention_vs_plain(dev) -> dict:
    """Kernels 8 and 9 against their plain (blocked) versions on the card
    and against SDPA, at the reference's cases and the serving shapes;
    rows with no visible key are checked for finiteness only (their
    output depends on the tiles a path visits)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import (decode_attention_plain,
                                         flash_attention_plain)

    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    for i, case in enumerate(FLASH_SMOKE_CASES):
        b, sq, skv, h, g, dh, causal, win, qo, dt = case
        q, k, v = _attn_inputs([(b, sq, h, dh), (b, skv, g, dh),
                                (b, skv, g, dh)], dt, dev, 500 + i)
        got = flash_attention(q, k, v, causal=causal, window=win,
                              q_offset=qo, use_kernel=True)
        plain = flash_attention_plain(q, k, v, causal=causal, window=win,
                                      q_offset=qo)
        mask = _flash_mask(sq, skv, causal, win, qo, dev)
        oracle = _sdpa_oracle(q, k, v, mask)
        torch.cuda.synchronize()
        rows = mask.any(-1)
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"flash {case}: non-finite output")
        e = _attn_check(f"flash {case} vs plain", got, plain, dt, rows)
        e_s = _attn_check(f"flash {case} vs SDPA", got, oracle, dt, rows)
        errs["flash_attention"] = max(errs["flash_attention"], e)
        print(f"[attn] flash B{b} Sq{sq} Skv{skv} H{h} G{g} Dh{dh} "
              f"causal={causal} window={win} q_offset={qo} {dt}: max |err| "
              f"vs plain {e:.3g}, vs SDPA {e_s:.3g}, plain vs SDPA "
              f"{_attn_err(plain, oracle, rows):.3g}")
    for i, case in enumerate(DECODE_SMOKE_CASES):
        b, h, g, dh, w, dt, kind = case
        q, k, v = _attn_inputs([(b, 1, h, dh), (b, w, g, dh),
                                (b, w, g, dh)], dt, dev, 600 + i)
        valid = _decode_valid(b, w, kind, dev, 700 + i)
        got = decode_attention(q, k, v, valid, use_kernel=True)
        plain = decode_attention_plain(q, k, v, valid)
        oracle = _sdpa_oracle(q, k, v, valid.bool()[:, None, None, :])
        torch.cuda.synchronize()
        e = _attn_check(f"decode {case} vs plain", got, plain, dt)
        e_s = _attn_check(f"decode {case} vs SDPA", got, oracle, dt)
        errs["decode_attention"] = max(errs["decode_attention"], e)
        print(f"[attn] decode B{b} H{h} G{g} Dh{dh} W{w} {dt} {kind} "
              f"({int(valid.sum())} valid slots): max |err| vs plain "
              f"{e:.3g}, vs SDPA {e_s:.3g}")
    # strided, misaligned views (the kernels' 4-byte load path): q, k and
    # v cut from wider rows at an offset of one element
    for dt in (torch.float32, BF16):
        wide = _attn_inputs([(1, 200, 16, 129), (1, 200, 2, 129),
                             (1, 200, 2, 129)], dt, dev, 850)
        q, k, v = (x[..., 1:] for x in wide)
        got = flash_attention(q, k, v, causal=True, use_kernel=True)
        e = _attn_check(f"flash strided {dt}", got,
                        flash_attention_plain(q, k, v, causal=True), dt)
        valid = _decode_valid(1, 200, "random", dev, 851)
        got_d = decode_attention(q[:, :1], k, v, valid, use_kernel=True)
        e_d = _attn_check(f"decode strided {dt}", got_d,
                          decode_attention_plain(q[:, :1], k, v, valid), dt)
        errs["flash_attention"] = max(errs["flash_attention"], e)
        errs["decode_attention"] = max(errs["decode_attention"], e_d)
        print(f"[attn] strided views at a one-element offset, {dt}: max "
              f"|err| vs plain flash {e:.3g}, decode {e_d:.3g}")
    # rows with no visible key stay finite (the reference's
    # test_flash_fully_masked_rows_are_finite), and so does a decode row
    # whose every slot is invalid
    q, k, v = _attn_inputs([(1, 32, 2, 16)] * 3, torch.float32, dev, 800)
    out = flash_attention(q, k, v, causal=True, window=4, q_offset=1000)
    q, k, v = _attn_inputs([(2, 1, 16, 128), (2, 300, 2, 128),
                            (2, 300, 2, 128)], BF16, dev, 801)
    none = torch.zeros((2, 300), dtype=torch.int8, device=dev)
    out_d = decode_attention(q, k, v, none)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(out).all())
            and bool(torch.isfinite(out_d.float()).all())):
        raise AssertionError("attention: a fully masked row is not finite")
    print("[attn] fully masked flash rows and decode rows: finite")
    _check_ticket_counters()
    return errs


def _check_ticket_counters() -> None:
    """The decode kernel's ticket counters (one int32 buffer per device
    and stream) are all back at 0 after every call."""
    from repro_torch.kernels import decode_attention as dmod

    torch.cuda.synchronize()
    left = {k: int(buf.count_nonzero()) for k, buf in dmod._counters.items()}
    if any(left.values()):
        raise AssertionError(f"decode: ticket counters left nonzero {left}")
    print(f"[attn] decode ticket counters: {len(left)} buffer(s), all 0")


def _count_serving_plain_calls():
    """Call counters on every plain attention and SSD function a wrapper or
    the model could reach; returns (counts, restore)."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.models import ssm as ssm_mod

    targets = [(fmod, "flash_attention_plain"),
               (dmod, "decode_attention_plain"),
               (ref, "flash_attention_plain"),
               (ref, "decode_attention_plain"), (ref, "attention_ref"),
               (ref, "decode_attention_ref"), (smod, "ssd_scan_plain"),
               (ref, "ssd_scan_plain"), (ref, "ssd_ref"),
               (ssm_mod, "ssd_chunked")]
    counts = {f"{m.__name__.split('.')[-1]}.{n}": 0 for m, n in targets}
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def wrap(key, fn):
        def counted(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return counted
    for m, n, fn in saved:
        setattr(m, n, wrap(f"{m.__name__.split('.')[-1]}.{n}", fn))

    def restore():
        for m, n, fn in saved:
            setattr(m, n, fn)
    return counts, restore


def _serve_requests(cfg, fixed=()):
    """16 requests of SERVE_MAX_NEW new tokens: prompts of the ``fixed``
    lengths, then of 128-1024 tokens drawn from SERVE_SEED."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(SERVE_SEED)
    lens = list(fixed) + list(rng.integers(128, 1025,
                                           SERVE_REQUESTS - len(fixed)))
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab - 1,
                                               size=int(n)).astype(np.int32),
                    max_new=SERVE_MAX_NEW) for i, n in enumerate(lens)]


def _serve_expect(cfg) -> dict:
    """Each serving kernel's launches per (prefill, decode step): the dense
    family's flash and decode attention, the ssm family's SSD scan (its
    decode step is the plain recurrence), the hybrid family's SSD scan per
    Mamba2 layer and both attention kernels per application of its shared
    block."""
    if cfg.family == "ssm":
        return {"ssd_scan": (cfg.n_layers, 0)}
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.hybrid_attn_every
        return {"flash_attention": (n_apps, 0),
                "decode_attention": (0, n_apps),
                "ssd_scan": (cfg.n_layers, 0)}
    return {"flash_attention": (cfg.n_layers, 0),
            "decode_attention": (0, cfg.n_layers)}


def _describe(cfg) -> str:
    ssm = (f"{cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
           f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of P "
           f"{cfg.ssm_head_dim}, N {cfg.ssm_state}, chunk "
           f"{cfg.ssm_chunk}, conv {cfg.ssm_conv}")
    attn = (f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV groups, Dh "
            f"{cfg.resolved_head_dim}")
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return (f"{ssm}; one shared attention + MLP block ({attn}, d_ff "
                f"{cfg.d_ff}) after every {cfg.hybrid_attn_every} of them, "
                f"{cfg.n_layers // cfg.hybrid_attn_every} applications")
    return f"{cfg.n_layers} layers, d_model {cfg.d_model}, {attn}"


def phase_serving(dev, arch: str, fixed=(), profile_len: int = 576
                  ) -> dict:
    """The serving path at full width: `ServingEngine` on ``arch`` (bf16,
    random parameters drawn from SERVE_SEED on the CPU and copied to the
    card), 8 slots of 2048 positions, the price gate on (germany, Psi 2,
    oracle), 16 requests (prompts of the ``fixed`` lengths, the rest of
    128-1024 tokens) of 32 new tokens each, run until every request
    completes. The market is replayed from half an hour before its first
    hour above the threshold: the gate must close while admitted requests
    decode and others wait, and reopen. Launch counts and plain-call
    counters set to 0 just before and read just after: `_serve_expect`'s
    launches per prefill and decode step, no other kernel, no plain
    attention or SSD call."""
    from repro_torch.configs.base import get_config
    from repro_torch.energy.markets import generate_market
    from repro_torch.energy.presets import region_params
    from repro_torch.energy.stream import PriceStream
    from repro_torch.models.model import init_params
    from repro_torch.runtime.scheduler import (EnergyAwareScheduler,
                                               SchedulerConfig)
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.serving import engine as engine_mod

    cfg = get_config(arch)
    in_use = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(params)
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[serve] {cfg.name}: {_describe(cfg)}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {n_params / 1e9:.3f} B parameters "
          f"({param_bytes / 1e9:.2f} GB) drawn on the CPU and copied in "
          f"{time.perf_counter() - t0:.2f} s")

    md = generate_market(region_params("germany", seed=SERVE_SEED),
                         device=dev)
    prices = md.prices.cpu().numpy()
    sched = EnergyAwareScheduler(PriceStream(prices),
                                 SchedulerConfig(psi=2.0, mode="oracle"),
                                 device=dev)
    # start half an hour before the first hour above the threshold, so
    # that the gate closes while the first 8 requests decode and 8 wait,
    # and reopens when the price falls back
    first_high = int(np.argmax(prices > sched.p_thresh))
    if prices[first_high] <= sched.p_thresh or first_high == 0:
        raise AssertionError("serving: no hour above p_thresh to gate on")
    sched.stream.advance(first_high - 0.5)
    scfg = ServeConfig(slots=8, max_seq=2048)
    eng = ServingEngine(params, cfg, scfg, scheduler=sched, device=dev)
    reqs = _serve_requests(cfg, fixed)
    for r in reqs:
        eng.submit(r)

    times = {"prefill": [], "decode": []}
    saved = {"prefill": engine_mod.prefill,
             "decode": engine_mod.decode_step}

    def timed(name):
        fn = saved[name]

        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            return out
        return call
    engine_mod.prefill, engine_mod.decode_step = (timed("prefill"),
                                                   timed("decode"))
    plain, restore = _count_serving_plain_calls()
    try:
        counters = _zero_counters()
        t0 = time.perf_counter()
        ticks = closed = drained = held = 0
        while len(eng.completed) < SERVE_REQUESTS:
            served = eng.tokens_served
            eng.tick()
            # the width this tick admitted at (the stream has not moved)
            if eng._admission_width() < scfg.slots:
                closed += 1
                drained += eng.tokens_served > served   # live slots ran
                held += len(eng.queue) > 0              # requests waited
            ticks += 1
            if ticks > 100_000:
                raise AssertionError("serving: requests never completed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        device = _device_launches(counters)
    finally:
        restore()
        engine_mod.prefill, engine_mod.decode_step = (saved["prefill"],
                                                      saved["decode"])
    n_pre, n_dec = len(times["prefill"]), len(times["decode"])
    out = eng.summary()
    hours = ticks * scfg.hours_per_tick
    print(f"[serve] {cfg.name}: {ticks} ticks ({hours:.2f} h of market "
          f"time from hour {first_high - 0.5}, p_thresh "
          f"{sched.p_thresh:.2f} EUR/MWh, planned x {sched.planned_x:.4f}; "
          f"the gate closed at {closed} ticks: {drained} decoding the "
          f"admitted requests, {held} with requests waiting), "
          f"{n_pre} prefills, {n_dec} decode "
          f"steps, {wall:.2f} s wall; launches {launches}; plain calls "
          f"{plain}")
    expect = _serve_expect(cfg)
    for name, (per_pre, per_dec) in expect.items():
        if launches[name] != per_pre * n_pre + per_dec * n_dec:
            raise AssertionError(
                f"serving {cfg.name}: {launches[name]} {name} launches; "
                f"expected {per_pre} per prefill and {per_dec} per step")
    if not (drained and held):
        raise AssertionError(f"serving: the price gate closed at {closed} "
                             f"ticks ({drained} draining, {held} holding "
                             f"requests back); expected both")
    others = {k: v for k, v in launches.items() if k not in expect and v}
    if any(plain.values()) or others:
        raise AssertionError(f"serving: plain calls {plain} or other "
                             f"kernels {others} ran on the main path")
    for r in eng.completed:
        o = np.asarray(r.output)
        if len(o) != SERVE_MAX_NEW or o.min() < 0 or o.max() >= cfg.vocab:
            raise AssertionError(f"request {r.rid}: bad output {o[:8]}")
    if out["completed"] != SERVE_REQUESTS or out["queued"] != 0 \
            or out["tokens_served"] != SERVE_REQUESTS * SERVE_MAX_NEW \
            or not np.isfinite(out["eur_per_1k_tokens"]):
        raise AssertionError(f"serving summary: {out}")
    pre_ms = [t * 1e3 for t in times["prefill"]]
    dec_ms = [t * 1e3 for t in times["decode"]]
    lens = [len(r.prompt) for r in reqs]
    print(f"[serve] {cfg.name}: completed {out['completed']}, tokens served "
          f"{out['tokens_served']}, EUR/1k tokens "
          f"{out['eur_per_1k_tokens']:.6f}, mean queue "
          f"{out['mean_queue_h']:.4f} h, x realized "
          f"{out['x_realized']:.4f}")
    print(f"[serve] {cfg.name}: prefill (prompts {min(lens)}-{max(lens)}, "
          f"mean {np.mean(lens):.0f} tokens): mean {np.mean(pre_ms):.2f} ms, "
          f"median {np.median(pre_ms):.2f} ms; decode step (8 slots): "
          f"mean {np.mean(dec_ms):.2f} ms, median {np.median(dec_ms):.2f} "
          f"ms; {out['tokens_served'] / wall:.1f} tokens/s over the run "
          f"(prefill + decode + gated ticks); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
          f"({in_use / 1e9:.2f} GB in use before the phase)")
    print(f"[serve] {cfg.name}: decode-step bound: {param_bytes / 1e9:.2f} GB"
          f" of weights at 3.35 TB/s = "
          f"{param_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    # where a decode step's and a prefill's time goes (after the counted
    # run; the decode steps write the pool's next slots in place)
    from repro_torch.models.model import decode_step, prefill
    pos = torch.as_tensor(eng.positions, device=dev)
    _profile(lambda: decode_step(params, eng.tokens, eng.caches, pos, cfg),
             f"{cfg.name} decode step (8 slots)", runs=5)
    long = max(reqs, key=lambda r: len(r.prompt)).prompt
    mid = torch.as_tensor(long[:profile_len].astype(np.int64),
                          device=dev)[None]
    _profile(lambda: prefill(params, {"tokens": mid}, cfg, max_seq=2048),
             f"{cfg.name} prefill ({profile_len} tokens)", runs=3)
    return {"cfg": cfg, "params": params, "reqs": reqs,
            "launches": launches, "device_launches": device,
            "param_bytes": param_bytes,
            "engine_ms": (np.median(pre_ms), np.median(dec_ms))}


def _plain_stand_ins(cfg) -> dict:
    """The model's kernel entry points in `repro_torch.kernels.ops` and
    the plain versions that stand in for them on the card (a switch of
    this script, not of the package)."""
    from repro_torch.kernels import ref

    plain = {"ssd_scan": lambda x, dt, a, b, c, chunk, h0=None:
             ref.ssd_scan_plain(x, dt, a, b, c, chunk, h0),
             "flash_attention": lambda q, k, v, **kw:
             ref.flash_attention_plain(q, k, v, causal=kw["causal"],
                                       window=kw["window"],
                                       q_offset=kw["q_offset"]),
             "decode_attention": lambda q, k, v, valid, **kw:
             ref.decode_attention_plain(q, k, v, valid)}
    return {k: plain[k] for k in _serve_expect(cfg)}


def phase_teacher_forced(dev, serve, prompt_len: int | None = None) -> None:
    """One request (the first, or the first of ``prompt_len`` tokens)
    through `prefill` + 16 `decode_step`s on the kernels, then again with
    the model's kernel entry points switched to their plain versions on the
    card and fed the kernel path's tokens; the logits must agree within
    TF_MAX_ABS."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, prefill

    cfg, params = serve["cfg"], serve["params"]
    prompt = next(r.prompt for r in serve["reqs"]
                  if prompt_len is None or len(r.prompt) == prompt_len)

    def run(forced=None):
        toks = torch.as_tensor(prompt.astype(np.int64), device=dev)[None]
        logits, caches = prefill(params, {"tokens": toks}, cfg,
                                 max_seq=2048)
        rows, picks = [logits[0]], [int(torch.argmax(logits[0]))]
        pos = len(prompt)
        for i in range(TF_STEPS):
            tok = picks[-1] if forced is None else forced[i]
            logits, caches = decode_step(
                params, torch.tensor([[tok]], device=dev), caches,
                torch.tensor([pos], device=dev), cfg)
            rows.append(logits[0])
            picks.append(int(torch.argmax(logits[0])))
            pos += 1
        return torch.stack(rows), picks

    expect = _serve_expect(cfg)
    counters = _zero_counters()
    kern, kern_toks = run()
    n_kernel = {k: counters[k].launches for k in expect}
    stand_ins = _plain_stand_ins(cfg)
    saved = {k: getattr(ops, k) for k in stand_ins}
    for k, fn in stand_ins.items():
        setattr(ops, k, fn)
    try:
        counters = _zero_counters()
        plain, plain_toks = run(forced=kern_toks)
        n_plain = {k: counters[k].launches for k in expect}
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)
    torch.cuda.synchronize()
    want = {k: a + b * TF_STEPS for k, (a, b) in expect.items()}
    if n_kernel != want or any(n_plain.values()):
        raise AssertionError(f"teacher forcing: launches {n_kernel} on the "
                             f"kernels, {n_plain} on the plain path")
    d = (kern - plain).abs()
    agree = np.mean([a == b for a, b in zip(kern_toks, plain_toks)])
    print(f"[serve] {cfg.name}: teacher-forced logits, prompt {len(prompt)} "
          f"tokens, prefill + {TF_STEPS} steps, kernels vs plain on the "
          f"card: max |diff| {float(d.max()):.4g}, mean "
          f"{float(d.mean()):.4g} (logits: std {float(kern.std()):.4g}, "
          f"max |.| {float(kern.abs().max()):.4g}); argmax agrees on "
          f"{agree:.0%} of {TF_STEPS + 1} positions")
    if not bool(torch.isfinite(kern).all()) or float(d.max()) > TF_MAX_ABS:
        raise AssertionError(f"teacher-forced logits differ by more than "
                             f"{TF_MAX_ABS}")


def phase_prefill_vs_decode(dev, serve, steps: int = 8) -> None:
    """On the card, for S = 2 (a prompt shorter than the conv's K - 1 = 3
    inputs, whose conv tail is left-padded) and S = 300: prefill S tokens
    of a request (its K/V, where the model has attention, into a cache of
    2048 positions), decode its next ``steps`` tokens one at a time, and
    hold each step's logits against the prefill of the longer prompt;
    within TF_MAX_ABS (the decode recurrence and the chunked scan round in
    bf16 at other places)."""
    from repro_torch.models.model import decode_step, prefill

    cfg, params = serve["cfg"], serve["params"]
    prompt = max(serve["reqs"], key=lambda r: len(r.prompt)).prompt
    toks = torch.as_tensor(prompt.astype(np.int64), device=dev)[None]
    for s in (2, 300):
        _, caches = prefill(params, {"tokens": toks[:, :s]}, cfg,
                            max_seq=2048)
        worst = 0.0
        for j in range(steps):
            got, caches = decode_step(params, toks[:, s + j:s + j + 1],
                                      caches,
                                      torch.tensor([s + j], device=dev), cfg)
            want, _ = prefill(params, {"tokens": toks[:, :s + j + 1]}, cfg)
            worst = max(worst, float((got - want).abs().max()))
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("prefill vs decode: non-finite logits")
        print(f"[serve] {cfg.name}: prefill {s} tokens + {steps} decode "
              f"steps vs prefill of {s + 1}..{s + steps} tokens on the card: "
              f"max |logit diff| {worst:.4g}")
        if worst > TF_MAX_ABS:
            raise AssertionError(f"prefill {s} + decode differs from the "
                                 f"longer prefill by more than {TF_MAX_ABS}")


def phase_serve_launcher(dev) -> None:
    """`python -m repro_torch.launch.serve --device cuda:0`: the
    reference's defaults (reduced qwen1.5-0.5b, 24 requests, 200 ticks,
    price gate on) on the card, then ``--arch mamba2-1.3b`` and ``--arch
    zamba2-1.2b`` (reduced), each run in this process through its `main`;
    each must launch every kernel of its family's serving path."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    for arch in ("qwen1.5-0.5b", "mamba2-1.3b", "zamba2-1.2b"):
        t0 = time.perf_counter()
        counters = _zero_counters()
        rc = serve.main(["--device", str(dev), "--arch", arch])
        torch.cuda.synchronize()
        ran = {k: c.launches for k, c in counters.items() if c.launches}
        print(f"[serve] launcher --arch {arch}: exit {rc}, "
              f"{time.perf_counter() - t0:.2f} s; launches {ran}")
        if rc != 0 or set(ran) != set(_serve_expect(get_config(arch))):
            raise AssertionError(f"repro_torch.launch.serve --arch {arch} "
                                 "failed")


def _attn_bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _in_turns(kernel, library, flush) -> tuple[float, float]:
    """Device-only times (`_cuda_times`, L2 flushed) of a kernel and the
    library call on the same inputs, in turns: kernel, library, library,
    kernel; the median of each one's 2 x TIMED_RUNS runs."""
    k1 = _cuda_times(kernel, flush=flush, device_only=True)
    l1 = _cuda_times(library, flush=flush, device_only=True)
    l2 = _cuda_times(library, flush=flush, device_only=True)
    k2 = _cuda_times(kernel, flush=flush, device_only=True)
    return statistics.median(k1 + k2), statistics.median(l1 + l2)


def _flash_times(dev, flush, sq, h, g, dh, seed) -> dict:
    """Flash at one prefill shape (causal, Sq = Skv, bf16): the kernel in
    turns with SDPA, its plain version on the card, its bound."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain

    q, k, v = _attn_inputs([(1, sq, h, dh), (1, sq, g, dh),
                            (1, sq, g, dh)], BF16, dev, seed)
    ms, lib = _in_turns(lambda: flash_attention(q, k, v, causal=True),
                        lambda: _sdpa(q, k, v, causal=True), flush)
    plain = _cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                     runs=3)
    pairs = sq * (sq + 1) // 2
    bytes_moved = 2 * (2 * sq * h * dh + 2 * sq * g * dh)
    ops = 4 * pairs * h * dh
    bound, by = _attn_bound(bytes_moved, ops)
    print(f"[time] flash_attention Sq=Skv={sq} causal, {h} heads / {g} "
          f"groups, Dh {dh}, bf16: kernel {ms:.4f} ms, SDPA {lib:.4f} "
          f"ms ({ms / lib:.2f}x), plain {plain:.2f} ms, bound "
          f"{bound:.5f} ms ({by}; {ops / 1e9:.2f} GFLOP, "
          f"{bytes_moved / 1e6:.2f} MB), {bound / ms:.1%} of bound; "
          f"kernel {ops / ms / 1e9:.1f} TFLOP/s, "
          f"{bytes_moved / ms / 1e9:.3f} TB/s; SDPA "
          f"{ops / lib / 1e9:.1f} TFLOP/s")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def _decode_times(dev, flush, b, h, g, dh, w, seed) -> dict:
    """Decode over a pool of ``b`` slots x ``w`` positions (bf16) under a
    linear cache's mask (per-row lengths of 129 to ``w``, drawn from seed
    951 at every shape): the kernel in turns with SDPA, its plain version
    on the card, its bound over the valid slots."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_plain

    q, k, v = _attn_inputs([(b, 1, h, dh), (b, w, g, dh), (b, w, g, dh)],
                           BF16, dev, seed)
    valid = _decode_valid(b, w, "linear", dev, 951)
    mask = valid.bool()[:, None, None, :]
    ms, lib = _in_turns(lambda: decode_attention(q, k, v, valid),
                        lambda: _sdpa(q, k, v, mask), flush)
    plain = _cuda_ms(lambda: decode_attention_plain(q, k, v, valid), runs=3)
    # the function needs the K/V of the valid slots only (a row's output
    # does not depend on the others'), the mask, q and o
    n_valid = int(valid.sum())
    bytes_moved = 2 * (2 * n_valid * g * dh + 2 * b * h * dh) + b * w
    ops = 4 * n_valid * h * dh
    bound, by = _attn_bound(bytes_moved, ops)
    pool = 2 * (2 * b * w * g * dh + 2 * b * h * dh) + b * w
    print(f"[time] decode_attention B={b} W={w}, {h} heads / {g} groups, "
          f"Dh {dh}, bf16, linear mask ({n_valid} valid slots): kernel "
          f"{ms:.4f} ms, SDPA {lib:.4f} ms ({ms / lib:.2f}x), plain "
          f"{plain:.2f} ms, bound {bound:.5f} ms ({by}; "
          f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP; the whole "
          f"pool's {pool / 1e6:.1f} MB {pool / HBM_BYTES_PER_S * 1e3:.5f} "
          f"ms), {bound / ms:.1%} of bound; kernel "
          f"{bytes_moved / ms / 1e9:.3f} TB/s, {ops / ms / 1e9:.2f} "
          f"TFLOP/s; SDPA {bytes_moved / lib / 1e9:.3f} TB/s")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def phase_attention_times(dev, flush) -> dict:
    """Device-only times (CUDA events, L2 flushed) of kernels 8 and 9 at
    the serving shapes, in turns with SDPA on the same inputs, beside
    their plain versions on the card and their bounds (the larger of the
    bytes at 3.35 TB/s and the matrix products at the 989 TFLOP/s bf16
    peak): qwen2.5-3b's (16 heads / 2 groups, Dh 128) and zamba2-1.2b's
    (32 heads, each its own group, Dh 64)."""
    recs = {}
    for sq in (128, 1024, 2048):
        recs[("flash", sq)] = _flash_times(dev, flush, sq, 16, 2, 128,
                                           900 + sq)
    recs[("decode", 2048)] = _decode_times(dev, flush, 8, 16, 2, 128, 2048,
                                           950)
    recs[("hybrid flash", 1024)] = _flash_times(dev, flush, 1024, 32, 32,
                                                64, 960)
    recs[("hybrid decode", 2048)] = _decode_times(dev, flush, 8, 32, 32, 64,
                                                  2048, 961)
    return recs


def _hybrid_keys(t: dict, launches: int) -> dict:
    """A kernel's zamba2-1.2b numbers under ``hybrid_`` keys: its launches
    on the hybrid serving run and its times at zamba2's shape."""
    return {"hybrid_launches": launches,
            **{f"hybrid_{k}": v for k, v in t.items()}}


def _attention_records(errs: dict, times: dict, launches: dict,
                       hybrid: dict) -> list[dict]:
    """Kernels 8 and 9 in the ``kernels`` line: flash at the serving
    shape Sq = Skv = 1024 (causal, 16 heads / 2 groups, Dh 128, bf16),
    decode at the serving pool (8 slots x 2048); launches from the
    full-width qwen2.5-3b serving run; the ``hybrid_`` keys the same at
    zamba2-1.2b's shapes (32 heads / 32 groups, Dh 64) and from its
    serving run; errors the largest over `phase_attention_vs_plain`'s
    cases."""
    recs = []
    for name, line, kind, key in (
            ("flash_attention", 42, "flash", 1024),
            ("decode_attention", 32, "decode", 2048)):
        t = times[(kind, key)]
        recs.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **_hybrid_keys(times[(f"hybrid {kind}", key)], hybrid[name])})
    return recs


# ---------------------------------------------------------------------------
# the Mamba2 serving path: the SSD chunk scan (kernel 10)
# ---------------------------------------------------------------------------

SSD_TOL = 1e-4        # of the output's scale (max |y|, max |h|)
# B, S, H, P, G, N, chunk, dtype, h0: the reference's SSD_CASES
# (tests/test_kernels.py), then mamba2-1.3b's serving shape (64 heads of P
# 64, one group of N 128, chunk 256) at 1024 and 1000 positions (padded),
# with x, B and C in bf16 (as the model gives them) and in float32; then
# the output kernel's head sets: several heads a group with a ragged last
# set (H 12 / G 2, H 6 / G 1), one head a group (G = H), and B and C rows
# that take no 16-byte copies (N 20, P 24); last zamba2-1.2b's serving
# shape (one group of N 64: one of the two 64-column slabs) at 1024 and
# 1000 positions, bf16 and float32
SSD_SMOKE_CASES = [
    (2, 64, 4, 16, 1, 32, 16, torch.float32, False),
    (1, 128, 8, 32, 2, 16, 32, torch.float32, True),
    (2, 96, 4, 64, 1, 128, 48, torch.float32, False),
    (1, 64, 2, 8, 1, 8, 64, torch.float32, True),
    (1, 1024, 64, 64, 1, 128, 256, BF16, False),
    (1, 1024, 64, 64, 1, 128, 256, torch.float32, True),
    (1, 1000, 64, 64, 1, 128, 256, BF16, True),
    (1, 1000, 64, 64, 1, 128, 256, torch.float32, False),
    (1, 512, 12, 64, 2, 128, 128, BF16, True),
    (2, 320, 6, 32, 1, 64, 64, torch.float32, False),
    (1, 160, 4, 16, 4, 32, 32, BF16, True),
    (1, 160, 4, 16, 4, 32, 32, torch.float32, False),
    (1, 96, 4, 24, 1, 20, 32, BF16, True),
    (1, 1024, 64, 64, 1, 64, 256, BF16, False),
    (1, 1000, 64, 64, 1, 64, 256, BF16, True),
    (1, 1024, 64, 64, 1, 64, 256, torch.float32, True),
]


def _ssd_inputs(b, s, h, p, g, n, dtype, dev, seed):
    """The reference tests' distributions (x ~ N(0, 1), dt = 0.1 |N|,
    a = -|N| - 0.1, B and C ~ 0.3 N) from numpy, x/B/C in ``dtype``."""
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = (rng.normal(size=(b, s, h, p)),
            np.abs(rng.normal(size=(b, s, h))) * 0.1,
            -np.abs(rng.normal(size=(h,))) - 0.1,
            rng.normal(size=(b, s, g, n)) * 0.3,
            rng.normal(size=(b, s, g, n)) * 0.3)
    x, dt, a, bb, cc = (torch.as_tensor(v.astype(f), device=dev)
                        for v in arrs)
    return x.to(dtype), dt, a, bb.to(dtype), cc.to(dtype)


def _ssd_check(label, y, h, wy, wh) -> float:
    """Max |err| of y and h against the plain version's, each within
    SSD_TOL of its scale; returns the larger absolute error."""
    worst = 0.0
    parts = []
    for name, got, want in (("y", y, wy), ("h_T", h, wh)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ssd {label}: non-finite {name}")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        parts.append(f"{name} max |err| {err:.3g} ({err / scale:.3g} of "
                     f"its scale {scale:.3g})")
        if err > SSD_TOL * scale:
            raise AssertionError(f"ssd {label}: {name} differs by {err:.3g},"
                                 f" more than {SSD_TOL} of {scale:.3g}")
        worst = max(worst, err)
    print(f"[ssd] {label}: " + ", ".join(parts))
    return worst


def phase_ssd_vs_plain(dev) -> float:
    """Kernel 10 against `ssd_scan_plain` on the card, through
    `ops.ssd_scan` (which pads a ragged length): the reference's cases and
    the serving shapes, with h0 and without, and a sequence scanned in two
    parts chained through h0 against the one-part scan."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_plain

    worst = 0.0
    for i, case in enumerate(SSD_SMOKE_CASES):
        b, s, h, p, g, n, l, dt_, with_h0 = case
        x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, g, n, dt_, dev, 1000 + i)
        h0 = (torch.as_tensor(np.random.default_rng(i).normal(
            size=(b, h, p, n)).astype(np.float32) * 0.5, device=dev)
            if with_h0 else None)
        y, hl = ops.ssd_scan(x, dt, a, bb, cc, l, h0)
        wy, wh = ssd_scan_plain(x, dt, a, bb, cc, l, h0)
        torch.cuda.synchronize()
        worst = max(worst, _ssd_check(
            f"B{b} S{s} H{h} P{p} G{g} N{n} L{l} {dt_}"
            f"{' h0' if with_h0 else ''}", y, hl, wy, wh))
    # two parts chained through h0 (700 + 324 positions, both ragged)
    x, dt, a, bb, cc = _ssd_inputs(1, 1024, 64, 64, 1, 128, BF16, dev, 1100)
    y, hl = ops.ssd_scan(x, dt, a, bb, cc, 256)
    y1, h1 = ops.ssd_scan(x[:, :700], dt[:, :700], a, bb[:, :700],
                          cc[:, :700], 256)
    y2, h2 = ops.ssd_scan(x[:, 700:], dt[:, 700:], a, bb[:, 700:],
                          cc[:, 700:], 256, h1)
    wy, wh = ssd_scan_plain(x, dt, a, bb, cc, 256)
    torch.cuda.synchronize()
    worst = max(worst, _ssd_check("two parts 700 + 324 through h0 vs plain",
                                  torch.cat([y1, y2], dim=1), h2, wy, wh))
    _ssd_check("two parts vs the kernel in one part",
               torch.cat([y1, y2], dim=1), h2, y, hl)
    return worst


BF16_OPS_PER_S = 989e12      # H100 SXM bf16 on the tensor cores, dense


def _ssd_bound(b, s, h, p, g, n, l, x_bytes) -> tuple[float, float, str]:
    """(bound ms, GFLOP needed, what bounds it) of one scan from zeros (no
    h0). The products the function needs: C B^T once per group and chunk
    on the lower triangle, the masked scores times x dt and B^T (x dt
    decay) for each head and chunk, C h_in for each head and chunk but the
    first (its h_in is 0). With bf16 x, B and C (``x_bytes`` 2) the kernel
    runs them all on the tensor cores, the float32 operand of the last
    three in three bf16 parts: they count three times at the 989 TFLOP/s
    bf16 peak, C B^T once; in float32 they count once at 67 TFLOP/s. The
    bytes: x, B and C (``x_bytes`` an element), dt, a, y and h_T (float32)
    at 3.35 TB/s."""
    nc = -(-s // l)
    tri = l * (l + 1) // 2
    ops_cb = 2 * b * nc * g * tri * n
    ops_f32 = 2 * b * (nc * (h * tri * p + h * l * n * p)
                       + (nc - 1) * h * l * n * p)
    bytes_ = (x_bytes * (b * s * h * p + 2 * b * s * g * n)
              + 4 * (b * s * h + h + b * s * h * p + b * h * p * n))
    if x_bytes == 2:
        t_o = (ops_cb + 3 * ops_f32) / BF16_OPS_PER_S
    else:
        t_o = (ops_cb + ops_f32) / FP32_OPS_PER_S
    t_b = bytes_ / HBM_BYTES_PER_S
    return max(t_o, t_b) * 1e3, (ops_cb + ops_f32) / 1e9, \
        "operations" if t_o >= t_b else "bytes"


def _ssd_issued(b, s, h, p, g, n, l, hs, has_h0) -> float:
    """GFLOP the bf16 kernel issues on the tensor cores for one scan
    (`csrc/ssd_scan.cu`, mma.sync m16n8k16), counted from its tiling: pass
    1 per (b, h, chunk, 64 columns of P) over rows of N in 16s and the
    chunk's positions in 64s, three parts; pass 3 per row tile and set of
    ``hs`` heads, S_j = C_i B_j^T once per key tile j <= i (N in 64s),
    then for each head C_i h_in (N in 16s; not in chunk 0 without h0) and
    the scores times x (64 keys a key tile; on the diagonal tile warp w's
    16 rows against keys below 16 w + 16), three parts each."""
    nc, t = -(-s // l), 64
    tp, ti = -(-p // t), -(-l // t)
    n16, n64 = -(-n // 16) * 16, -(-n // t) * t
    sets = -(-(h // g) // hs)
    flop = b * h * nc * tp * 2 * n16 * (-(-l // t) * t) * t * 3   # pass 1
    diag = sum(2 * 16 * t * 16 * (w + 1) for w in range(4)) * 3
    for it in range(ti):
        for j in range(it + 1):
            flop += b * nc * g * sets * tp * 2 * t * t * n64
            flop += b * nc * h * tp * (2 * t * t * t * 3 if j < it else diag)
        flop += b * (nc - (0 if has_h0 else 1)) * h * tp * 2 * t * t * n16 * 3
    return flop / 1e9


def _pass_times_us(fn, flush: torch.Tensor, runs: int = 10) -> dict:
    """Device time per call (us) of each kernel ``fn`` puts on the card, by
    kernel name, from `torch.profiler` (CUPTI) over ``runs`` calls, each
    after ``flush`` is overwritten (L2 flushed, as `_cuda_ms` times it;
    the flush's own kernel is among the names). A session in which the
    profiler recorded no device event at all (not even the flush's) is
    the tool's failure, not the kernels': it is said and run once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total / runs
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0}
        if times:
            return times
        print(f"[profile] session {attempt + 1}: the profiler recorded no "
              "device event")
    return times


SSD_PASSES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")


SSD_HEADS = 2     # heads a block of the output kernel (kHeads)


def phase_ssd_times(dev, flush) -> dict:
    """Device-only times (CUDA events, L2 flushed) of kernel 10 at
    mamba2-1.3b's serving shape (one layer's 1024-token prefill: 64 heads
    of P 64, N 128, chunk 256, bf16 x/B/C as the model gives them), at
    2048 positions, and at zamba2-1.2b's (N 64, key ``("hybrid", 1024)``),
    beside its plain version on the card, its bound and the work it
    issues; each pass's device time under the profiler, which must show
    the tensor-core kernels (a bf16 scan that fell back to the CUDA-core
    ones would be right, and slow). No single PyTorch call computes this
    scan, so there is no library time."""
    from repro_torch.kernels.ref import ssd_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan

    recs = {}
    for key, s, n, seed in ((1024, 1024, 128, 2224),
                            (2048, 2048, 128, 3248),
                            (("hybrid", 1024), 1024, 64, 2290)):
        x, dt, a, bb, cc = _ssd_inputs(1, s, 64, 64, 1, n, BF16, dev, seed)
        ms = _cuda_ms(lambda: ssd_scan(x, dt, a, bb, cc, 256), flush=flush,
                      device_only=True)
        passes = _pass_times_us(lambda: ssd_scan(x, dt, a, bb, cc, 256),
                                flush)
        by_pass = {name: sum(us for k, us in passes.items() if name in k)
                   for name in SSD_PASSES}
        mma = sorted(k for k in passes if "_mma" in k)
        if len(mma) != 2:
            raise AssertionError(f"ssd_scan S={s} N={n} bf16: the profiler "
                                 f"saw {sorted(passes)}, not the two "
                                 "tensor-core kernels")
        plain = _cuda_ms(lambda: ssd_scan_plain(x, dt, a, bb, cc, 256),
                         runs=3)
        bound, gflop, by = _ssd_bound(1, s, 64, 64, 1, n, 256, 2)
        issued = _ssd_issued(1, s, 64, 64, 1, n, 256, SSD_HEADS, False)
        print(f"[time] ssd_scan S={s}, 64 heads of P 64, N {n}, chunk 256, "
              f"bf16: kernel {ms:.4f} ms, passes under the profiler (L2 "
              "flushed) "
              + ", ".join(f"{k} {v:.1f} us" for k, v in by_pass.items())
              + f"; plain {plain:.3f} ms, bound {bound:.5f} ms ({by}; "
              f"{gflop:.2f} GFLOP needed, counted three times at the bf16 "
              f"peak but C B^T), {bound / ms:.1%} of bound, "
              f"{gflop / ms:.2f} TFLOP/s of needed work; issued "
              f"{issued:.2f} GFLOP on the tensor cores "
              f"({issued / ms:.1f} TFLOP/s); tensor-core kernels "
              + ", ".join(k[:40] for k in mma))
        recs[key] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "library_ms": None}
    return recs


# ---------------------------------------------------------------------------
# the training slice: the kernels under autograd, training steps, the
# energy-aware trainer at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SEED = 8, 1024, 24, 0
# gradients on the card, Function against plain autograd: max |diff| over
# max(max |plain|, 1); bf16 rounds activations and gradients to 8 bits
GRAD_TOL = {torch.float32: 1e-4, BF16: 3e-2}
# a 2-layer cut's loss and gradient leaves (each leaf's worst error over
# its largest entry) at bf16, kernel route against the plain route: the
# flash and plain forwards sum in other orders, so bf16 activations round
# apart at some elements and the difference runs through two layers and
# the backward
CUT_LOSS_TOL, CUT_GRAD_TOL = 1e-2, 5e-2
# B, S, H, G, Dh, causal, window, q_offset, dtype (Sq = S, Skv = S +
# q_offset): one token, a tile, ragged 100 and the full-width run's 1024;
# causal and windowed, a chunked prefill's offset, GQA 16/2 and MHA 16/16,
# Dh 64 and 128, float32 and bf16
TRAIN_ATTN_CASES = [
    (2, 1, 16, 16, 64, True, 0, 0, torch.float32),
    (2, 64, 16, 2, 128, True, 0, 0, BF16),
    (2, 100, 16, 16, 64, True, 0, 0, torch.float32),
    (2, 100, 16, 2, 128, True, 24, 0, BF16),
    (1, 100, 16, 2, 64, True, 0, 156, torch.float32),
    (1, 100, 16, 16, 128, True, 40, 156, BF16),
    (8, 1024, 16, 16, 64, True, 0, 0, BF16),
    (1, 1024, 16, 2, 128, True, 256, 0, torch.float32),
    (1, 1024, 16, 16, 64, False, 0, 0, BF16),
]
# B, S, H, P, G, N, chunk, dtype, h0: 256 / 300 / 1024 positions, N 64
# and 128, one head a group and a shared group, with h0 and without
TRAIN_SSD_CASES = [
    (2, 256, 8, 64, 1, 128, 256, BF16, False),
    (1, 300, 8, 64, 8, 64, 256, torch.float32, True),
    (1, 1024, 16, 64, 1, 128, 256, BF16, True),
    (2, 300, 4, 64, 1, 64, 128, BF16, False),
    (1, 1024, 8, 64, 8, 128, 256, torch.float32, False),
]


def _grad_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        / max(float(want.float().abs().max()), 1.0)


def phase_train_functions(dev) -> dict:
    """The two autograd Functions on the card against plain autograd:
    `models.attention.blockwise_attention` with inputs that require grad
    (the flash kernel forward, `FlashAttention`'s backward) against
    autograd through `flash_attention_plain`, and the model's `ssd_scan`
    (the SSD kernel forward, `SSDScan`'s backward) against autograd
    through `ssd_scan_plain`; dq, dk, dv (dx, ddt, da, db, dc, dh0)
    within GRAD_TOL. Returns the worst errors."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.inputs import reduced_config
    from repro_torch.kernels import ref
    from repro_torch.models import attention, ssm

    cfg = reduced_config(get_config(TRAIN_ARCH))
    worst = {"flash_attention": 0.0, "ssd_scan": 0.0}
    counters = _zero_counters()
    for i, case in enumerate(TRAIN_ATTN_CASES):
        b, s, h, g, dh, causal, win, qo, dtype = case
        q, k, v, w = _attn_inputs([(b, s, h, dh), (b, s + qo, g, dh),
                                   (b, s + qo, g, dh), (b, s, h, dh)],
                                  dtype, dev, 2000 + i)
        grads, n0 = [], counters["flash_attention"].launches
        for route in ("kernel", "plain"):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            out = (attention.blockwise_attention(
                *ins, cfg, causal=causal, window=win, q_offset=qo)
                if route == "kernel" else ref.flash_attention_plain(
                    *ins, causal=causal, window=win, q_offset=qo))
            (out.float() * w.float()).sum().backward()
            grads.append([t.grad for t in ins])
        torch.cuda.synchronize()
        errs = [_grad_err(a, bb) for a, bb in zip(*grads)]
        ok = max(errs) <= GRAD_TOL[dtype] \
            and counters["flash_attention"].launches == n0 + 1
        print(f"[train] flash Function B{b} S{s} H{h}/G{g} Dh{dh} "
              f"{'causal' if causal else 'full'} w{win} off{qo} {dtype}: "
              f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} "
              f"(tol {GRAD_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash Function's gradients disagree with "
                                 "plain autograd")
        worst["flash_attention"] = max(worst["flash_attention"], *errs)
    for i, case in enumerate(TRAIN_SSD_CASES):
        b, s, h, p, g, n, l, dtype, with_h0 = case
        x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, g, n, dtype, dev,
                                       2100 + i)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2200 + i)
        h0 = torch.randn((b, h, p, n), generator=gen, device=dev) * 0.5 \
            if with_h0 else None
        wy = torch.randn((b, s, h, p), generator=gen, device=dev)
        wh = torch.randn((b, h, p, n), generator=gen, device=dev)
        grads, n0 = [], counters["ssd_scan"].launches
        for route in ("kernel", "plain"):
            ins = [t.clone().requires_grad_() for t in (x, dt, a, bb, cc)]
            hh = None if h0 is None else h0.clone().requires_grad_()
            fn = ssm.ssd_scan if route == "kernel" else ref.ssd_scan_plain
            y, hl = fn(*ins, l, hh)
            ((y * wy).sum() + (hl * wh).sum()).backward()
            grads.append([t.grad for t in ins]
                         + ([hh.grad] if with_h0 else []))
        torch.cuda.synchronize()
        errs = [_grad_err(ga, gb) for ga, gb in zip(*grads)]
        ok = max(errs) <= GRAD_TOL[dtype] \
            and counters["ssd_scan"].launches == n0 + 1
        names = ("dx", "ddt", "da", "db", "dc", "dh0")
        print(f"[train] SSD Function B{b} S{s} H{h} P{p} G{g} N{n} L{l} "
              f"{dtype}{' h0' if with_h0 else ''}: "
              + " ".join(f"{nm} {e:.3g}" for nm, e in zip(names, errs))
              + f" (tol {GRAD_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("SSD Function's gradients disagree with "
                                 "plain autograd")
        worst["ssd_scan"] = max(worst["ssd_scan"], *errs)
    return worst


def _cut(arch: str):
    """A 2-layer cut of ``arch`` at full width (zamba2: one application of
    its shared block, after the second layer)."""
    from repro_torch.configs.base import get_config

    cfg = get_config(arch)
    kw = dict(name=f"{arch}-2l", n_layers=2)
    if cfg.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
    return cfg.replace(**kw)


def _with_grad(params):
    """``params`` as leaves that require grad; returns (tree, leaves,
    their paths)."""
    leaves, paths = [], []

    def req(t, path):
        if isinstance(t, dict):
            return {k: req(v, f"{path}/{k}") for k, v in t.items()}
        leaves.append(t.detach().requires_grad_())
        paths.append(path[1:])
        return leaves[-1]
    return req(params, ""), leaves, paths


def _leaf_err(got, want) -> float:
    """max |got - want| over max |want|: a gradient leaf's worst error
    relative to the leaf."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / scale if scale else err


def _plain_route():
    """Switch the model's attention and SSD call sites to the plain
    versions under plain autograd (a switch of this script, not of the
    package); returns the function that switches them back."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention, ssm

    saved = attention.blockwise_attention, ssm.ssd_scan
    attention.blockwise_attention = \
        lambda q, k, v, cfg, **kw: ref.flash_attention_plain(q, k, v, **kw)
    ssm.ssd_scan = ref.ssd_scan_plain

    def restore():
        attention.blockwise_attention, ssm.ssd_scan = saved
    return restore


def phase_train_cuts(dev) -> None:
    """One training step's loss and every gradient leaf on a 2-layer cut
    of each served family at full width (qwen1.5-0.5b, mamba2-1.3b,
    zamba2-1.2b with one shared-block application; bf16, random
    parameters from a seed, batch 2 x 1024 from the pipeline, remat full):
    the kernel route against the plain route on the card. Each leaf's
    worst error relative to the leaf's largest entry within
    CUT_GRAD_TOL."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import init_params, loss_fn

    for arch in (TRAIN_ARCH, SSM_ARCH, HYBRID_ARCH):
        cfg = _cut(arch)
        params = init_params(TRAIN_SEED, cfg, device=dev)
        batch = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                            global_batch=2, seed=TRAIN_SEED).batch_at(
                                0, device=dev)
        runs = {}
        for route in ("kernel", "plain"):
            restore = _plain_route() if route == "plain" else (lambda: None)
            try:
                counters = _zero_counters()
                p, leaves, paths = _with_grad(params)
                loss, _ = loss_fn(p, batch, cfg)
                grads = torch.autograd.grad(loss, leaves)
                torch.cuda.synchronize()
            finally:
                restore()
            runs[route] = (float(loss.detach()), grads,
                           {k: c.launches for k, c in counters.items()
                            if c.launches})
        (kl, kg, kn), (pl, pg, pn) = runs["kernel"], runs["plain"]
        errs = [_leaf_err(a, b) for a, b in zip(kg, pg)]
        print(f"[train] {cfg.name} ({_describe(cfg)}"
              f"): loss kernel {kl:.6f} plain {pl:.6f}; launches {kn} / "
              f"plain {pn}; each gradient leaf's worst error over its "
              f"largest entry (tol {CUT_GRAD_TOL}): "
              + ", ".join(f"{n} {e:.3g}" for n, e in zip(paths, errs)))
        if not (np.isfinite(kl) and abs(kl - pl) <= CUT_LOSS_TOL * abs(pl)
                and max(errs) <= CUT_GRAD_TOL and kn and not pn):
            raise AssertionError(f"{cfg.name}: the kernel route's step "
                                 "disagrees with the plain route")
        del params, batch, runs, kg, pg
        gc.collect()
        torch.cuda.empty_cache()


def _train_start_hour(prices: np.ndarray, p_thresh: float, steps: int,
                      hysteresis: float = 0.9) -> int:
    """The first hour from which an oracle scheduler (shut down above
    ``p_thresh``, resume at or below ``hysteresis`` x it) run for
    ``steps`` training steps shuts down after at least 4 steps, resumes,
    and stays down at most 6 ticks."""
    for h in range(len(prices) - 4 * steps):
        pos, done, running, downs, saw = h, 0, True, 0, set()
        while done < steps:
            price = prices[pos]
            pos += 1
            if running and price > p_thresh:
                running = False
                saw.add("shutdown" if done >= 4 else "early")
            elif not running and price <= hysteresis * p_thresh:
                running = True
                saw.add("resume")
                done += 1
            elif running:
                done += 1
            else:
                downs += 1
        if saw == {"shutdown", "resume"} and downs <= 6:
            return h
    raise AssertionError("no start hour gives a shutdown and a resume")


class _Watch:
    """The scheduler, recording each action it returns."""

    def __init__(self, sched):
        self.sched, self.stream, self.actions = sched, sched.stream, []

    def step(self, hours=1.0):
        self.actions.append(self.sched.step(hours))
        return self.actions[-1]


def phase_train_full(dev) -> dict:
    """qwen1.5-0.5b at full width (24 layers, bf16 parameters, float32
    AdamW moments, remat full, loss in 512-token chunks) trained by
    `Trainer` at batch 8 x 1024 for TRAIN_STEPS steps under the
    energy-aware scheduler (germany, Psi 2, oracle), its stream started at
    an hour chosen on the host so that a SHUTDOWN and a RESUME fall inside
    the run; checkpoints in a temporary directory removed afterwards.
    Checks finite losses falling, the parameters restored at RESUME
    against those saved at SHUTDOWN bit for bit, 24 x 2 flash launches a
    step (the forward and remat's re-forward), 24 Function backward calls
    a step and no plain attention; prints the step time, tokens/s, peak
    memory, the share of the bf16 peak, the checkpoint's times, the
    meter's summary, and the busy share under the profiler over 3 more
    steps."""
    import tempfile

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.energy.markets import generate_market
    from repro_torch.energy.presets import region_params
    from repro_torch.energy.stream import PriceStream
    from repro_torch.launch.roofline import (H100_SXM_BF16_FLOPS,
                                             model_flops)
    from repro_torch.models.attention import FlashAttention
    from repro_torch.runtime.scheduler import (Action, EnergyAwareScheduler,
                                               SchedulerConfig)
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    prices = generate_market(region_params("germany", seed=0),
                             device="cpu").prices.numpy()
    scfg = SchedulerConfig(psi=2.0, mode="oracle")
    p_thresh = EnergyAwareScheduler(PriceStream(prices), scfg,
                                    device=dev).p_thresh
    start = _train_start_hour(prices, p_thresh, TRAIN_STEPS)
    print(f"[train] market, threshold and start hour on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    sched = _Watch(EnergyAwareScheduler(PriceStream(prices, start=start),
                                        scfg, device=dev))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    trainer = None
    try:
        t0 = time.perf_counter()
        trainer = Trainer(cfg, TrainerConfig(steps=TRAIN_STEPS,
                                             ckpt_dir=tmp, ckpt_every=1000,
                                             seed=TRAIN_SEED),
                          scheduler=sched, batch_size=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step_s, saved, restored = [], {}, []
        train_step, checkpoint, restore = (trainer.train_step,
                                           trainer._checkpoint,
                                           trainer._restore)

        def timed_step(*a):
            t1 = time.perf_counter()
            out = train_step(*a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            return out

        def watched_checkpoint(blocking=False):
            if sched.actions and sched.actions[-1] is Action.SHUTDOWN:
                saved[trainer.step] = {k: v.detach().clone() for k, v in
                                       _flat(trainer.params).items()}
            checkpoint(blocking)

        def watched_restore():
            restore()
            if sched.actions and sched.actions[-1] is Action.RESUME:
                want = saved[trainer.step]
                got = _flat(trainer.params)
                restored.append(all(torch.equal(got[k], want[k])
                                    for k in want))

        trainer.train_step, trainer._checkpoint, trainer._restore = \
            timed_step, watched_checkpoint, watched_restore
        counters = _zero_counters()
        FlashAttention.calls = FlashAttention.backward_calls = 0
        plain, restore_plain = _count_serving_plain_calls()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            t0 = time.perf_counter()
            out = trainer.run(log_every=0)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            restore_plain()
        launches = counters["flash_attention"].launches
        device_launches = counters["flash_attention"].device_launches
        fwd, bwd = FlashAttention.calls, FlashAttention.backward_calls
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [r["loss"] for r in trainer.history]
        n_steps = len(step_s)
        acts = [a.value for a in sched.actions]
        print(f"[train] {cfg.name}: {_describe(cfg)}, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
              f"{TRAIN_STEPS} steps; market hour {start} on (p_thresh "
              f"{p_thresh:.2f}); built in {init_s:.2f} s, run "
              f"{run_s:.2f} s")
        print(f"[train] actions: {acts}")
        print(f"[train] losses: {[round(x, 4) for x in losses]}")
        med = statistics.median(step_s[2:])
        flops = model_flops(cfg, ShapeSpec("train", seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH,
                                           kind="train"))
        print(f"[train] step: median {med * 1e3:.2f} ms (host clock, "
              f"synchronised; steps 3-{n_steps}: min "
              f"{min(step_s[2:]) * 1e3:.2f}, max {max(step_s[2:]) * 1e3:.2f}"
              f"; first {step_s[0] * 1e3:.1f}), "
              f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s, peak "
              f"{peak / 1e9:.2f} GB; model FLOPs {flops / 1e12:.3f} TFLOP "
              f"a step = {flops / med / 1e12:.1f} TFLOP/s, "
              f"{flops / med / H100_SXM_BF16_FLOPS:.1%} of the H100 SXM's "
              f"989 TFLOP/s dense bf16")
        print(f"[train] checkpoint: save {out['ckpt_save_s']:.3f} s, "
              f"restore {out['ckpt_restore_s']:.3f} s, "
              f"measured_restart_overhead_frac "
              f"{trainer.measured_restart_overhead_frac():.6f}; meter: CPC "
              f"{out['cpc']:.4f} (always-on {out['cpc_always_on']:.4f}), "
              f"x realised {out['x_realized']:.4f}, restarts "
              f"{out['restarts']}, lost steps {out['lost_steps']}")
        print(f"[train] flash launches {launches} ({device_launches} on "
              f"the card), Function forwards {fwd}, backwards {bwd}; "
              f"plain calls {plain}")
        want = cfg.n_layers * 2 * n_steps
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and n_steps == TRAIN_STEPS
                and "shutdown" in acts and "resume" in acts
                and restored and all(restored)
                and launches == want == fwd
                and bwd == cfg.n_layers * n_steps
                and not any(plain.values())):
            raise AssertionError(
                f"full-width training: losses finite and falling, a "
                f"shutdown and a resume restoring bit for bit "
                f"({restored}), {want} flash launches, "
                f"{cfg.n_layers * n_steps} backward calls and no plain "
                "call expected")
        print(f"[train] restored at RESUME == saved at SHUTDOWN, bit for "
              f"bit ({len(saved)} shutdown(s))")
        # the busy share over 3 more steps (not counted above)
        trainer.train_step = train_step
        batch = trainer.data.batch_at(0, device=dev)
        keep = np.ones(1, np.float32)
        t0 = time.perf_counter()
        _profile(lambda: trainer.train_step(batch, 1e-5, keep),
                 f"{cfg.name} train step (B {TRAIN_BATCH} x {TRAIN_SEQ})",
                 runs=3)
        print(f"[train] profiled in {time.perf_counter() - t0:.1f} s")
        _train_breakdown(trainer, batch, med, dev)
        return {"launches": launches, "device_launches": device_launches,
                "step_ms": med * 1e3}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()


def _train_breakdown(trainer, batch, step_s: float, dev) -> None:
    """Where a full-width step's time goes, part by part (CUDA events,
    median of TIMED_RUNS after a warm-up, each part at the run's shapes):
    the flash kernel forward (x 48 a step: forward and remat's re-forward),
    the attention backward in PyTorch operations (x 24), the chunked loss
    (final norm, unembedding, cross-entropy, forward and backward) and the
    AdamW update over the whole tree; the rest (the layers' GEMMs and
    elementwise work, their recompute, the embedding) is the step less
    these."""
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.attention import attention_backward
    from repro_torch.optim.adamw import adamw_update

    cfg = trainer.cfg
    b, s, h, dh = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.resolved_head_dim
    q, k, v, do = _attn_inputs([(b, s, h, dh), (b, s, cfg.n_kv_heads, dh),
                                (b, s, cfg.n_kv_heads, dh), (b, s, h, dh)],
                               BF16, dev, 2300)
    o = ops.flash_attention(q, k, v, causal=True)
    parts = {
        f"flash forward x {2 * cfg.n_layers}": 2 * cfg.n_layers * _cuda_ms(
            lambda: ops.flash_attention(q, k, v, causal=True)),
        f"attention backward x {cfg.n_layers}": cfg.n_layers * _cuda_ms(
            lambda: attention_backward(q, k, v, o, do, True)),
    }
    hid = torch.randn((b, s, cfg.d_model), device=dev).to(BF16)
    params = trainer.params

    def loss_part():
        x = hid.detach().requires_grad_()
        nll = model._token_nll(x, batch["labels"], params, cfg)
        torch.autograd.grad(nll.mean(), [x, params["embed"]["tok"]])
    parts["loss (chunked CE, fwd + bwd)"] = _cuda_ms(loss_part)
    def update():          # the parameters stand in for their gradients
        with torch.no_grad():
            adamw_update(params, trainer.opt_state, params, trainer.opt,
                         lr=1e-5)
    parts["AdamW update"] = _cuda_ms(update)
    rest = step_s * 1e3 - sum(parts.values())
    print(f"[train] step {step_s * 1e3:.2f} ms: "
          + "; ".join(f"{k_} {v_:.2f} ms" for k_, v_ in parts.items())
          + f"; the rest {rest:.2f} ms")


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def phase_train_resume(dev) -> None:
    """`tests/test_runtime.py`'s pause / resume check on the card: a
    2-layer cut of qwen1.5-0.5b at full width (batch 2 x 256) trained for
    6 steps uninterrupted and again under a scheduler that forces SHUTDOWN,
    STAY_DOWN and RESUME; the two land on the same parameters bit for
    bit."""
    import tempfile

    from repro_torch.energy.stream import PriceStream
    from repro_torch.runtime.scheduler import Action
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    class Forcing:
        def __init__(self):
            self.i = 0
            self.stream = PriceStream(np.full(100, 50.0))

        def step(self, hours=1.0):
            self.i += 1
            self.stream.advance(hours)
            return {4: Action.SHUTDOWN, 5: Action.STAY_DOWN,
                    6: Action.RESUME}.get(self.i % 7, Action.RUN)

    cfg = _cut(TRAIN_ARCH)
    finals = []
    for sched in (None, Forcing()):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
        try:
            t = Trainer(cfg, TrainerConfig(steps=6, ckpt_dir=tmp,
                                           ckpt_every=1000),
                        scheduler=sched, batch_size=2, seq_len=256,
                        device=dev)
            out = t.run(log_every=0)
            finals.append((_flat(t.params), out["restarts"]))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    (a, _), (b, restarts) = finals
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"[train] pause / resume on the card ({cfg.name}, 6 steps, "
          f"{restarts} restart): {len(a) - len(diff)} of {len(a)} "
          f"parameter leaves equal bit for bit; differing {diff}")
    if diff or restarts != 1:
        raise AssertionError("an interrupted run on the card does not land "
                             "on the uninterrupted run's parameters")


def phase_train_launcher(dev) -> None:
    """`python -m repro_torch.launch.train --arch qwen1.5-0.5b
    --full-config --steps 8 --batch 8 --seq 1024` on the card, through its
    `main` in this process: exit 0, the summary JSON printed, the flash
    kernel launched."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    counters = _zero_counters()
    rc = train.main(["--arch", TRAIN_ARCH, "--full-config", "--steps", "8",
                     "--batch", "8", "--seq", "1024", "--device", str(dev)])
    torch.cuda.synchronize()
    n = counters["flash_attention"].launches
    print(f"[train] launcher --arch {TRAIN_ARCH} --full-config --steps 8: "
          f"exit {rc}, {time.perf_counter() - t0:.2f} s; flash launches {n}")
    if rc != 0 or n == 0:
        raise AssertionError("repro_torch.launch.train --full-config failed")
    gc.collect()
    torch.cuda.empty_cache()


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
    sd_errs = phase_soft_dispatch_vs_plain(dev)
    attn_errs = phase_attention_vs_plain(dev)
    ssd_err = phase_ssd_vs_plain(dev)
    torch.cuda.synchronize()
    main_run = phase_main_path(dev)
    tune = phase_tuner(dev)
    phase_checkpoint(dev, tune["grid"])
    disp = phase_dispatch_path(dev)
    to_hard = phase_soft_to_hard(dev)
    torch.cuda.synchronize()
    aware = phase_dispatch_aware_tuner(dev, tune["res"])
    torch.cuda.synchronize()
    phase_acceptance(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phase_telemetry(dev)
    live = phase_live(dev)
    torch.cuda.synchronize()
    print(f"[live] telemetry and live phases: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ledger = phase_ledger_vs_plain(dev)
    phase_faults_workload(dev)
    slice_ex = phase_slice_examples(dev)
    torch.cuda.synchronize()
    print(f"[ledger] faults and workload phases: "
          f"{time.perf_counter() - t0:.1f} s")
    serve = phase_serving(dev, SERVE_ARCH)
    serve_launches = serve["launches"]
    serve_device = serve["device_launches"]
    phase_teacher_forced(dev, serve)
    del serve
    gc.collect()                  # free qwen's weights before mamba2's
    torch.cuda.empty_cache()
    mamba = phase_serving(dev, SSM_ARCH, SSM_PROMPTS, profile_len=1024)
    ssm_launches = mamba["launches"]
    ssm_device = mamba["device_launches"]
    phase_teacher_forced(dev, mamba, prompt_len=1000)
    phase_prefill_vs_decode(dev, mamba)
    del mamba
    gc.collect()                  # free mamba2's weights before zamba2's
    torch.cuda.empty_cache()
    zamba = phase_serving(dev, HYBRID_ARCH, HYBRID_PROMPTS,
                          profile_len=1024)
    hybrid_launches = zamba["launches"]
    hybrid_device = zamba["device_launches"]
    phase_teacher_forced(dev, zamba, prompt_len=1024)
    phase_prefill_vs_decode(dev, zamba)
    del zamba
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_launcher(dev)
    torch.cuda.synchronize()
    train_errs = phase_train_functions(dev)
    phase_train_cuts(dev)
    train = phase_train_full(dev)
    phase_train_resume(dev)
    phase_train_launcher(dev)
    torch.cuda.synchronize()
    fleet_rec, flush = phase_times(dev, main_run)
    soft_times = phase_soft_times(dev, flush)
    phase_tune_times(dev, tune["grid"])
    disp_times = phase_dispatch_times(dev, flush, disp["problem"],
                                      disp["example"])[64]
    sd_times = phase_soft_dispatch_times(dev, flush, to_hard)
    torch.cuda.synchronize()
    phase_aware_step_times(dev, aware["grid"])
    attn_times = phase_attention_times(dev, flush)
    ssd_times = phase_ssd_times(dev, flush)
    torch.cuda.synchronize()
    kernels = [fleet_rec] + _soft_records(soft_errs, soft_times,
                                          tune["launches"]) + [{
        "name": "dispatch_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dispatch_scan.cu",
        "replaces": "src/repro/kernels/dispatch_scan.py:50",
        "launches": disp["launches"], "max_abs_err": dispatch_err,
        "ms": disp_times["ms"], "plain_ms": disp_times["plain_ms"],
        "bound_ms": disp_times["bound_ms"],
        "bound_by": disp_times["bound_by"], "library_ms": None}] \
        + _soft_dispatch_records(sd_errs, sd_times, aware["launches"],
                                 to_hard["launches"]) \
        + _attention_records(attn_errs, attn_times, serve_launches,
                             hybrid_launches) + [{
            "name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:41",
            "launches": ssm_launches["ssd_scan"], "max_abs_err": ssd_err,
            **ssd_times[1024],
            **_hybrid_keys(ssd_times[("hybrid", 1024)],
                           hybrid_launches["ssd_scan"])}] \
        + _ledger_records(ledger, slice_ex)
    # the kernels on the card in the run whose calls ``launches`` counts
    device = {"fleet_scan": main_run["device_launches"],
              "soft_scan_fwd": tune["device_launches"],
              "soft_scan_bwd": tune["device_launches"],
              "dispatch_scan": disp["device_launches"],
              "soft_dispatch": to_hard["device_launches"],
              "soft_dispatch_fused_fwd": aware["device_launches"],
              "soft_dispatch_fused_bwd": aware["device_launches"],
              "flash_attention": serve_device,
              "decode_attention": serve_device, "ssd_scan": ssm_device,
              **{k: slice_ex["device_launches"] for k in LEDGER_KERNELS}}
    kernels[0]["live_launches"] = live["launches"]
    disp_rec = next(r for r in kernels if r["name"] == "dispatch_scan")
    disp_rec["live_launches"] = live["fleet_launches"]
    flash = next(r for r in kernels if r["name"] == "flash_attention")
    flash["train_launches"] = train["launches"]
    flash["train_max_grad_err"] = train_errs["flash_attention"]
    ssd = next(r for r in kernels if r["name"] == "ssd_scan")
    ssd["train_max_grad_err"] = train_errs["ssd_scan"]
    for rec in kernels:
        runs = [("", device[rec["name"]])]
        if "hybrid_launches" in rec:
            runs.append(("hybrid_", hybrid_device))
        if "train_launches" in rec:
            runs.append(("train_", {"flash_attention":
                                    train["device_launches"]}))
        if "live_launches" in rec:
            runs.append(("live_", {
                "fleet_scan": live["device_launches"]["fleet_scan"],
                "dispatch_scan":
                    live["fleet_device_launches"]["dispatch_scan"]}))
        for pre, dl in runs:
            n, counted = dl[rec["name"]], rec[f"{pre}launches"]
            if n < counted or (n > 0) != (counted > 0):
                raise AssertionError(f"{rec['name']}: {counted} counted "
                                     f"calls but {n} kernels on the card "
                                     f"({pre or 'main '}run)")
            rec[f"{pre}device_launches"] = n
    print(json.dumps({"kernels": kernels}))
    print(f"[done] chip_smoke.py: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
