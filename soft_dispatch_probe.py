#!/usr/bin/env python3
"""Where the soft-dispatch kernels spend their time, on one GPU.

    python3 soft_dispatch_probe.py [--source PATH] [--against PATH]
    PYTHONPATH=<checkout>/src python3 soft_dispatch_probe.py --step

Builds `src/repro_torch/kernels/csrc/soft_dispatch.cu` (or the file at
``--source``, for example an earlier commit's copy) as it is and in
variants with one part taken out or changed (each a text substitution of
the source that must match, built by nvcc in parallel into
`build/soft_dispatch_probe/` with the source's own flags), then times each
variant's fused forward and backward with `chip_smoke.py`'s device-only
CUDA events (L2 flushed, medians of 3 runs) at the dispatch-aware tuner's
shape: 32 sites x 2190 h, tau 3, at dwell 4 and dwell 0, and its forward
at 64 sites (dwell 4). Prints the card's dependent float64 warp sum
beside them, and the as-built kernels' registers and spills.

``--against PATH`` first builds that file too (an earlier design of the
same functions) and holds the source's forward (allocation, entering dwell,
level) and backward (d avail, d keys, d demand, the two tau sums) bit for
bit against it, at one to 32 warps a group, every levels-a-round count
and n_bisect in {0, 7, 30, 31}; any difference fails.

``--step`` instead times the dispatch-aware tuner end to end with the
`repro_torch` package found first on the path (so PYTHONPATH can point it
at another checkout, to time two in turns in one call): `chip_smoke.py`'s
`tune_loop` step at 256 x 2190 (dwell 4, as `optimize` runs it; 20
steps, in turns with the uncoupled loop, and a profiled 10-step loop)
and a 200-step `optimize` with `Coupling(dispatch=)`, after a 2-step
`optimize` that builds and loads the kernels.

A variant computes garbage where a part is gone; only its time means
anything. Prints one line a variant and needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

EXP_HEAD = "__device__ __forceinline__ float exp_rn(float x) {\n"
EXPF = EXP_HEAD + "  return expf(x);\n"

# the design before this one: one group of ceil(S / 32) warps, a block
# sum a bisection step
OLD_SUM = "        fv = block_sum1(fv, red, nw, parity);\n"
OLD_LOOP = "      for (int b = 0; b < n_bisect; ++b) {\n"
OLD_WALK_END = "        lam0 = kk[oo[p]];\n"
OLD_WALK_TWICE = """        double cum2 = (double)p * 1e-300;
        int p2 = 0;
        for (; p2 < n3 - 1; ++p2) {
          cum2 += (double)wseg[oo[p2]];
          if (!(cum2 < d64)) break;
        }
        lam0 = kk[oo[min(p, p2)]];
"""
OLD_BWD_FILL = ("      const Fill f = fixed_fill(g, lam_hat, d64, it, span, "
                "red, nw, parity);\n")
OLD_BWD_FILL_READ = """      Fill f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        f.s0[j] = kk[j * S + tid];
        f.sg[j] = kk[j * S + tid + 1];
        f.fill0[j] = kk[j * S + tid + 2];
      }
      f.denom = kk[3 * S - 1]; f.step = kk[3 * S - 2]; f.c1 = kk[3 * S - 3];
      f.lam = kk[3 * S - 4]; f.r = kk[3 * S - 5];
      f.f_sum = d64; f.floor = 1e-9 * d64; f.den = d64; f.r64 = 1.0;
"""
OLD_BWD_DWELL = [("        const float mi = sigm(xm * itm);\n",
                  "        const float mi = kk[tid] * xm;\n"),
                 ("        const float cd = softplus(zc) / itc;\n",
                  "        const float cd = kk[S + tid] * zc;\n"),
                 ("        const float d_zc = (d_cd / itc) * sigm(zc);\n",
                  "        const float d_zc = (d_cd / itc) * "
                  "kk[2 * S + tid];\n")]

# this design: 2^k - 1 groups, k bisection levels a round
ROUND_WARPS = "constexpr int kRoundWarps = 16;"
MIN_TWO = "  if (k == 1 && 3 * gw <= 32) k = 2;\n"
LOOP = "      for (int b = 0; b < n_bisect; b += levels) {\n"
ROUND_SUM = ("          for (int o = 16; o > 0; o >>= 1)\n"
             "            fv += __shfl_xor_sync(kFull, fv, o);\n")
WALK = "        const int p = hard_level_pos(wsort, n3, d64);\n"
WALK_TWICE = ("        int p = hard_level_pos(wsort, n3, d64);\n"
              "        p = min(p, hard_level_pos(wsort, n3, d64 + (double)p "
              "* 1e-300));\n")
COEF_LAUNCH = "  soft_bwd_coef_kernel<kLocks>\n"
CHAIN_LAUNCH = "  soft_bwd_chain_kernel<kLocks, kThreads>\n"
CHAIN_SUMS = [("      dr = group_sum1(dr, red, gp, parity);\n", ""),
              ("(float)group_sum1(dzs, red, gp, parity)", "(float)dzs")]
MARKSTEIN = ("  const double r = fma(-q, y, x);\n"
             "  return r == 0.0 ? q : fma(r, ry, q);\n")
CD_HOIST = [("      if (kLocks && owner) cd = softplus((dwell - 1.0f) * itc) "
             "/ itc;\n", ""),
            ("            dwell = mi * fm + (1.0f - mi) * cd;\n",
             "            dwell = mi * fm + (1.0f - mi) * "
             "(softplus((dwell - 1.0f) * itc) / itc);\n")]
WALKER = ("  const int walker = nt > groups * gw * 32 ? groups * gw * 32 : "
          "0;\n")
SMALL = [("  return fwd_threads(S) <= kSmallBlock\n", "  return false\n"),
         ("  return warps_for(S) * 32 <= kSmallBlock\n", "  return false\n")]


# The cost of spreading a round's groups over the SMs of a thread block
# cluster: a chain of cluster barriers (2 or 4 blocks), every thread
# arriving at once, beside chip_smoke.py's chain of block barriers.
CLUSTER_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
template <int C>
__global__ void __cluster_dims__(C, 1, 1) cluster_chain_kernel(double* out,
                                                               int n) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < n; ++i) cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] += n;
}
extern "C" int cluster_chain(double* out, int n, int blocks, int threads,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks == 2) {
    cluster_chain_kernel<2><<<2, threads, 0, st>>>(out, n);
  } else {
    cluster_chain_kernel<4><<<4, threads, 0, st>>>(out, n);
  }
  return (int)cudaGetLastError();
}
"""


def cluster_barrier_ns(so: Path, blocks: int, threads: int, cs,
                       dev) -> float:
    """One cluster barrier's latency in a chain of them, in ns."""
    fn = ctypes.CDLL(str(so)).cluster_chain
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.zeros(4, dtype=torch.float64, device=dev)
    st = torch.cuda.current_stream(dev).cuda_stream

    def chain(n):
        if fn(buf.data_ptr(), n, blocks, threads, st):
            raise RuntimeError("cluster barrier chain launch failed")

    ms = {n: cs._cuda_ms(lambda: chain(n), runs=5) for n in (20_000, 200_000)}
    return (ms[200_000] - ms[20_000]) * 1e6 / 180_000


def _sub(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise AssertionError(f"probe: {old[:60]!r} not in the source")
        text = text.replace(old, new, 1)
    return text


def _skip_launch(src: str, head: str) -> str:
    """``src`` with the launch statement that starts with ``head`` made
    conditional on a false runtime value (the kernel is not run)."""
    return _sub(src, [(head, "  if (S < 0)\n" + head)])


def variants(src: str) -> dict[str, str]:
    """name -> source, for whichever of the two designs ``src`` is."""
    if OLD_LOOP in src:          # one block sum a bisection step
        return {
            "as built": src,
            "exp_rn as expf (sizing only)": _sub(src, [(EXP_HEAD, EXPF)]),
            "bisection without its block sum": _sub(src, [(OLD_SUM, "")]),
            "n_bisect 0 (the rest of the hour)": _sub(src, [(
                OLD_LOOP, OLD_LOOP.replace("b < n_bisect", "b < 0"))]),
            "hard-level walk twice": _sub(src, [(OLD_WALK_END,
                                                 OLD_WALK_TWICE)]),
            "bwd: fixed_fill and dwell factors read, not recomputed": _sub(
                src, [(OLD_BWD_FILL, OLD_BWD_FILL_READ)] + OLD_BWD_DWELL),
        }
    if LOOP in src:              # k levels of the bisection a round
        out = {
            "as built": src,
            "exp_rn as expf (sizing only)": _sub(src, [(EXP_HEAD, EXPF)]),
            "rounds without their warp sums": _sub(src, [(ROUND_SUM, "")]),
            "n_bisect 0 (the rest of the hour)": _sub(src, [(
                LOOP, LOOP.replace("b < n_bisect", "b < 0"))]),
            "hard-level walk twice": _sub(src, [(WALK, WALK_TWICE)]),
        }
        for w, what in ((32, "k = 5 at 32 sites, 4 at 64"),
                        (8, "k = 3 at 32 sites, 2 at 64"),
                        (4, "k = 2 at 32 and 64 sites")):
            out[f"{w} warps a round ({what})"] = _sub(src, [(
                ROUND_WARPS, ROUND_WARPS.replace("16", str(w)))])
        out["one level a round"] = _sub(src, [
            (ROUND_WARPS, ROUND_WARPS.replace("16", "0")), (MIN_TWO, "")])
        out["bwd: coefficient kernel alone"] = _skip_launch(src, CHAIN_LAUNCH)
        out["dwell countdown at the dwell update (not during the walk)"] = \
            _sub(src, CD_HOIST)
        out["thread 0 walks (no walker warp)"] = _sub(
            src, [(WALKER, "  const int walker = 0;\n")])
        out["every block built for 1024 threads"] = _sub(src, SMALL)
        out["bwd: chain without its two sums"] = _sub(src, CHAIN_SUMS)
        out["bwd: div_rn as one product (sizing only)"] = _sub(
            src, [(MARKSTEIN, "  return q;\n")])
        out["bwd: chain kernel alone"] = _skip_launch(src, COEF_LAUNCH)
        return out
    raise AssertionError("probe: the source matches no known design")


# the backward's scratch buffers by (S, T, dwell), shared by every build, so
# that a variant without the coefficient pass reads real coefficients
SCRATCH: dict = {}


class Kernels:
    """ctypes calls of one build of soft_dispatch.cu (either design)."""

    def __init__(self, so: Path):
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.scratch = hasattr(lib, "soft_dispatch_bwd_scratch_floats")
        lib.soft_dispatch_fused_fwd_f32.argtypes = [ptr] * 9 + [i32] * 4 \
            + [ptr]
        lib.soft_dispatch_fused_bwd_f32.argtypes = \
            [ptr] * (14 if self.scratch else 13) + [i32] * 3 + [ptr]
        lib.soft_dispatch_fused_fwd_f32.restype = i32
        lib.soft_dispatch_fused_bwd_f32.restype = i32
        if self.scratch:
            lib.soft_dispatch_bwd_scratch_floats.argtypes = [i32] * 3
            lib.soft_dispatch_bwd_scratch_floats.restype = ctypes.c_longlong
        self.lib = lib

    def fwd(self, x: dict, dwell: int, n_bisect: int = 30):
        s, t = x["avail"].shape
        st = torch.cuda.current_stream().cuda_stream
        err = self.lib.soft_dispatch_fused_fwd_f32(
            *(x[k].data_ptr() for k in ("avail", "keys", "order", "demand",
                                        "it", "itm", "alloc", "dwin",
                                        "lam")),
            s, t, dwell, n_bisect, st)
        if err:
            raise RuntimeError(f"forward: CUDA error {err}")

    def bwd(self, x: dict, dwell: int, d_keys=None):
        s, t = x["avail"].shape
        st = torch.cuda.current_stream().cuda_stream
        ptrs = [x[k].data_ptr() for k in ("avail", "keys", "demand", "alloc",
                                          "dwin", "lam", "g", "it", "itm",
                                          "d_av")]
        ptrs += [None if d_keys is None else d_keys.data_ptr(),
                 x["d_de"].data_ptr(), x["sums"].data_ptr()]
        if self.scratch:
            key = (s, t, dwell)
            if key not in SCRATCH:
                SCRATCH[key] = torch.empty(
                    self.lib.soft_dispatch_bwd_scratch_floats(s, t, dwell),
                    dtype=torch.float32, device=x["avail"].device)
            ptrs.append(SCRATCH[key].data_ptr())
        err = self.lib.soft_dispatch_fused_bwd_f32(*ptrs, s, t, dwell, st)
        if err:
            raise RuntimeError(f"backward: CUDA error {err}")


def _problem(cs, s: int, t: int, tau: float, seed: int, dev,
             zero=()) -> dict:
    cpu = cs._soft_dispatch_case(s, t, 5.0, seed=seed, zero_hours=zero)
    x = dict(zip(("avail", "keys", "order", "demand", "g"),
                 (a.to(dev) for a in cpu)))
    x["it"], x["itm"] = (a.to(dev) for a in cs._inv_taus(tau))
    for k in ("alloc", "dwin", "d_av"):
        x[k] = torch.empty((s, t), device=dev)
    x["lam"], x["d_de"] = (torch.empty(t, device=dev) for _ in range(2))
    x["sums"] = torch.empty(2, dtype=torch.float64, device=dev)
    return x


# (S, T, dwell, tau, n_bisect, zero-demand hours): one to 32 warps a
# group, k = 5 .. 1
AGAINST_CASES = [(1, 300, 0, 5.0, 30, ()), (5, 333, 4, 2.0, 7, ()),
                 (8, 500, 6, 0.5, 30, ()), (16, 700, 3, 20.0, 31, ()),
                 (8, 300, 4, 3.0, 30, (0, 50, 51, 299)),
                 (32, 2190, 4, 3.0, 30, ()), (32, 2190, 4, 0.3, 30, ()),
                 (32, 2190, 0, 3.0, 30, ()), (32, 600, 4, 3.0, 0, ()),
                 (32, 600, 4, 3.0, 31, ()), (33, 300, 4, 3.0, 30, ()),
                 (45, 300, 4, 1.0, 7, ()), (64, 300, 4, 3.0, 30, ()),
                 (130, 200, 0, 2.0, 31, ()), (600, 60, 4, 3.0, 30, ()),
                 (1024, 40, 4, 3.0, 30, ())]


def hold_against(cs, new: Kernels, old: Kernels, dev) -> None:
    for i, (s, t, dwell, tau, nb, zero) in enumerate(AGAINST_CASES):
        xs = [_problem(cs, s, t, tau, 40 + i, dev, zero) for _ in range(2)]
        dk = [torch.empty((t, 3 * s), device=dev) for _ in range(2)]
        for lib, x in zip((new, old), xs):
            lib.fwd(x, dwell, nb)
        torch.cuda.synchronize()
        diff = [k for k in ("alloc", "dwin", "lam")
                if not torch.equal(xs[0][k], xs[1][k])]
        for lib, x, d in zip((new, old), xs, dk):
            for k in ("alloc", "dwin", "lam"):   # the new residuals for both
                x[k] = xs[0][k]
            lib.bwd(x, dwell, d)
        torch.cuda.synchronize()
        diff += [k for k in ("d_av", "d_de", "sums")
                 if not torch.equal(xs[0][k], xs[1][k])]
        if not torch.equal(dk[0], dk[1]):
            diff.append("d_keys")
        label = f"{s} x {t}, dwell {dwell}, tau {tau}, n_bisect {nb}"
        if diff:
            raise AssertionError(f"probe: {label}: {', '.join(diff)} differ "
                                 "from the earlier design's")
        print(f"[probe] {label}: forward and backward equal the earlier "
              "design's bit for bit", flush=True)


def time_step(cs) -> int:
    import time

    import repro_torch
    from repro_torch.dispatch import DispatchConfig
    from repro_torch.tune import Coupling, TuneConfig, optimize

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_device()
    print(f"[step] repro_torch from {Path(repro_torch.__file__).parent}")
    grid = cs._tune_grid(dev)
    dcfg = DispatchConfig(demand_frac=0.3, migrate_cost=5.0, min_dwell_h=4)
    optimize(grid, TuneConfig(steps=2, coupling=Coupling(dispatch=dcfg)),
             device=dev)                     # builds and loads the kernels
    cs.phase_aware_step_times(dev, grid, steps=20)
    t0 = time.perf_counter()
    res = optimize(grid, TuneConfig(steps=200,
                                    coupling=Coupling(dispatch=dcfg)),
                   device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[step] optimize with Coupling(dispatch=) 256 x 2190 x 200 "
          f"steps: {wall:.2f} s ({wall / 200 * 1e3:.1f} ms a step); tuned "
          f"{res.dispatch['cpc_tuned']:.4f}, swept "
          f"{res.dispatch['cpc_swept']:.4f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=None,
                    help="the soft_dispatch.cu to probe (default: the "
                         "checkout's)")
    ap.add_argument("--against", type=Path, default=None,
                    help="an earlier soft_dispatch.cu to hold the source "
                         "against, bit for bit")
    ap.add_argument("--step", action="store_true",
                    help="time the dispatch-aware tuner step and optimize "
                         "instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("soft_dispatch_probe: CUDA is not available", file=sys.stderr)
        return 1
    if args.step:                   # PYTHONPATH's checkout first, if set
        sys.path.append(str(ROOT / "src"))
    else:
        sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if args.step:
        return time_step(cs)
    from repro_torch.kernels import build

    out = ROOT / "build" / "soft_dispatch_probe"
    out.mkdir(parents=True, exist_ok=True)
    src_path = args.source or build.CSRC / "soft_dispatch.cu"
    todo = variants(src_path.read_text())
    if args.against:
        todo["against"] = args.against.read_text()
    todo["clusters"] = CLUSTER_SRC

    def compile_one(item):
        i, (name, text) = item
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        proc = subprocess.run(
            [build.nvcc_path(), *build.flags("soft_dispatch"), "-o", str(so),
             str(cu)], capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        if name == "as built":
            for line in (proc.stdout + proc.stderr).splitlines():
                if "registers" in line or "spill" in line or "entry" in line:
                    print(f"[build] {line.strip()}")
        return so

    with ThreadPoolExecutor(len(todo) + 1) as pool:
        probe = pool.submit(cs._build_probe)
        libs = dict(zip(todo, pool.map(compile_one, enumerate(todo.items()))))
        probe.result()

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_device()
    print(f"[probe] source {src_path}")
    clusters = libs.pop("clusters")
    print(f"[probe] block barrier, 512 threads: "
          f"{cs._barrier_ns(dev, 512):.1f} ns")
    for blocks in (2, 4):
        print(f"[probe] {blocks}-block cluster barrier, 512 threads a block: "
              f"{cluster_barrier_ns(clusters, blocks, 512, cs, dev):.1f} ns")
    kernels = {name: Kernels(so) for name, so in libs.items()}
    if args.against:
        hold_against(cs, kernels.pop("against"), kernels["as built"], dev)
    print(f"[probe] dependent float64 warp sum: {cs._warp_sum_ns(dev):.2f} ns")
    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    t = 2190
    x = _problem(cs, 32, t, 3.0, 1, dev)
    x64 = _problem(cs, 64, t, 3.0, 1, dev)
    built = kernels["as built"]
    for name, lib in kernels.items():
        row = []
        for dwell in (4, 0):
            f_ms = cs._cuda_ms(lambda: lib.fwd(x, dwell), runs=3,
                               flush=flush, device_only=True)
            built.fwd(x, dwell)       # every variant's backward reads the
            built.bwd(x, dwell)       # built kernels' residuals (and scratch)
            b_ms = cs._cuda_ms(lambda: lib.bwd(x, dwell), runs=3,
                               flush=flush, device_only=True)
            row.append(f"dwell {dwell}: fwd {f_ms:.3f} ms "
                       f"({f_ms * 1e6 / t:.0f} ns an hour), bwd {b_ms:.3f} "
                       f"ms ({b_ms * 1e6 / t:.0f} ns an hour)")
        f64 = cs._cuda_ms(lambda: lib.fwd(x64, 4), runs=3, flush=flush,
                          device_only=True)
        row.append(f"64 sites, dwell 4: fwd {f64:.3f} ms")
        print(f"[probe] {name}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
