#!/usr/bin/env python3
"""Where the SSD chunk scan, the dispatch scan and the soft scan spend
their time, on one GPU.

    python3 scan_probe.py [--parent DIR]

Builds `src/repro_torch/kernels/csrc/ssd_scan.cu`, `dispatch_scan.cu` and
`soft_scan.cu` as they are and in variants with one part taken out or
changed (each a text substitution of the source that must match, built by
nvcc in parallel into `build/scan_probe/`), then times each variant with
`chip_smoke.py`'s device-only CUDA events (L2 flushed, medians):

- the SSD scan at mamba2-1.3b's 1024-token prefill (64 heads of P 64,
  N 128, chunk 256, bf16), with each pass's device time under the
  profiler for the build as it is (2 heads an output block; variants at
  1 and 4);
- the dispatch scan at 1, 8, 64 and 512 sites x 8760 h (`chip_smoke.py`'s
  problems: random prices and availability, demand 30-90%, dwell 4; the
  dispatch benchmark's fleet at 64 sites), in ns an hour. The variants
  that change only how it computes (float32 storage of the walk, no stop
  at the demand, another checkout's source) are also held bit for bit
  against the source as it is, and the probe fails if one differs;
- the soft-scan forward and backward (without d_p, as the tuner runs it)
  at the tuner's 256 x 2190 and the backtest's 1024 x 8760 (block_t 256,
  tau 3), with 128, 256 or 512 threads a row, at most 8, 12 or 16 hours
  a thread, the inputs staged in shared memory or not; and both kernels
  returning at once (a launch's fixed cost at the shape; its outputs are
  not checked). Each other variant must equal, bit for bit, the
  segmented mirror (`ref.soft_scan_fwd_seg_ref` / `_bwd_seg_ref`) at its
  threads and hours, run on the card, or the probe fails.

``--parent DIR`` also builds the three sources of another checkout (for
example the parent commit, unpacked with `git archive`) and times them
first and last, in turns with this tree's. Its SSD and dispatch sources
take the same C entry points; its soft scan, where it is the earlier
three- and four-launch design, takes a scratch pointer, and is called
with its own signature. Then, each in a process of its own, it profiles 20 steps of
`tune_loop` at the tuner's 256 x 2190 with each checkout's whole package
(`chip_smoke.py`'s `_profile`: wall time, the card's busy time and share,
the kernels by device time), in turns: parent, this tree, this tree,
parent.

A variant that takes a part out computes garbage; only its time means
anything. Prints one line a variant and needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# ssd_scan.cu: the tensor-core output kernel's parts, and the CUDA-core
# output kernel that runs where it does not
SSD_MMA_ON = "  const bool mma = dtype == 1 && aligned16(x) && aligned16(b) &&\n"
SSD_STATE_MMA = "  if (std::is_same<T, bf16>::value && d.mma) {\n"
SSD_CARRY = ("  if (c > 0 || d.has_h0) {\n"
             "    bf16* hsplit = xh + TILE * BPAD;")
SSD_SCORES = "    scores_mma<4 * HS>(pf, d.N, sS, SP);\n"
SSD_PRODUCT = "      for (int kk = 0; kk < kk_end; ++kk) {\n"
SSD_HEADS = "constexpr int kHeads = 2;"

# dispatch_scan.cu: the walk and the storage it sums
WALK_WARP = "        if (tid == 0) cut = walk(sw, pre, n3, (double)d, to_end);\n"
WALK_BLOCK = ("        if (tid == 0) *cut_s = walk(sw, pre, n3, (double)d, "
              "to_end);\n")
WALK_STOP = "    if (!to_end && acc >= d64) return p0 + 8;\n"
F64_PLAN = "  if (plan(S, sizeof(double), &H, &nbuf, &smem))\n"

# soft_scan.cu: threads a row, hours a thread, staging
SOFT_THREADS = "constexpr int kThreads = 256;"
SOFT_SEG = "constexpr int kSeg = 12;"
SOFT_STAGE = "constexpr bool kStage = false;"
SOFT_ROW = "  const int row = blockIdx.x;\n"
SOFT_SHAPES = ((256, 2190), (1024, 8760))
SOFT_BLOCK_T = 256


# dispatch variants that must equal each other (and the source as it is)
# bit for bit
EXACT = ("dispatch as built", "dispatch, float32 storage",
         "dispatch, walk to the end", "dispatch_scan parent",
         "dispatch_scan parent (again)")


def _sub(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise AssertionError(f"probe: {old[:60]!r} not in the source")
        text = text.replace(old, new, 1)
    return text


def variants(ssd: str, disp: str, soft: str) -> dict[str, tuple[str, str]]:
    """name -> (library, source)."""
    return {
        "soft as built": ("soft_scan", soft),
        "soft, 128 threads a row": (
            "soft_scan", _sub(soft, [(SOFT_THREADS,
                                      SOFT_THREADS.replace("256", "128"))])),
        "soft, 512 threads a row": (
            "soft_scan", _sub(soft, [(SOFT_THREADS,
                                      SOFT_THREADS.replace("256", "512"))])),
        "soft, at most 8 hours a thread": (
            "soft_scan", _sub(soft, [(SOFT_SEG,
                                      SOFT_SEG.replace("12", "8"))])),
        "soft, at most 16 hours a thread": (
            "soft_scan", _sub(soft, [(SOFT_SEG,
                                      SOFT_SEG.replace("12", "16"))])),
        "soft, empty kernels": (
            "soft_scan", soft.replace(SOFT_ROW, "  if (T > 0) return;\n"
                                      + SOFT_ROW)),
        "soft, inputs staged in shared memory": (
            "soft_scan", _sub(soft, [(SOFT_STAGE,
                                      SOFT_STAGE.replace("false", "true"))])),
        "ssd as built": ("ssd_scan", ssd),
        "ssd, 1 head a block": (
            "ssd_scan", _sub(ssd, [(SSD_HEADS, SSD_HEADS.replace("2", "1"))])),
        "ssd, 4 heads a block": (
            "ssd_scan", _sub(ssd, [(SSD_HEADS, SSD_HEADS.replace("2", "4"))])),
        "ssd, CUDA-core output kernel and chunk states": (
            "ssd_scan", _sub(ssd, [(SSD_MMA_ON, SSD_MMA_ON.replace(
                "= dtype", "= false && dtype"))])),
        "ssd, CUDA-core chunk states": (
            "ssd_scan", _sub(ssd, [(SSD_STATE_MMA, SSD_STATE_MMA.replace(
                "d.mma", "false"))])),
        "ssd, no carried-in state": (
            "ssd_scan", _sub(ssd, [(SSD_CARRY, SSD_CARRY.replace(
                "c > 0 || d.has_h0", "false"))])),
        "ssd, no C B^T": ("ssd_scan", _sub(ssd, [(SSD_SCORES, "    ;\n")])),
        "ssd, no scores x x": ("ssd_scan", _sub(ssd, [(SSD_PRODUCT, SSD_PRODUCT.replace(
            "kk < kk_end", "kk < 0"))])),
        "dispatch as built": ("dispatch_scan", disp),
        "dispatch, float32 storage": (
            "dispatch_scan", _sub(disp, [(F64_PLAN, "  if (false)\n")])),
        "dispatch, walk to the end": (
            "dispatch_scan", _sub(disp, [(WALK_STOP, "")])),
        "dispatch, no walk": (
            "dispatch_scan",
            _sub(disp, [(WALK_WARP, "        cut = 0;\n"),
                        (WALK_BLOCK, "        if (tid == 0) *cut_s = 0;\n")])),
    }


# one checkout's tuner loop under the profiler, run as
# ``python -c TUNE_STEP ROOT LABEL``
TUNE_STEP = """
import sys
root, label = sys.argv[1], sys.argv[2]
sys.path[:0] = [root + "/src", root]
import torch
import chip_smoke as cs
from repro_torch.tune import (TuneConfig, init_from_grid, problem_from_grid,
                              tune_loop)
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
grid = cs._tune_grid(dev)
problem, raw0 = problem_from_grid(grid), init_from_grid(grid)
cfg = TuneConfig(steps=20)
cs._profile(lambda: tune_loop(raw0, problem, cfg=cfg),
            f"tune_loop 20 steps, {label}", runs=1)
"""


def _soft_calls(lib: ctypes.CDLL, parent: bool, p, p_on, p_off, itau, g):
    """(forward, backward without d_p, backward with d_p, outputs) of one
    soft-scan library on the given inputs, each call through its C entry
    (the parent's with its scratch pointer)."""
    b, t = p.shape
    nc = -(-t // SOFT_BLOCK_T)
    s = torch.empty_like(p)
    carr = torch.empty((b, nc), dtype=torch.float32, device=p.device)
    d_p = torch.empty_like(p)
    sums = torch.empty((3, b), dtype=torch.float32, device=p.device)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(p.device).cuda_stream
    fwd_in = [p.data_ptr(), p_on.data_ptr(), p_off.data_ptr(),
              itau.data_ptr()]
    bwd_in = [p.data_ptr(), g.data_ptr(), p_on.data_ptr(), p_off.data_ptr(),
              itau.data_ptr(), carr.data_ptr()]
    shape = [b, t, SOFT_BLOCK_T, stream]
    scratch = []          # the parent's, alive as long as its calls
    if parent:
        for fn in (lib.soft_scan_fwd_scratch_doubles,
                   lib.soft_scan_bwd_scratch_doubles):
            fn.argtypes, fn.restype = [i32] * 3, ctypes.c_longlong
            scratch.append(torch.empty(fn(b, t, SOFT_BLOCK_T),
                                       dtype=torch.float64, device=p.device))
    fwd_scr = [x.data_ptr() for x in scratch[:1]]
    bwd_scr = [x.data_ptr() for x in scratch[1:]]
    lib.soft_scan_fwd_f32.argtypes = [ptr] * (6 + parent) + [i32] * 3 + [ptr]
    lib.soft_scan_bwd_f32.argtypes = [ptr] * (8 + parent) + [i32] * 3 + [ptr]

    def check(rc):
        if rc:
            raise RuntimeError(f"probe: soft scan launch failed: {rc}")

    def fwd():
        check(lib.soft_scan_fwd_f32(*fwd_in, *fwd_scr, s.data_ptr(),
                                    carr.data_ptr(), *shape))

    def bwd(dp=None):
        check(lib.soft_scan_bwd_f32(*bwd_in, *bwd_scr, dp, sums.data_ptr(),
                                    *shape))
    return fwd, bwd, (lambda: bwd(d_p.data_ptr())), \
        (s, carr, d_p, sums, *scratch)


def _soft_layout(text: str) -> tuple[int, int]:
    """(threads a row, most hours a thread) of a soft_scan.cu text."""
    def num(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    return num("kThreads"), num("kSeg")


def _probe_soft(name, so, text, inputs, flush) -> None:
    from repro_torch.kernels.ref import (soft_scan_bwd_seg_ref,
                                         soft_scan_fwd_seg_ref,
                                         soft_scan_seg)
    import chip_smoke as cs
    parent = "parent" in name
    lib = ctypes.CDLL(str(so))
    parts = []
    for (b, t), args in inputs.items():
        fwd, bwd, bwd_dp, out = _soft_calls(lib, parent, *args)
        ms_f = cs._cuda_ms(fwd, runs=20, flush=flush, device_only=True)
        ms_b = cs._cuda_ms(bwd, runs=20, flush=flush, device_only=True)
        parts.append(f"{b}x{t} fwd {ms_f:.4f} ms, bwd {ms_b:.4f} ms")
        if parent or "empty" in name:
            continue
        fwd()
        bwd_dp()
        nt, max_seg = _soft_layout(text)
        seg = soft_scan_seg(t, nt, max_seg)
        p, p_on, p_off, itau, g = args
        s, carr = soft_scan_fwd_seg_ref(p, p_on, p_off, itau, SOFT_BLOCK_T,
                                        nt=nt, seg=seg)
        d_p, d_on, d_off, d_it = soft_scan_bwd_seg_ref(
            p, p_on, p_off, itau, carr, g, SOFT_BLOCK_T, nt=nt, seg=seg)
        want = (s, carr, d_p, torch.stack([d_on, d_off]), d_it)
        got = (*out[:3], out[3][:2],
               out[3][2].double().sum().to(torch.float32))
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"probe: {name} differs from the "
                                 f"segmented mirror at {b}x{t}")
    exact = "" if parent or "empty" in name else \
        ", equal to its segmented mirror bit for bit"
    print(f"[probe] {name}: " + "; ".join(parts) + exact, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_probe: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.dispatch_scan import dispatch_scan
    from repro_torch.kernels.ssd_scan import ssd_scan

    out = ROOT / "build" / "scan_probe"
    out.mkdir(parents=True, exist_ok=True)
    todo = variants((build.CSRC / "ssd_scan.cu").read_text(),
                    (build.CSRC / "dispatch_scan.cu").read_text(),
                    (build.CSRC / "soft_scan.cu").read_text())
    if opts.parent is not None:
        csrc = opts.parent / "src" / "repro_torch" / "kernels" / "csrc"
        old = {f"{lib} parent": (lib, (csrc / f"{lib}.cu").read_text())
               for lib in ("ssd_scan", "dispatch_scan", "soft_scan")}
        again = {f"{k} (again)": v for k, v in old.items()}
        todo = {**old, **todo, **again}

    def compile_one(item):
        i, (name, (lib, text)) = item
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        # the parent's soft scan was built without -fmad=false
        parent_soft = lib == "soft_scan" and "parent" in name
        flags = build.flags("" if parent_soft else lib)
        proc = subprocess.run([build.nvcc_path(), *flags, "-o",
                               str(so), str(cu)],
                              capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        # ptxas' registers of each kernel, in the order it compiled them
        regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
        return so, regs

    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(compile_one, enumerate(todo.items())))

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_device()
    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    x, dt, a, bb, cc = cs._ssd_inputs(1, 1024, 64, 64, 1, 128, cs.BF16, dev,
                                      2224)
    problems = {}
    for s in (1, 8, 64, 512):
        prob = (cs._dispatch_fleet(64, dev)[1] if s == 64
                else cs._random_dispatch(s, 8760, 5.0, 4, 600 + s))
        problems[s] = ([torch.as_tensor(np.ascontiguousarray(v), device=dev)
                        for v in (prob.avail_mw, prob.rank, prob.demand_mw)],
                       prob.min_dwell_h)
    soft_in = {}
    for b, t in SOFT_SHAPES:
        p, p_on, p_off = cs._scan_inputs(b, t, 300, dev)[:3]
        g = torch.as_tensor(np.random.default_rng(307).uniform(
            0.5, 1.5, (b, t)).astype(np.float32), device=dev)
        itau = torch.tensor([1.0 / cs.SOFT_TAU], dtype=torch.float32,
                            device=dev)
        soft_in[(b, t)] = (p, p_on, p_off, itau, g)
    first = {}         # sites -> the first exact variant's allocation
    try:
        for (name, (lib, text)), (so, regs) in zip(todo.items(), built):
            if lib == "soft_scan":
                _probe_soft(f"{name} ({'/'.join(regs)} registers)", so, text,
                            soft_in, flush)
                continue
            build._loaded[lib] = ctypes.CDLL(str(so))
            if lib == "ssd_scan":
                ms = cs._cuda_ms(lambda: ssd_scan(x, dt, a, bb, cc, 256),
                                 flush=flush, device_only=True)
                passes = ""
                if name == "ssd as built":
                    us = cs._pass_times_us(
                        lambda: ssd_scan(x, dt, a, bb, cc, 256), flush)
                    passes = "; passes under the profiler (L2 flushed) " + \
                        ", ".join(f"{k} {sum(v for n, v in us.items() if k in n):.1f} us"
                                  for k in cs.SSD_PASSES)
                print(f"[probe] {name}: S 1024 bf16 {ms:.4f} ms{passes}",
                      flush=True)
            else:
                parts = []
                for s, (args, dwell) in problems.items():
                    ms = cs._cuda_ms(lambda: dispatch_scan(*args,
                                                           min_dwell=dwell),
                                     runs=3, flush=flush, device_only=True)
                    parts.append(f"{s} sites {ms:.3f} ms "
                                 f"({ms * 1e6 / 8760:.0f} ns/h)")
                    if name in EXACT:
                        got = dispatch_scan(*args, min_dwell=dwell)
                        if not torch.equal(got, first.setdefault(s, got)):
                            raise AssertionError(f"probe: {name} differs "
                                                 f"at {s} sites")
                exact = ", equal bit for bit" if name in EXACT else ""
                print(f"[probe] {name}: " + ", ".join(parts) + exact,
                      flush=True)
            torch.cuda.synchronize()
    finally:
        build._loaded.pop("ssd_scan", None)
        build._loaded.pop("dispatch_scan", None)
    if opts.parent is not None:
        for root, label in ((opts.parent, "parent"), (ROOT, "this tree"),
                            (ROOT, "this tree (again)"),
                            (opts.parent, "parent (again)")):
            proc = subprocess.run(
                [sys.executable, "-c", TUNE_STEP, str(root.resolve()),
                 label], capture_output=True, text=True, check=False)
            print(proc.stdout, end="", flush=True)
            if proc.returncode:
                raise RuntimeError(f"tune step ({label}) failed:\n"
                                   f"{proc.stderr[-3000:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
