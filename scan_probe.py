#!/usr/bin/env python3
"""Where the SSD chunk scan and the dispatch scan spend their time, on one
GPU.

    python3 scan_probe.py [--parent DIR]

Builds `src/repro_torch/kernels/csrc/ssd_scan.cu` and `dispatch_scan.cu`
as they are and in variants with one part taken out or changed (each a
text substitution of the source that must match, built by nvcc in
parallel into `build/scan_probe/`), then times each variant with
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
  against the source as it is, and the probe fails if one differs.

``--parent DIR`` also builds the two sources of another checkout (for
example the parent commit, unpacked with `git archive`; same C entry
points) and times them first and last, in turns with this tree's.

A variant that takes a part out computes garbage; only its time means
anything. Prints one line a variant and needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
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


def variants(ssd: str, disp: str) -> dict[str, tuple[str, str]]:
    """name -> (library, source)."""
    return {
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


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_probe: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.dispatch_scan import dispatch_scan
    from repro_torch.kernels.ssd_scan import ssd_scan

    out = ROOT / "build" / "scan_probe"
    out.mkdir(parents=True, exist_ok=True)
    todo = variants((build.CSRC / "ssd_scan.cu").read_text(),
                    (build.CSRC / "dispatch_scan.cu").read_text())
    if args.parent is not None:
        csrc = args.parent / "src" / "repro_torch" / "kernels" / "csrc"
        old = {f"{lib} parent": (lib, (csrc / f"{lib}.cu").read_text())
               for lib in ("ssd_scan", "dispatch_scan")}
        again = {f"{k} (again)": v for k, v in old.items()}
        todo = {**old, **todo, **again}

    def compile_one(item):
        i, (name, (lib, text)) = item
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        proc = subprocess.run([build.nvcc_path(), *build.flags(lib), "-o",
                               str(so), str(cu)],
                              capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        return so

    with ThreadPoolExecutor(len(todo)) as pool:
        libs = list(pool.map(compile_one, enumerate(todo.items())))

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
    first = {}         # sites -> the first exact variant's allocation
    try:
        for (name, (lib, _)), so in zip(todo.items(), libs):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
