"""Command line of the benchmark: find the cell, check the device, run
the cell's entry, report.

Exit codes: 0 a result was printed (``correct`` may still be false), 2
bad arguments or a cell ``BENCHMARK.json`` does not hold, 3 not enough
CUDA devices, 4 the port is not in this checkout, 5 a forbidden module
was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names the run may never hold: JAX and the JAX package
# the port was made from, compared as whole names (`repro_torch` begins
# with `repro`)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port builds its kernels into ``build/repro_torch_kernels/``; the
    rest is set here so that nothing lands outside it."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"      # keep libraries from loading JAX
    os.environ["USE_JAX"] = "0"


def _fail(code: int, msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def main(argv, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = _parse(argv)
    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.exists():
        return _fail(2, f"no BENCHMARK.json at {ROOT}")
    from harness import cells
    try:
        cell = cells.load(ROOT, json.loads(bench_file.read_text()),
                          args.workload)
    except cells.CellError as e:
        return _fail(2, str(e))
    _cache_dirs()

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(3, f"cell {cell.name} needs {cell.chips} CUDA "
                        f"device(s), {n} available")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        return _fail(4, f"the port (src/repro_torch) is not in {ROOT}")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401

    from harness import entries, report
    run = entries.make_run(cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace),
                           device=torch.device("cuda", 0), t0=t0)
    outcome = entries.run(run)
    print(f"perfbench: set-up {outcome.setup_s:.2f} s, window "
          f"{outcome.window_s:.2f} s, check {outcome.check_s:.2f} s",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        return _fail(5, f"forbidden modules loaded: {', '.join(bad)}")
    line = report.result_line(run, outcome)
    report.print_checks(outcome.checks)
    print(json.dumps(line), flush=True)
    return 0
