#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port `repro_torch` on NVIDIA GPUs.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. ``<cell>`` is a ``workloads`` entry of
``BENCHMARK.json``. The run makes its inputs from the seed on the card,
warms up, measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, from a
profiled part of the window), checks the outputs against the plain
references under ``perfbench/reference/`` and prints one JSON line last
on standard output. It exits with another code than 0, and prints no
result, without enough CUDA devices, outside a checkout of the port, or
if JAX or the JAX package was loaded.
"""

import sys
import time

SETUP_T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from harness import cli

    sys.exit(cli.main(sys.argv[1:], t0=SETUP_T0))
