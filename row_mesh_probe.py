#!/usr/bin/env python3
"""Where the sharded tuner's agreement with the single program comes from,
on one GPU.

    python3 row_mesh_probe.py

Builds the tuner's kernels, then twice — with the objective's sums over
rows in float64 (as built: `repro_torch.tune.objective._SUM_DTYPE`) and
in float32 — runs the dispatch-aware `optimize` on `chip_smoke.py`'s
tuner grid (256 rows x 2190 h x 200 steps) as one program, and
`chip_smoke.py`'s `phase_row_mesh` against it: two gloo ranks on the card
under `ExecutionPlan(mode="sharded")`, whose lines give the raw
parameters' largest difference and the rows equal bit for bit. A form
that misses the phase's gates is reported, not raised. Exits non-zero
without CUDA.
"""

from __future__ import annotations

import functools
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs

SOURCES = ("fleet_scan", "soft_scan", "soft_dispatch", "dispatch_scan")


def _rank(sum_dtype: str, *args) -> None:
    """`chip_smoke._row_mesh_rank` with the objective's sums over rows in
    ``sum_dtype``."""
    cs._import_port()
    from repro_torch.tune import objective
    objective._SUM_DTYPE = getattr(torch, sum_dtype)
    cs._row_mesh_rank(*args)


def main() -> int:
    if not torch.cuda.is_available():
        print("row_mesh_probe: CUDA is not available", file=sys.stderr)
        return 1
    cs._import_port()
    from repro_torch.dispatch import DispatchConfig
    from repro_torch.kernels import build
    from repro_torch.tune import Coupling, TuneConfig, objective, optimize

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_device()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.build, SOURCES))
    grid = cs._tune_grid(dev)
    cfg = TuneConfig(steps=cs.ROW_MESH_STEPS, coupling=Coupling(
        dispatch=DispatchConfig(**cs.AWARE_DCFG)))
    row_mesh_rank = cs._row_mesh_rank
    for sum_dtype in ("float64", "float32"):
        objective._SUM_DTYPE = getattr(torch, sum_dtype)
        t0 = time.perf_counter()
        single = optimize(grid, cfg, device=dev)
        torch.cuda.synchronize()
        print(f"[probe] sums over rows in {sum_dtype}: the single program "
              f"{time.perf_counter() - t0:.2f} s")
        cs._row_mesh_rank = functools.partial(_rank, sum_dtype)
        try:
            cs.phase_row_mesh(dev, {"res": single})
        except AssertionError as e:
            print(f"[probe] sums over rows in {sum_dtype}: a gate missed: "
                  f"{str(e).strip().splitlines()[0]}")
        finally:
            cs._row_mesh_rank = row_mesh_rank
    print(f"[probe] row_mesh_probe.py: {time.perf_counter() - cs.T_START:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
