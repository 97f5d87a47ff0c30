"""The run of one cell: its inputs, the entry its mix names, and what the
run hands the report.

An entry is a general driver, ``harness/entry_<name>.py`` with a
``run(Run) -> Outcome`` and the set ``MIX_KEYS`` of the mix keys it
reads, found by the name in the mix's ``entry``: a new entry is a new
file. A mix with a key its entry does not read is refused, so no mix
states traffic that the run would not send. Everything an entry needs about sizes, policies
and arrivals comes from the configuration and the mix, so a new cell of
an existing entry is data alone.
"""

from __future__ import annotations

import dataclasses
import importlib
import re
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from harness.cells import Cell


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                      # the process's start (set-up clock)

    def rng(self, stream: int) -> np.random.Generator:
        """A host generator of the run's seed, one stream a purpose."""
        return np.random.default_rng([int(self.seed) % (2 ** 64), stream])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    e2e: dict                          # end-to-end metric -> value
    checks: dict                       # name -> (value, limit)
    memory_peak_bytes: int
    shape: dict                        # sizes the metric readers use
    spans: dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None     # harness.trace.Trace of the slice
    check_s: float = 0.0               # the reference's time

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            np.isfinite(v) and v <= lim for v, lim in self.checks.values())


def make_run(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, t0: Optional[float] = None) -> Run:
    return Run(cell=cell, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=torch.device(device),
               t0=time.perf_counter() if t0 is None else t0)


def entry_module(name: str):
    """The module ``harness/entry_<name>.py``."""
    path = Path(__file__).with_name(f"entry_{name}.py")
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name) or not path.exists():
        raise ValueError(f"unknown entry {name!r}: no {path.name}")
    return importlib.import_module(f"harness.entry_{name}")


def run(r: Run) -> Outcome:
    mod = entry_module(r.cell.mix["entry"])
    unread = sorted(set(r.cell.mix) - mod.MIX_KEYS)
    if unread:
        raise ValueError(f"the {r.cell.mix['entry']} entry reads no mix key "
                         f"{', '.join(unread)}")
    return mod.run(r)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
