"""Tiny copies of the benchmark's cells for rehearsals on the CPU: the
same entries, files and checks at a few hours, years and steps, on the
port's plain paths."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import cells, entries  # noqa: E402

TINY = {
    "table2-aware-tune": {"hours": 48, "years": 1, "markets": 3,
                          "steps": 4},
    "de-mc-tune": {"hours": 96, "years": 3, "steps": 4},
    "de-mc-sweep": {"hours": 96, "years": 6},
}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> cells.Cell:
    c = cells.load(ROOT, bench(), name)
    c.config, c.mix = copy.deepcopy(c.config), copy.deepcopy(c.mix)
    t = TINY[name]
    c.config["hours"] = t["hours"]
    if "markets" in t:
        c.config["markets"] = c.config["markets"][:t["markets"]]
    c.mix["years_per_market"] = t["years"]
    if "steps" in t:
        c.mix["tune"]["steps"] = t["steps"]
        c.mix["tune"]["eval_stages"] = 2
    return c


def run(name: str, seed: int = 12345678901, seconds: float = 0.0,
        trace: bool = False, c: cells.Cell | None = None):
    r = entries.make_run(c or cell(name), seed=seed, seconds=seconds,
                         trace=trace, device="cpu")
    return r, entries.run(r)
