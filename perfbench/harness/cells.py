"""A cell of ``BENCHMARK.json`` with the files it names: its
configuration (``configs/<config>.json``), traffic mix
(``mixes/<traffic>.json``), limits (``limits/<cell>.json``) and the
readers of its per-layer metrics (``metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


class CellError(ValueError):
    pass


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def _applies(metric: dict, cell_name: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load(root: Path, bench: dict, name: str,
         bench_dir: Path = BENCH_DIR) -> Cell:
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json "
                        f"(has {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench.get("configs", [])}
    if w["config"] not in configs:
        raise CellError(f"workload {name}: no config {w['config']!r}")

    def read(path: Path) -> dict:
        if not path.exists():
            raise CellError(f"workload {name}: missing {path}")
        return json.loads(path.read_text())

    config = read(root / configs[w["config"]]["file"])
    mix = read(bench_dir / "mixes" / f"{w['traffic']}.json")
    limits = read(bench_dir / "limits" / f"{name}.json")
    e2e = [m for m in bench.get("end_to_end", [])
           if _applies(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench.get("per_layer", [])
                 if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of ``metrics/<name>.py`` (loaded by
    path, so a dot in the name is fine)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
