"""The result line and the checks printed beside their limits."""

from __future__ import annotations

import sys

import torch

from harness import cells
from harness.entries import Outcome, Run


def _device(r: Run, o: Outcome) -> dict:
    dev = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(r.device)
                    if r.device.type == "cuda" else "cpu"),
           "count": r.cell.chips, "memory_peak_bytes": o.memory_peak_bytes}
    if r.trace and o.trace is not None:
        dev["busy_s"] = o.trace.busy_s
        dev["window_s"] = o.trace.window_s
    return dev


def metrics(r: Run, o: Outcome) -> dict:
    """``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
    per-layer metrics, each from its reader (a reader that finds nothing
    to read returns None and the metric is left out)."""
    out = {}
    if not r.trace:
        for m in r.cell.end_to_end:
            v = o.setup_s if m["name"] == "setup_s" else o.e2e.get(m["name"])
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in r.cell.per_layer:
        v = cells.metric_reader(m["name"])(o)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(r: Run, o: Outcome) -> dict:
    line = {"correct": bool(o.correct), "attempted": o.attempted,
            "failed": o.failed, "metrics": metrics(r, o),
            "device": _device(r, o)}
    if r.trace and o.trace is not None:
        line["breakdown"] = {"device_ops": o.trace.device_ops(),
                             "idle_gaps": o.trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in o.checks.items()}
    return line


def print_checks(checks: dict) -> None:
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
