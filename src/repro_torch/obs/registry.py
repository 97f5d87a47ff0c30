"""Telemetry core: counters/gauges/histograms, a schema-versioned JSONL
trace emitter, and `drain`, which ships device-side summaries to the
host.

Design contract (the reference's, `repro.obs.registry`):

  * **Off means off.** With no run active (`enabled()` is False) the
    instrumented call sites compute no side-outputs and copy nothing to
    the host: `drain` returns at once, and each hot path reads
    `enabled()` once per call to decide whether to build its observers
    at all.
  * **On means bit-identical.** Telemetry only ever *reads* values the
    hot loops already compute: per-hour summaries are reduced on the
    device from tensors the computation holds, stacked there, and copied
    to the host once per instrumented call; nothing feeds back into the
    math, and no kernel route changes. Enabling a run changes zero output
    bits (`tests/test_torch_obs.py` compares them byte for byte).

A *run* is a directory: ``trace.jsonl`` (one JSON event per line, first
line is the ``run.meta`` stamp — run id, git sha, torch and CUDA
versions, device kind and power limit, timestamp, schema version) plus
``metrics.json`` (final counter/gauge/histogram snapshot, written on
`disable`). Use the `capture` context manager in tests and the
``--trace out/`` flags of the port's examples; render any run dir with
``python -m repro_torch.obs.report <run-dir>``.

``run.meta`` keeps the reference's required ``jax`` and ``jaxlib``
fields, written as ``null``: the schema version stays 1 and the
reference's validator accepts the port's traces.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time
from contextlib import contextmanager
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# run metadata
# ---------------------------------------------------------------------------

_GIT_SHA: Optional[str] = None
_POWER_LIMIT: list = []          # 1-slot cache: [watts or None]


def _git_sha() -> Optional[str]:
    """Commit sha of the working tree (cached per process; None outside
    a git checkout — the stamp must never make telemetry fail)."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            _GIT_SHA = subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=Path(__file__).resolve().parent, capture_output=True,
                text=True, timeout=5, check=True).stdout.strip()
        except Exception:
            _GIT_SHA = ""
    return _GIT_SHA or None


def _power_limit_w() -> Optional[float]:
    """The first card's power limit in W, from ``nvidia-smi`` (cached per
    process; None without a card or the tool)."""
    if not _POWER_LIMIT:
        watts = None
        if torch.cuda.is_available():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=power.limit",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=10, check=True).stdout
                watts = float(out.split()[0])
            except Exception:
                watts = None
        _POWER_LIMIT.append(watts)
    return _POWER_LIMIT[0]


def run_metadata() -> dict:
    """Attribution stamp of a trace run: enough to answer "what code,
    what torch, what machine produced this number?". ``jax`` and
    ``jaxlib`` are the reference's required fields, ``null`` here."""
    import platform

    cuda = torch.cuda.is_available()
    return {
        "git_sha": _git_sha(),
        "jax": None,
        "jaxlib": None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "power_limit_w": _power_limit_w(),
        "python": platform.python_version(),
        "machine": platform.machine(),
        "timestamp": datetime.now(timezone.utc).isoformat(),
    }


# ---------------------------------------------------------------------------
# metric instruments (host-side, summary statistics only)
# ---------------------------------------------------------------------------

class Counter:
    """Monotone event count (e.g. dispatch moves)."""

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value (e.g. minimum capacity slack of the last
    dispatch)."""

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming summary (count/sum/min/max) — enough for an operator
    digest without storing every observation twice (the trace already
    has the series)."""

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def snapshot(self):
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.sum / self.count}


# ---------------------------------------------------------------------------
# the run (one trace file + live instruments)
# ---------------------------------------------------------------------------

def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy().tolist()
    if isinstance(o, Path):
        return str(o)
    return str(o)


class Run:
    """One telemetry run: a directory with ``trace.jsonl`` and (after
    `close`) ``metrics.json``. Event writes are lock-serialized, so
    emitters on several threads interleave whole lines."""

    def __init__(self, run_dir, run_id: Optional[str] = None) -> None:
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id or f"run-{int(time.time() * 1e3):x}"
        self.trace_path = self.dir / "trace.jsonl"
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = self.trace_path.open("w", encoding="utf-8")
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.meta = {"run_id": self.run_id,
                     "schema_version": SCHEMA_VERSION, **run_metadata()}
        self.event("run.meta", self.meta)

    def event(self, kind: str, payload: dict) -> None:
        rec = {"schema": SCHEMA_VERSION, "kind": kind, "ts": time.time()}
        rec.update(payload)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._fh.write(json.dumps(rec, default=_json_default) + "\n")
            self._fh.flush()

    def metrics_snapshot(self) -> dict:
        return {
            "counters": {k: c.snapshot()
                         for k, c in sorted(self.counters.items())},
            "gauges": {k: g.snapshot()
                       for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self.histograms.items())},
        }

    def close(self) -> None:
        snap = self.metrics_snapshot()
        self.event("run.close", {"n_events": self._seq,
                                 "metrics": snap})
        (self.dir / "metrics.json").write_text(
            json.dumps(snap, indent=1, default=_json_default) + "\n")
        with self._lock:
            self._fh.close()


# ---------------------------------------------------------------------------
# module-level switch (the instrumented call sites only ever touch this)
# ---------------------------------------------------------------------------

_CURRENT: list = [None]          # 1-slot box; writes are rebinding-free


def current() -> Optional[Run]:
    return _CURRENT[0]


def enabled() -> bool:
    """The global telemetry switch. Every instrumented call reads it once
    and builds its observers only when it is on."""
    return _CURRENT[0] is not None


def enable(run_dir, run_id: Optional[str] = None) -> Run:
    """Start a telemetry run writing into ``run_dir`` (created if
    missing). Only one run is active at a time; enabling over an active
    run closes it first."""
    if _CURRENT[0] is not None:
        disable()
    _CURRENT[0] = Run(run_dir, run_id=run_id)
    return _CURRENT[0]


def disable() -> None:
    """Close the active run (flushes ``metrics.json``); no-op if none."""
    run, _CURRENT[0] = _CURRENT[0], None
    if run is not None:
        run.close()


@contextmanager
def capture(run_dir, run_id: Optional[str] = None):
    """``with capture(tmpdir) as run: ...`` — enable for a block, close
    on exit even on error."""
    run = enable(run_dir, run_id=run_id)
    try:
        yield run
    finally:
        if _CURRENT[0] is run:
            disable()
        else:                     # someone re-enabled inside the block
            run.close()


def trace_event(kind: str, payload: dict) -> None:
    """Emit one structured event; silent no-op when disabled."""
    run = _CURRENT[0]
    if run is not None:
        run.event(kind, payload)


def counter(name: str) -> Counter:
    run = _CURRENT[0]
    if run is None:
        return Counter()          # throwaway: off means off
    return run.counters.setdefault(name, Counter())


def gauge(name: str) -> Gauge:
    run = _CURRENT[0]
    if run is None:
        return Gauge()
    return run.gauges.setdefault(name, Gauge())


def histogram(name: str) -> Histogram:
    run = _CURRENT[0]
    if run is None:
        return Histogram()
    return run.histograms.setdefault(name, Histogram())


# ---------------------------------------------------------------------------
# device -> host drain
# ---------------------------------------------------------------------------

def drain(kind: str, **tensors) -> None:
    """Ship named device tensors to the trace as one event.

    The reference stages an ``io_callback`` inside its jitted program;
    here the call site calls `drain` once per instrumented call, after
    reducing its per-hour or per-step observers on the device, and the
    tensors come to the host in one copy: floating and integer tensors
    alike are flattened into one float64 buffer on their device (exact
    for float32 and for integers below 2**53), copied once, and split
    back into arrays of their own dtypes and shapes. With no run active
    this returns at once and touches nothing.
    """
    if not enabled():
        return
    names = tuple(tensors)
    vals = [torch.as_tensor(v).detach() for v in tensors.values()]
    host = torch.cat([v.reshape(-1).to(torch.float64) for v in vals]) \
        .cpu().numpy() if vals else np.zeros(0)
    out, lo = {}, 0
    for name, v in zip(names, vals):
        n = v.numel()
        np_dtype = torch.empty((), dtype=v.dtype).numpy().dtype
        out[name] = host[lo:lo + n].astype(np_dtype).reshape(tuple(v.shape))
        lo += n
    run = _CURRENT[0]
    if run is not None:
        run.event(kind, out)
