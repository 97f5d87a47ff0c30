"""Profiling capture for kernel callers: wall-clock spans and
`torch.profiler` traces, landing in the same run trace.

Everything here degrades to a no-op when no run is active, so call
sites never need their own guards.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from .registry import current, trace_event


@contextmanager
def profiled(label: str, **attrs):
    """Time a block and emit a ``profile.span`` event. Extra keyword
    attributes ride along in the payload (e.g. rows=..., steps=...)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        trace_event("profile.span",
                    {"label": label,
                     "seconds": time.perf_counter() - t0, **attrs})


@contextmanager
def xla_trace(label: str):
    """Wrap a block in `torch.profiler` (CPU activity, and CUDA activity
    where a card is present), writing a Chrome trace under
    ``<run-dir>/profile/<label>/trace.json`` (Perfetto loadable) and
    emitting a ``profile.trace`` pointer event. The name is the
    reference's (its version wraps `jax.profiler.trace`), so call sites
    port one for one. Yields the trace directory, or None when no run is
    active (in which case no profiler is started — profiling is never
    free, so it only runs inside an explicit telemetry run)."""
    run = current()
    if run is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_dir = run.dir / "profile" / label.replace("/", "_")
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield trace_dir
    finally:
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
        trace_event("profile.trace", {"label": label, "dir": trace_dir})


def record_compiled(label: str, report) -> dict:
    """Capture a step's counted work into a ``profile.xla`` event (the
    reference's name; there it reads XLA's cost and memory analyses of a
    compiled program). ``report``: the `HLOReport` of
    `repro_torch.launch.hlo_analysis.analyze`, or its ``as_dict()``.
    Returns the payload, so benchmark code can fold it into its records.
    Works whether or not a run is active."""
    rep = report if isinstance(report, dict) else report.as_dict()
    payload = {"label": label, "flops": float(rep["flops"]),
               "bytes_accessed": float(rep["bytes_accessed"]),
               "collective_bytes": float(rep["total_collective_payload"])}
    trace_event("profile.xla", payload)
    return payload
