"""Fleet telemetry: zero-perturbation instrumentation of the
tune/dispatch/backtest/live hot loops, structured JSONL run traces, and
a report CLI (``python -m repro_torch.obs.report <run-dir>``).

See `repro_torch.obs.registry` for the off-means-off / bit-identity
contract and `repro_torch.obs.schema` for the event catalogue.
"""

from .registry import (  # noqa: F401
    SCHEMA_VERSION,
    Counter,
    Gauge,
    Histogram,
    Run,
    capture,
    counter,
    current,
    disable,
    drain,
    enable,
    enabled,
    gauge,
    histogram,
    run_metadata,
    trace_event,
)

__all__ = [
    "SCHEMA_VERSION", "Counter", "Gauge", "Histogram", "Run",
    "capture", "counter", "current", "disable", "drain", "enable",
    "enabled", "gauge", "histogram", "run_metadata", "trace_event",
]
