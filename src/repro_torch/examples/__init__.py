"""The port's user surface, run as ``python -m repro_torch.examples.<name>``."""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path


@contextmanager
def traced(trace_dir, run_id: str):
    """An example's ``--trace DIR``: record a `repro_torch.obs` run into
    ``trace_dir`` for the block (nothing when it is None), then render
    ``digest.md`` beside ``trace.jsonl`` and ``metrics.json``."""
    if not trace_dir:
        yield
        return
    from repro_torch import obs
    from repro_torch.obs.report import render_digest

    obs.enable(trace_dir, run_id=run_id)
    try:
        yield
    finally:
        obs.disable()
        Path(trace_dir, "digest.md").write_text(render_digest(trace_dir))
        print(f"\ntelemetry run -> {trace_dir} (digest.md, trace.jsonl, "
              "metrics.json)")
