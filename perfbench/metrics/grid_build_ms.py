"""Grid build: the median device time of `build_grid` in a request (its
market price sort and thresholds), between CUDA events recorded around
the call in the traced run."""

import statistics


def read(run):
    xs = run.spans.get("grid_build_ms") or []
    return statistics.median(xs) if xs else None
