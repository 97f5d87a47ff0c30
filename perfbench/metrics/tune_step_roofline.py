"""Tuner step: the least time of a whole step's needed work
(`harness.roofline.tune_step`: the soft scan forward and backward, plus
the soft dispatch forward and backward where coupled) over the step's
wall time, the median over the window's jobs that ran outside the
profiler (the profiled one where there is no other), in a run whose
trace saw the card. It bounds a gain whatever kernels implement the
step."""

import statistics

from harness import roofline


def read(run):
    if run.trace is None:
        return None
    walls = run.spans.get("wall_ms_per_step") or []
    n = run.shape.get("traced_jobs", 0)
    walls = walls[n:] or walls
    if not walls:
        return None
    return 100.0 * roofline.tune_step(run.shape) / (
        statistics.median(walls) * 1e-3)
