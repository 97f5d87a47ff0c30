"""Tuner step: the host's enqueue time a step, from a job's start to the
return of `tune_loop` (before the job's results are read back), over its
steps; the median over the window's jobs that ran outside the profiler
(the profiled one where there is no other)."""

import statistics


def read(run):
    xs = run.spans.get("enqueue_ms_per_step") or []
    n = run.shape.get("traced_jobs", 0)
    xs = xs[n:] or xs
    return statistics.median(xs) if xs else None
