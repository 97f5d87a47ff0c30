"""`tune_host_ms_per_step` in the Monte-Carlo tuner cell, where it moves
that cell's own rate: the same reader."""

from harness.cells import metric_reader

read = metric_reader("tune_host_ms_per_step")
