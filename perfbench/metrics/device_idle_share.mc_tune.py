"""`device_idle_share.tune` in the Monte-Carlo tuner cell, where it moves
that cell's own rate: the same reader."""

from harness.cells import metric_reader

read = metric_reader("device_idle_share.tune")
