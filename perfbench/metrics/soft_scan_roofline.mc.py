"""`soft_scan_roofline` in the Monte-Carlo tuner cell, where it moves that
cell's own rate: the same reader."""

from harness.cells import metric_reader

read = metric_reader("soft_scan_roofline")
