"""Elastic capacity: the arithmetic of running at a fraction of the
data-parallel world.

Partial capacity (paper §V-C) means keeping round(L * dp_total) DP slices
and raising the per-replica microbatch count so the global batch is
preserved; `capacity_schedule` maps a price series plus per-partition
shutdown plans to per-hour capacity. Resizing a live mesh and re-placing
a restored checkpoint come with the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CapacityLevel:
    level: float            # fraction of DP capacity in use
    dp_size: int            # resulting data-parallel world size
    microbatches: int       # accumulation factor preserving global batch


def capacity_plan(level: float, dp_total: int,
                  base_microbatches: int = 1) -> CapacityLevel:
    """Constant-global-batch accumulation plan for a capacity level."""
    dp_keep = max(int(round(level * dp_total)), 1)
    scale = dp_total / dp_keep
    return CapacityLevel(level=dp_keep / dp_total, dp_size=dp_keep,
                         microbatches=int(np.ceil(base_microbatches
                                                  * scale)))


def capacity_schedule(prices: np.ndarray, partition_plans: dict,
                      power_by_partition: dict) -> np.ndarray:
    """Fractional capacity per hour from per-partition shutdown plans
    (paper §V-C): at each hour a partition is off iff the price exceeds
    *its* threshold; capacity = online power / total power."""
    prices = np.asarray(prices)
    total = sum(power_by_partition.values())
    cap = np.zeros_like(prices, dtype=np.float64)
    if total <= 0.0:
        # no partitions (or zero installed power): nothing can be online
        return cap
    for name, plan in partition_plans.items():
        thr = plan["p_thresh"] if plan["viable"] else np.inf
        on = (prices <= thr).astype(np.float64)
        cap += on * power_by_partition[name]
    return cap / total
