"""Elastic capacity: the arithmetic of running at a fraction of the
data-parallel world.

Partial capacity (paper §V-C) means keeping round(L * dp_total) DP slices
and raising the per-replica microbatch count so the global batch is
preserved; `capacity_schedule` maps a price series plus per-partition
shutdown plans to per-hour capacity. `resize_mesh` builds the smaller
mesh over the first ranks, and `reshard_tree` places a (restored) tree
onto it: the model axis is never resized, so only the batch sharding and
the span of the gradient reduction change.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.axes import (LogicalRules, distribute, is_dtensor,
                                       map_specs, sanitized_spec,
                                       spec_placements)


@dataclasses.dataclass(frozen=True)
class CapacityLevel:
    level: float            # fraction of DP capacity in use
    dp_size: int            # resulting data-parallel world size
    microbatches: int       # accumulation factor preserving global batch


def resize_mesh(ranks, level: float, *, model_parallel: int,
                axis_names: tuple = ("data", "model"),
                device_type: Optional[str] = None):
    """A (data, model) `DeviceMesh` over the first ``round(level * n_dp)``
    DP slices of ``ranks`` (the ranks of the default process group that
    are available, as a sequence or a count); at least one slice stays.
    On the card unless ``device_type="cpu"`` (without CUDA the default
    raises). Every rank of the default group calls it, as a collective."""
    from torch.distributed.device_mesh import DeviceMesh

    n = ranks if isinstance(ranks, int) else len(ranks)
    ids = torch.arange(n) if isinstance(ranks, int) \
        else torch.as_tensor(list(ranks))
    dp_total = n // model_parallel
    dp_keep = max(int(round(level * dp_total)), 1)
    kept = ids[:dp_keep * model_parallel].reshape(dp_keep, model_parallel)
    return DeviceMesh(resolve_device(device_type).type, kept,
                      mesh_dim_names=axis_names)


def reshard_tree(tree, mesh, logical_specs, rules: LogicalRules, *,
                 device=None):
    """Place a tree of host tensors (a restored checkpoint, or drawn
    weights) onto ``mesh`` under logical specs: each rank copies only its
    own shard of each leaf to ``device`` (default: the mesh's device
    type, the rank's current card), so no rank holds another's shard on
    the device. A mesh axis that does not divide its dimension is dropped
    (`sanitized_spec`). A DTensor leaf is first gathered whole (its
    ranks' shards, through the port's transport, which every rank of
    its mesh joins). A rank outside ``mesh`` gets None leaves."""
    from repro_torch.parallel.axes import full_tensor

    inside = mesh.get_coordinate() is not None
    if device is None:
        device = torch.device(mesh.device_type, torch.cuda.current_device()
                              ) if mesh.device_type == "cuda" \
            else torch.device(mesh.device_type)

    def place(leaf, axes):
        if is_dtensor(leaf):
            leaf = full_tensor(leaf)
        if not inside:
            return None
        spec = sanitized_spec(tuple(leaf.shape), axes, rules, mesh)
        return distribute(leaf, mesh, spec_placements(spec, mesh), device)
    return map_specs(place, tree, logical_specs)


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
