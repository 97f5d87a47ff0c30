"""A step's work, counted on one rank (mirrors the report of
`repro.launch.hlo_analysis`).

The reference parses the compiled SPMD module's HLO text and walks its
call graph. The port has no HLO, so it counts the same quantities while
the step runs (on meta tensors in the dry run, which allocates nothing):

  flops             2*M*N*K of every matrix product (the dot products the
                    reference's ``_dot_flops`` counts), from
                    `torch.utils.flop_counter`'s formulas, per rank: an
                    operation on DTensors is counted at its global shape
                    divided by the mesh's size (the work split evenly),
                    one on a rank's local tensors (the attention kernels,
                    the MoE expert products) at its own shape; the
                    attention kernels' shape-only path adds its products
                    (`add_flops`), Sq x Skv of them, masked or not, as
                    the reference's blockwise XLA attention computes them
  bytes             operands + results of every operator, on the rank's
                    shards (no fusion is assumed: an upper estimate of
                    the memory traffic)
  collectives       per kind: count, payload bytes (the input shard; the
                    gathered result for an all-gather) and estimated wire
                    bytes with the reference's ring factors per group
                    size, from the port's transport
                    (`repro_torch.parallel.axes.comm_stats`); the counts
                    are checked against `CommDebugMode`'s

The reference's elementwise and reduction FLOPs (1 per element) are not
counted. The HLO text parser itself is not carried over (ROADMAP queue
3).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import torch

_WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,      # applied to the *result*
    "reduce-scatter": lambda g: (g - 1) / g,  # applied to the operand
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

# the transport's names -> the reference's HLO opcodes
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


@dataclasses.dataclass
class HLOReport:
    flops: float = 0.0                       # per device
    bytes_accessed: float = 0.0              # per device
    collective_payload: dict = dataclasses.field(default_factory=dict)
    collective_wire: dict = dataclasses.field(default_factory=dict)
    collective_count: dict = dataclasses.field(default_factory=dict)

    @property
    def total_collective_payload(self) -> float:
        return sum(self.collective_payload.values())

    @property
    def total_collective_wire(self) -> float:
        return sum(self.collective_wire.values())

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_payload_bytes": dict(self.collective_payload),
            "collective_wire_bytes": dict(self.collective_wire),
            "collective_counts": dict(self.collective_count),
            "total_collective_payload": self.total_collective_payload,
            "total_collective_wire": self.total_collective_wire,
        }


class _Active(threading.local):
    counter = None


_ACTIVE = _Active()


def add_flops(flops: float) -> None:
    """Matrix-product FLOPs of a kernel's shape-only path (meta tensors),
    added to the active count; nothing happens outside one."""
    if _ACTIVE.counter is not None:
        _ACTIVE.counter.flops += float(flops)


def _local_bytes(x) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x._local_tensor
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _counter_mode():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            leaves = tree_leaves((args, kwargs))
            packet = func._overloadpacket
            if packet in flop_registry:
                f = flop_registry[packet](*args, **kwargs, out_val=out)
                dts = [a for a in leaves if isinstance(a, DTensor)]
                self.flops += f / (dts[0].device_mesh.size() if dts else 1)
            self.bytes += sum(_local_bytes(a) for a in leaves) \
                + sum(_local_bytes(o) for o in tree_leaves(out))
            return out
    return Counter()


def analyze(step: Callable, *args, **kwargs) -> tuple[HLOReport, Any]:
    """Run ``step(*args, **kwargs)`` once under the counters; returns
    (report, the step's result)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.parallel.axes import COMM, comm_stats

    comm_stats(reset=True)
    counter = _counter_mode()
    _ACTIVE.counter = counter
    try:
        with CommDebugMode() as comm, counter:
            result = step(*args, **kwargs)
    finally:
        _ACTIVE.counter = None
    rep = HLOReport(flops=counter.flops, bytes_accessed=counter.bytes)
    for (kind, g), payload in COMM.by_group.items():
        k = _KIND[kind]
        rep.collective_payload[k] = rep.collective_payload.get(k, 0.0) \
            + payload
        rep.collective_wire[k] = rep.collective_wire.get(k, 0.0) \
            + payload * _WIRE_FACTOR[k](max(g, 2))
    rep.collective_count = {_KIND[k]: n for k, n in
                            comm_stats()["counts"].items()}
    seen = comm.get_total_counts()
    if seen < sum(rep.collective_count.values()):
        raise AssertionError(f"CommDebugMode saw {seen} collectives, the "
                             f"transport issued "
                             f"{sum(rep.collective_count.values())}")
    return rep, result
