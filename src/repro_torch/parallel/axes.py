"""Logical-axis sharding rules and the row mesh on `torch.distributed`
(mirrors `repro.parallel.axes`).

Model code names *logical* axes (``constrain(x, "batch", "seq", None)``)
and a rule set maps them onto mesh axes; the rule sets are the
reference's, verbatim:

  TRAIN_RULES         batch over (pod, data); sequence parallelism
                      between blocks (seq over model); heads / ffn / vocab
                      over model; fsdp (param embed dim) over data
  SSM_PREFILL_RULES   like TRAIN but seq unsharded
  DECODE_RULES        batch over (pod, data); no SP
  SINGLE_DEVICE_RULES everything replicated

A mesh is a `torch.distributed.device_mesh.DeviceMesh`; its
``mesh_dim_names`` and sizes play the part of the reference's
``mesh.shape``, and a `PartitionSpec` is a plain tuple. Without an active
mesh (`use_sharding`) every annotation is the identity. Placing model
tensors under a live mesh (``constrain`` / ``named_sharding`` with one)
comes with the model-mesh slice and raises until then.

The row mesh (`row_mesh`) is what the port runs across ranks today: the
sharded tuner (`repro_torch.tune.optimizer`) splits a grid's rows over
it and reduces the fleet aggregates with the collectives below. Every
rank runs the same program (SPMD). A collective names its mesh axis as
the reference's ``jax.lax`` ones do, and an axis that no active mesh
binds raises `NameError`, as JAX's does.

The collectives run on the tensors' device through the process group's
backend: NCCL across cards, or gloo, which also takes CUDA tensors for
every collective used here (sum and max all-reduce, all-gather; checked
on the H100 with torch 2.11) by copying them through host memory.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist

LogicalRules = Mapping[str, Optional[Sequence[str] | str]]

# fsdp: weights' embed dim sharded over data (ZeRO-3 style gather at use)
TRAIN_RULES: LogicalRules = {
    "batch": ("pod", "data"),
    "seq": "model",            # sequence parallelism between blocks
    "seq_noshard": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "embed": None,             # activation embed dim
    "embed_p": "data",         # parameter embed dim (fsdp)
    "ffn": "model",
    "vocab": "model",
    "experts": None,
    "cap": None,
    "state": None,
    "layers": None,
    "cache_seq": "model",
    "apps": None,
}

SSM_PREFILL_RULES: LogicalRules = dict(TRAIN_RULES, seq=None)

DECODE_RULES: LogicalRules = dict(TRAIN_RULES, seq=None)

SINGLE_DEVICE_RULES: LogicalRules = {k: None for k in TRAIN_RULES}


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per tensor
    dimension, each ``None``, a mesh axis name or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class _Ctx(threading.local):
    mesh = None
    rules: LogicalRules = SINGLE_DEVICE_RULES


_CTX = _Ctx()


@contextlib.contextmanager
def use_sharding(mesh, rules: LogicalRules):
    """Activate a mesh (a `DeviceMesh`, or None) and a logical rule set
    for the code run inside."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> LogicalRules:
    return _CTX.rules


def _mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a mesh: the reference's ``mesh.shape``."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(name: str) -> int:
    """Size of a mesh axis under the active mesh (1 if none)."""
    return _mesh_shape(_CTX.mesh).get(name, 1)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[LogicalRules] = None,
                    mesh=None) -> PartitionSpec:
    """Translate logical axis names to a `PartitionSpec` under ``rules``.

    Mesh axes absent from ``mesh`` (or the active mesh) are dropped, and
    a mesh axis already used by an earlier dimension is not used again.
    """
    rules = rules if rules is not None else _CTX.rules
    mesh = mesh if mesh is not None else _CTX.mesh
    shape = _mesh_shape(mesh)
    spec = []
    used: set[str] = set()
    for name in logical_axes:
        axes = None if name is None else rules.get(name)
        if axes is None:
            spec.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a not in used
                     and (mesh is None or a in shape))
        used.update(axes)
        spec.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return P(*spec)


def sanitized_spec(shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]],
                   rules: Optional[LogicalRules] = None,
                   mesh=None) -> PartitionSpec:
    """`logical_to_spec` with divisibility enforced: mesh axes that do not
    evenly divide the corresponding dimension are dropped."""
    mesh = mesh if mesh is not None else _CTX.mesh
    spec = logical_to_spec(logical_axes, rules, mesh)
    if mesh is None:
        return spec
    sizes = _mesh_shape(mesh)
    out = []
    for i, axes in enumerate(spec):
        if axes is None:
            out.append(None)
            continue
        keep = []
        size = shape[i] if i < len(shape) else 1
        for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
            if a in sizes and size % sizes[a] == 0:
                keep.append(a)
                size //= sizes[a]
        out.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*out)


def _model_mesh(what: str):
    raise NotImplementedError(
        f"{what} under a live mesh places model tensors with DTensor, which "
        "comes with the model-mesh slice (ROADMAP queue 1 item 9); the row "
        "mesh of the sharded tuner needs no placement")


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical names: the identity
    with no active mesh (or no named axis)."""
    if _CTX.mesh is None or all(a is None for a in logical_axes):
        return x
    _model_mesh("constrain")


def named_sharding(*logical_axes: Optional[str], mesh=None,
                   rules: Optional[LogicalRules] = None):
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("no active mesh")
    _model_mesh("named_sharding")


def row_mesh(n: int, axis: str = "rows"):
    """1-D `DeviceMesh` over the first ``n`` ranks of the default process
    group, on the rank's own device type (``cuda`` where the card is,
    else ``cpu``).

    The batch-sharding mesh of data-parallel scenario work: the tuner's
    sharded loop (`repro_torch.tune.optimizer`) splits independent grid
    rows across it. The process group and its backend are the caller's:
    every rank calls this, as every rank calls a collective.
    """
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"row_mesh({n}) but only {world} ranks in the "
                         "default process group")
    if not dist.is_initialized():
        raise RuntimeError("row_mesh needs torch.distributed's default "
                           "process group (init_process_group)")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis,))


def _axis_group(axis_name: str):
    """The process group of ``axis_name`` under the active mesh."""
    mesh = _CTX.mesh
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise NameError(f"unbound axis name: {axis_name}")
    return mesh.get_group(axis_name)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.all_gather``: [n, *x.shape], the axis' ranks' ``x`` in
    rank order, on ``x``'s device (not differentiable)."""
    group = _axis_group(axis_name)
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts)


class _PsumId(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return _all_reduce(x, _axis_group(axis_name), dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Psum(torch.autograd.Function):
    # the group is kept from the forward: a backward may run on another
    # thread (CUDA's), outside the `use_sharding` context
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.group = _axis_group(axis_name)
        return _all_reduce(x, ctx.group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group, dist.ReduceOp.SUM), None


def psum_id(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum over the ranks of ``axis_name`` whose backward is the identity.

    Differentiating a raw `psum` sums the cotangent across ranks too. The
    cotangent of a fleet aggregate is already replicated (every rank
    forms the same downstream loss from it), so that sum over-counts by
    the rank count; with the identity backward, each rank's gradient of a
    loss built on `psum_id`-reduced aggregates equals the single
    program's per-row gradient. Valid only where every rank consumes the
    reduced value through the same expression (a replicated cotangent):
    true of the coupled fleet aggregates of `repro_torch.tune.objective`.
    """
    return _PsumId.apply(x, axis_name)


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.psum``: sum over the ranks of ``axis_name``; its backward
    sums the cotangent over them too (each rank's cotangent is its own)."""
    return _Psum.apply(x, axis_name)


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Elementwise max over the ranks of ``axis_name``, of the detached
    ``x`` (no gradient, as the reference stop-grads before its pmax)."""
    return _all_reduce(x, _axis_group(axis_name), dist.ReduceOp.MAX)
