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
mesh (`use_sharding`) every annotation is the identity. Under a live mesh
model tensors are `torch.distributed.tensor.DTensor`s: `named_sharding`
turns logical names into DTensor placements (`Shard` / `Replicate`, one
per mesh dimension), and `constrain` moves a tensor to them, the port's
``with_sharding_constraint``. A mesh axis that does not divide the
dimension is dropped (`sanitized_spec`): DTensor would shard unevenly
where GSPMD pads, so the port never asks for an uneven shard.

Every placement change goes through the port's transport below:
`torch.distributed` collectives called on the ranks' local shards
(all-gather, all-reduce, reduce-scatter, all-to-all) and local chunks,
counted and timed (`comm_stats`). DTensor's own redistribution is never
called; under gloo on CUDA tensors (torch 2.11 on the H100) its
all-gather killed the process. The model code runs DTensor operations
only on operands already placed so that they move no data.

Two meshes run across ranks. The row mesh (`row_mesh`): the sharded
tuner (`repro_torch.tune.optimizer`) splits a grid's rows over it and
reduces the fleet aggregates with `psum_id` / `psum` / `pmax` /
`all_gather`. The model mesh (`repro_torch.launch.mesh`): the LLM stack
under tensor and expert parallelism, whose explicit bodies (the MoE
branches) call `all_to_all` / `all_gather_tiled` / `psum_local`. Every
rank runs the same program (SPMD). A collective names its mesh axis as
the reference's ``jax.lax`` ones do, and an axis that no active mesh
binds raises `NameError`, as JAX's does.

The collectives run on the tensors' device through the process group's
backend: NCCL across cards, or gloo, which takes CUDA tensors for every
collective used here (all-reduce, all-gather, reduce-scatter,
all-to-all; checked on the H100 with torch 2.11) by copying them through
host memory itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Mapping, Optional, Sequence

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


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: a mesh and a
    `PartitionSpec`; ``placements`` are its DTensor placements."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def spec_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a `PartitionSpec` on ``mesh``: one per mesh
    dimension, ``Shard(d)`` where the spec puts that mesh axis on tensor
    dimension ``d``, ``Replicate()`` elsewhere (and on an axis of size 1,
    where the shard is the whole tensor). A dimension over two mesh axes
    (``("pod", "data")``) is split over the first, then the second, as the
    reference's major-to-minor order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = _mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        for a in (() if axes is None else
                  (axes,) if isinstance(axes, str) else axes):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, NamedTuples and sequences
    and its matching tree of specs: logical axes (tuples of axis names)
    or `NamedSharding`s. A None leaf of a NamedTuple stays None."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(None if v is None else map_specs(fn, v, a)
                            for v, a in zip(tree, specs)))
    if isinstance(tree, (list, tuple)) and not (
            isinstance(specs, tuple) and all(
                isinstance(e, (str, type(None))) for e in specs)):
        return type(tree)(map_specs(fn, v, a) for v, a in zip(tree, specs))
    return fn(tree, specs)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated(x: torch.Tensor, mesh=None):
    """A plain tensor that every rank of ``mesh`` (default: the active
    one) holds alike, as a replicated DTensor; a DTensor is returned as
    it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    mesh = mesh if mesh is not None else _CTX.mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical names.

    The identity with no active mesh. Under one, ``x`` comes back as a
    DTensor with the placements of ``logical_axes`` (mesh axes that do
    not divide their dimension dropped): a DTensor is moved by the
    port's transport (`redistribute`), a plain tensor is taken as one that
    every rank holds alike and placed (a local chunk where it is
    sharded, no collective)."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    spec = sanitized_spec(tuple(x.shape), logical_axes)
    return redistribute(replicated(x, mesh), spec_placements(spec, mesh))


def named_sharding(*logical_axes: Optional[str], mesh=None,
                   rules: Optional[LogicalRules] = None) -> NamedSharding:
    """The `NamedSharding` of logical names on ``mesh`` (default: the
    active one); ``.placements`` are its DTensor placements."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("no active mesh")
    return NamedSharding(mesh, logical_to_spec(logical_axes, rules, mesh))


def local(x):
    """The rank's shard of a DTensor (its own storage: a write into it is
    a write into the DTensor); a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def from_local(x_local: torch.Tensor, mesh, placements, shape=None):
    """A DTensor from the rank's shard, with explicit placements (no
    collective, no check); ``shape`` is the global shape (default: even
    shards)."""
    from torch.distributed.tensor import DTensor

    kw = {}
    if shape is not None:
        shape = torch.Size(shape)
        kw = dict(shape=shape, stride=_contiguous_stride(shape))
    return DTensor.from_local(x_local, mesh, tuple(placements),
                              run_check=False, **kw)


def like(x_local: torch.Tensor, ref, shape=None):
    """``x_local`` as a DTensor with ``ref``'s mesh and placements; a
    plain tensor when ``ref`` is not a DTensor."""
    if not is_dtensor(ref):
        return x_local
    return from_local(x_local, ref.device_mesh, ref.placements, shape)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def shard_offsets(x) -> tuple[int, ...]:
    """Global index of the first element of the rank's shard of DTensor
    ``x``, one entry per dimension (even shards)."""
    off = [0] * x.ndim
    size = list(x.shape)
    mesh = x.device_mesh
    for i, p in enumerate(x.placements):
        if _is_shard(p):
            n = mesh.size(i)
            size[p.dim] //= n
            off[p.dim] += mesh.get_local_rank(i) * size[p.dim]
    return tuple(off)


def distribute(full: torch.Tensor, mesh, placements, device=None):
    """A tensor that every rank holds whole (on the host, say) as a
    DTensor on ``mesh``: each rank keeps its own chunk and copies only
    that to ``device`` (default: the tensor's), no collective."""
    part = full
    for i, p in enumerate(placements):
        if _is_shard(p):
            part = part.chunk(mesh.size(i), dim=p.dim)[
                mesh.get_local_rank(i)]
    part = part.contiguous()
    if device is not None:
        part = part.to(device)
    return from_local(part, mesh, placements, tuple(full.shape))


def full_tensor(x) -> torch.Tensor:
    """The whole tensor on every rank, through the port's transport (a
    plain tensor as it is)."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(x):
        return x
    return local(redistribute(x, [Replicate()] * x.device_mesh.ndim))


# ---------------------------------------------------------------------------
# the port's transport
# ---------------------------------------------------------------------------
#
# Placements change by the collectives of `torch.distributed` called on
# the ranks' local shards: all-gather (Shard -> Replicate), all-reduce
# (Partial -> Replicate), reduce-scatter (Partial -> Shard), all-to-all
# (Shard(a) -> Shard(b)) and a local chunk (Replicate -> Shard). DTensor's
# own redistribution (functional collectives) is never called: with gloo
# on CUDA tensors under torch 2.11 it crashes the process, where these
# direct calls run (gloo copies a CUDA tensor through host memory itself).
# On meta tensors over a fake process group the same calls move nothing
# and are counted by `CommDebugMode`, which the dry run reads.

class _CommStats(threading.local):
    def __init__(self):
        self.counts: dict = {}
        self.bytes: dict = {}
        self.by_group: dict = {}         # (kind, group size) -> bytes
        self.seconds = 0.0               # host wall time in the calls


COMM = _CommStats()


def comm_stats(reset: bool = False) -> dict:
    """``{"counts": {kind: n}, "bytes": {kind: payload bytes}}`` of the
    collectives this thread has issued under a mesh since the last reset
    (``kind``: all_gather, all_reduce, reduce_scatter, all_to_all; the
    payload is the input shard's bytes, the gathered result's for an
    all-gather, as the reference's HLO report counts them), and
    ``"seconds"``: the host's wall time inside the collective calls."""
    out = {"counts": dict(COMM.counts), "bytes": dict(COMM.bytes),
           "seconds": COMM.seconds}
    if reset:
        COMM.counts, COMM.bytes, COMM.by_group = {}, {}, {}
        COMM.seconds = 0.0
    return out


def _count(kind: str, t: torch.Tensor, n: int) -> None:
    nbytes = t.numel() * t.element_size()
    COMM.counts[kind] = COMM.counts.get(kind, 0) + 1
    COMM.bytes[kind] = COMM.bytes.get(kind, 0) + nbytes
    COMM.by_group[(kind, n)] = COMM.by_group.get((kind, n), 0) + nbytes


def _is_shard(p) -> bool:
    from torch.distributed.tensor import Shard
    return isinstance(p, Shard)


def _is_partial(p) -> bool:
    from torch.distributed.tensor import Partial
    return isinstance(p, Partial)


@contextlib.contextmanager
def _timed():
    t0 = time.perf_counter()
    try:
        yield
    finally:
        COMM.seconds += time.perf_counter() - t0


def _gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _count("all_gather", out, n)
    with _timed():
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    out = t.contiguous().clone()
    _count("all_reduce", out, dist.get_world_size(group))
    with _timed():
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def _reduce_scatter(t: torch.Tensor, dim: int, group, n: int
                    ) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _count("reduce_scatter", src, n)
    with _timed():
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _all_to_all(t: torch.Tensor, split_dim: int, cat_dim: int, group,
                n: int) -> torch.Tensor:
    """Chunk j of ``t`` along ``split_dim`` to rank j; the chunks received
    concatenated along ``cat_dim`` in rank order."""
    src = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(src)
    _count("all_to_all", src, n)
    with _timed():
        dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.unbind(0), dim=cat_dim)


def _transport(t: torch.Tensor, mesh, cur: tuple, tgt: tuple
               ) -> torch.Tensor:
    """The rank's shard under placements ``tgt`` from its shard under
    ``cur`` (even shards). Mesh dimensions are undone innermost first and
    sharded outermost first, so a tensor dimension split over two mesh
    axes keeps the major-to-minor order."""
    from torch.distributed.tensor import Replicate

    cur = list(cur)
    ndim = mesh.ndim
    for i in reversed(range(ndim)):
        c, g = cur[i], tgt[i]
        if c == g:
            continue
        group, n = mesh.get_group(i), mesh.size(i)
        if n == 1:                       # one rank: its shard is the whole
            cur[i] = g
            continue
        others = [j for j in range(ndim) if j != i]
        if _is_partial(c):
            if getattr(c, "reduce_op", "sum") != "sum":
                raise NotImplementedError(f"reduce op of {c}")
            simple = _is_shard(g) and not any(
                _is_shard(cur[j]) and cur[j].dim == g.dim for j in others)
            if simple and t.shape[g.dim] % n == 0:
                t = _reduce_scatter(t, g.dim, group, n)
                cur[i] = g
                continue
            t = _reduce(t, group)
        elif _is_shard(c):
            simple = _is_shard(g) and not any(
                _is_shard(cur[j]) and cur[j].dim in (c.dim, g.dim)
                for j in others)
            if simple and t.shape[g.dim] % n == 0:
                t = _all_to_all(t, g.dim, c.dim, group, n)
                cur[i] = g
                continue
            t = _gather(t, c.dim, group, n)
        cur[i] = Replicate()
    for i in range(ndim):
        c, g = cur[i], tgt[i]
        if c == g:
            continue
        if _is_partial(g):
            raise NotImplementedError("redistribute to a Partial placement")
        n = mesh.size(i)
        if t.shape[g.dim] % n:
            raise ValueError(f"dimension {g.dim} of size {t.shape[g.dim]} "
                             f"does not split evenly over {n} ranks")
        t = t.chunk(n, dim=g.dim)[mesh.get_local_rank(i)]
        cur[i] = g
    return t.contiguous()


class _Redistribute(torch.autograd.Function):
    """`_transport` under autograd: the backward moves the cotangent back
    to the input's placements (a Partial input takes a replicated
    cotangent as it is, as DTensor's own redistribution does)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.mesh, ctx.src, ctx.shape = (x.device_mesh, tuple(x.placements),
                                        x.shape)
        out = _transport(x.to_local(), x.device_mesh, tuple(x.placements),
                         placements)
        return from_local(out, x.device_mesh, placements, x.shape)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        g = replicated(g, ctx.mesh)
        tgt = tuple(Replicate() if _is_partial(p) else p for p in ctx.src)
        return redistribute(g, tgt), None


def redistribute(x, placements):
    """DTensor ``x`` under ``placements`` on its own mesh, moved by the
    port's transport (a no-op when they already match)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Redistribute.apply(x, placements)
    out = _transport(x.to_local(), x.device_mesh, tuple(x.placements),
                     placements)
    return from_local(out, x.device_mesh, placements, x.shape)


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


def axis_index(axis_name: str) -> int:
    """This rank's coordinate along ``axis_name`` of the active mesh
    (``jax.lax.axis_index``)."""
    _axis_group(axis_name)
    return _CTX.mesh.get_local_rank(axis_name)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.group = _axis_group(axis_name)
        return _all_to_all(x, 0, 0, ctx.group, x.shape[0])

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, 0, 0, ctx.group, g.shape[0]), None


def all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis_name, 0, 0, tiled=False)`` on a local
    tensor: ``x`` is [n, ...] for the n ranks of the axis; chunk i goes
    to rank i, and chunk j of the result came from rank j. Its backward
    is the same exchange."""
    return _AllToAll.apply(x, axis_name)


def all_gather_tiled(x: torch.Tensor, axis_name: str,
                     dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis_name, axis=dim, tiled=True)`` on a
    local tensor (forward only: the serving branch that uses it runs
    without autograd)."""
    group = _axis_group(axis_name)
    return _gather(x.detach(), dim % x.ndim, group,
                   dist.get_world_size(group))


def _pieces(ranges, lo: int, hi: int) -> list:
    """The parts of column ``ranges`` inside [lo, hi), in order."""
    return [(max(a, lo), min(b, hi)) for a, b in ranges if a < hi and b > lo]


def _width(pieces) -> int:
    return sum(b - a for a, b in pieces)


class _AllToAllColumns(torch.autograd.Function):
    """`all_to_all_columns`; its backward sends each received column's
    cotangent back to its owner, which sums those of a column sent to
    several ranks."""

    @staticmethod
    def forward(ctx, t, group, n: int, r: int, want):
        k = t.shape[-1]
        sends = [_pieces(want[j], r * k, (r + 1) * k) for j in range(n)]
        recv = [_width(_pieces(want[r], i * k, (i + 1) * k))
                for i in range(n)]
        lead = t.movedim(-1, 0)
        src = torch.cat([lead[:0]] + [lead[a - r * k:b - r * k]
                                      for ps in sends for a, b in ps])
        out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
        _count("all_to_all", src, n)
        with _timed():
            dist.all_to_all_single(out, src, recv,
                                   [_width(ps) for ps in sends],
                                   group=group)
        ctx.plan = (group, n, r * k, sends, recv, tuple(t.shape))
        return out.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, n, lo, sends, recv, shape = ctx.plan
        src = g.movedim(-1, 0).contiguous()
        back = src.new_empty((sum(_width(ps) for ps in sends),)
                             + tuple(src.shape[1:]))
        _count("all_to_all", src, n)
        with _timed():
            dist.all_to_all_single(back, src, [_width(ps) for ps in sends],
                                   recv, group=group)
        grad = g.new_zeros(shape)
        at = 0
        for ps in sends:
            for a, b in ps:
                grad[..., a - lo:b - lo] += back[at:at + b - a].movedim(0, -1)
                at += b - a
        return grad, None, None, None, None


def all_to_all_columns(t: torch.Tensor, axis_name: str,
                       want: Sequence[Sequence[tuple]]) -> torch.Tensor:
    """Columns of a tensor whose last dimension is split evenly over the
    ranks of ``axis_name``, regrouped by one all-to-all: ``t`` is this
    rank's contiguous shard; ``want[j]`` are the column ranges [a, b)
    (sorted, disjoint, global) that rank j takes. Returns this rank's
    ranges' columns side by side in their global order. A column may go
    to several ranks (a range every rank wants is an all-gather of it);
    differentiable."""
    group = _axis_group(axis_name)
    return _AllToAllColumns.apply(t, group, dist.get_world_size(group),
                                  dist.get_rank(group), want)


def psum_local(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum of a local tensor over the ranks of ``axis_name`` (forward
    only, as `all_gather_tiled`)."""
    return _reduce(x.detach(), _axis_group(axis_name))
