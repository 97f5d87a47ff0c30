"""Step functions with production shardings, for every cell kind (mirrors
`repro.launch.steps`).

`build_step(cfg, shape, mesh)` returns (step, abstract_args, rules):

  train    -> train_step(params, opt_state, batch) -> (params', opt', stats)
              loss + gradient + AdamW update
  prefill  -> prefill_step(params, batch) -> (logits, caches)
  decode   -> serve_step(params, tokens, caches, positions)
              -> (logits, caches)

``abstract_args`` are meta-device DTensors on ``mesh`` with the step's
argument placements: they allocate nothing (the dry run runs the step on
them over a fake process group). The same step runs real DTensors on a
live mesh: it enters ``use_sharding(mesh, rules)``, places each argument
as the reference's ``in_shardings`` do (a tensor under other placements
is moved by the port's transport, a plain tensor is taken as one every
rank holds) and places the caches it returns as its ``out_shardings``;
batch, token and cache placements are taken at the arguments' own
shapes (a cache sized for a prompt plus its generation budget).

Rules are chosen per family and shape, as the reference's: attention
families train and prefill with sequence parallelism between blocks;
SSM / hybrid keep the sequence whole; decode shards the batch and the KV
cache (by positions, or by heads where they divide the model axis: the
aligned cache); a batch too small to shard (long_500k) shards positions
or heads only. Argument placements drop a mesh axis that does not divide
its dimension.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.configs.inputs import input_specs
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.model import (cache_specs, decode_step, init_cache,
                                      init_params, loss_fn, param_specs,
                                      prefill)
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, tree_leaves, tree_map)
from repro_torch.parallel.axes import (DECODE_RULES, LogicalRules,
                                       NamedSharding, SSM_PREFILL_RULES,
                                       TRAIN_RULES, from_local, map_specs,
                                       redistribute, replicated,
                                       sanitized_spec, use_sharding)

LONGCTX_RULES: LogicalRules = dict(DECODE_RULES, batch=None)
# optimizer moments: ZeRO-1 over the pod axis on top of fsdp (kept for
# parity; the reference measured and refuted it as a pure-GSPMD change)
MOMENT_RULES: LogicalRules = dict(TRAIN_RULES, embed_p=("pod", "data"))
# aligned-cache decode: KV heads shard evenly over `model`, cache
# positions stay local -> the rolling-slot update is collective-free
DECODE_HEADS_RULES: LogicalRules = dict(DECODE_RULES, cache_seq=None)
LONGCTX_HEADS_RULES: LogicalRules = dict(DECODE_HEADS_RULES, batch=None)


def rules_for(cfg: ModelConfig, shape: ShapeSpec,
              tp: int = 16) -> LogicalRules:
    if shape.kind == "decode":
        heads_even = (cfg.n_heads and cfg.cache_heads % tp == 0
                      and cfg.n_heads % cfg.cache_heads == 0)
        # batch must divide the dp submesh; long_500k has batch 1
        if shape.global_batch < 32:
            return LONGCTX_HEADS_RULES if heads_even else LONGCTX_RULES
        return DECODE_HEADS_RULES if heads_even else DECODE_RULES
    if cfg.family in ("ssm", "hybrid"):
        if shape.kind == "train":
            return TRAIN_RULES
        return SSM_PREFILL_RULES
    return TRAIN_RULES


def shardings_for(tree_specs: Any, tree_abstract: Any, mesh,
                  rules: LogicalRules) -> Any:
    """Logical-axes tree -> `NamedSharding` tree (axes that do not divide
    their dimension dropped), over ``tree_abstract``'s leaves."""
    return map_specs(lambda leaf, axes: NamedSharding(
        mesh, sanitized_spec(tuple(leaf.shape), axes, rules, mesh)),
        tree_abstract, tree_specs)


def _meta(t) -> torch.Tensor:
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameters' shapes and dtypes as meta tensors (nothing drawn:
    the initialiser runs under `FakeTensorMode`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(torch.Generator().manual_seed(0), cfg)
    return map_specs(lambda t, _: _meta(t), fake, param_specs(fake))


def abstract_opt_state(cfg: ModelConfig, opt: AdamWConfig) -> AdamWState:
    aparams = abstract_params(cfg)
    st = adamw_init(aparams, opt)
    return AdamWState(_meta(st.step), st.mu, st.nu)


def attach(tree: Any, shards: Any) -> Any:
    """Meta DTensors with the shapes of ``tree``'s leaves and the
    placements of ``shards`` (`NamedSharding`s): the abstract arguments."""
    def f(leaf, sh):
        mesh, pl = sh.mesh, sh.placements
        shape = list(leaf.shape)
        for i, p in enumerate(pl):
            if hasattr(p, "dim"):
                shape[p.dim] //= mesh.size(i)
        loc = torch.empty(shape, dtype=leaf.dtype, device="meta")
        return from_local(loc, mesh, pl, tuple(leaf.shape))
    return map_specs(f, tree, shards)


def place(tree: Any, shards: Any) -> Any:
    """``tree``'s leaves under the placements of ``shards``: a DTensor
    moved by the port's transport, a plain tensor (the same on every
    rank) cut into the rank's shard."""
    def f(leaf, sh):
        return redistribute(replicated(leaf, sh.mesh), sh.placements)
    return map_specs(f, tree, shards)


def _batch_shardings(batch: dict, mesh, rules: LogicalRules) -> dict:
    return {k: NamedSharding(mesh, sanitized_spec(
        tuple(v.shape), ("batch",) + (None,) * (v.ndim - 1), rules, mesh))
        for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig):
    """Loss -> gradient -> AdamW. ``cfg.train_microbatches > 1`` sums the
    gradients of microbatch slices of the global batch (float32), as the
    reference's step."""
    n_micro = cfg.train_microbatches

    def grad_of(params, mb):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, mb, cfg)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        return tree_map(lambda _: next(grads), params), metrics

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            grads, metrics = grad_of(params, batch)
        else:
            grads = None
            for i in range(n_micro):
                mb = {k: v.chunk(n_micro, dim=0)[i]
                      for k, v in batch.items()}
                g, metrics = grad_of(params, mb)
                g = tree_map(lambda x: x.float() / n_micro, g)
                grads = g if grads is None else tree_map(
                    lambda a, b: a + b, grads, g)
        with torch.no_grad():
            detached = tree_map(lambda p: p.detach(), params)
            new_params, new_opt, stats = adamw_update(grads, opt_state,
                                                      detached, opt)
        return new_params, new_opt, {**{k: v.detach() for k, v in
                                        metrics.items()}, **stats}
    return train_step


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               opt: Optional[AdamWConfig] = None):
    """Returns (step, abstract_args, rules): ``step(*args)`` runs the
    cell's step under ``use_sharding(mesh, rules)``; ``abstract_args``
    are meta DTensors placed as the step's arguments."""
    rules = rules_for(cfg, shape, tp=mesh_shape(mesh).get("model", 1))
    ins = input_specs(cfg, shape)
    aparams = abstract_params(cfg)
    pshard = shardings_for(param_specs(aparams), aparams, mesh, rules)

    if shape.kind == "train":
        opt = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
        aopt = abstract_opt_state(cfg, opt)
        oshard = AdamWState(
            NamedSharding(mesh, ()),
            shardings_for(param_specs(aopt.mu), aopt.mu, mesh, rules),
            shardings_for(param_specs(aopt.nu), aopt.nu, mesh, rules))
        bshard = _batch_shardings(ins["batch"], mesh, rules)
        train = make_train_step(cfg, opt)

        def train_step(params, opt_state, batch):
            with use_sharding(mesh, rules):
                return train(place(params, pshard), place(opt_state, oshard),
                             place(batch, _batch_shardings(batch, mesh,
                                                           rules)))
        args = (attach(aparams, pshard), attach(aopt, oshard),
                attach(ins["batch"], bshard))
        return train_step, args, rules

    if shape.kind == "prefill":
        bshard = _batch_shardings(ins["batch"], mesh, rules)
        acaches = init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
        cshard = shardings_for(cache_specs(cfg), acaches, mesh, rules)
        seq_sharded = cfg.family not in ("ssm", "hybrid")

        def prefill_step(params, batch, max_seq=None):
            with use_sharding(mesh, rules), torch.no_grad():
                logits, caches = prefill(
                    place(params, pshard),
                    place(batch, _batch_shardings(batch, mesh, rules)),
                    cfg, max_seq=max_seq, seq_sharded=seq_sharded)
                return logits, place(caches, shardings_for(
                    cache_specs(cfg), caches, mesh, rules))
        args = (attach(aparams, pshard), attach(ins["batch"], bshard))
        return prefill_step, args, rules

    if shape.kind == "decode":
        acaches = ins["caches"]
        cshard = shardings_for(cache_specs(cfg), acaches, mesh, rules)
        tshard = _batch_shardings({"t": ins["tokens"],
                                   "p": ins["positions"]}, mesh, rules)

        def serve_step(params, tokens, caches, positions):
            with use_sharding(mesh, rules), torch.no_grad():
                ts = _batch_shardings({"t": tokens, "p": positions}, mesh,
                                      rules)
                return decode_step(
                    place(params, pshard), place(tokens, ts["t"]),
                    place(caches, shardings_for(cache_specs(cfg), caches,
                                                mesh, rules)),
                    place(positions, ts["p"]), cfg)
        args = (attach(aparams, pshard), attach(ins["tokens"], tshard["t"]),
                attach(acaches, cshard), attach(ins["positions"],
                                                tshard["p"]))
        return serve_step, args, rules

    raise ValueError(shape.kind)
