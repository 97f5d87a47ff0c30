"""Rank programs of `tests/test_torch_model_mesh.py`: each spawned rank
joins a gloo process group through a ``file://`` rendezvous, runs the
named jobs on the CPU under the model mesh and saves what it saw (whole
tensors, gathered by the port's transport) for the test process to hold
against the reference. Imports the port only (no JAX).

    main(rank, world, rendezvous, spec_file, out_dir)

``spec_file`` (`torch.save`) holds ``{"jobs": [...], ...}`` with the
jobs' numpy inputs; rank r writes ``{job: result}`` to
``out_dir/rank{r}.pt``. Every job also reports how often DTensor's own
redistribution ran (``dtensor_redistributions``): the serving paths must
leave all data movement to the port's transport.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.configs.inputs import reduced_config
from repro_torch.checkpoint.manager import load_checkpoint
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_step, shardings_for
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.model import (init_params, init_params_sharded,
                                      loss_fn, param_specs,
                                      params_from_numpy)
from repro_torch.models.transformer import moe_ffn
from repro_torch.parallel import axes
from repro_torch.parallel.axes import TRAIN_RULES, full_tensor, use_sharding
from repro_torch.runtime.elastic import reshard_tree, resize_mesh

CPU = torch.device("cpu")
REDISTRIBUTIONS = [0]


def _guard_dtensor_redistribution() -> None:
    """Count DTensor's own redistributions (functional collectives)."""
    from torch.distributed.tensor import _redistribute

    orig = _redistribute.redistribute_local_tensor

    def counted(*args, **kwargs):
        REDISTRIBUTIONS[0] += 1
        return orig(*args, **kwargs)
    _redistribute.redistribute_local_tensor = counted


def _np(x) -> np.ndarray:
    return full_tensor(x).detach().float().cpu().numpy()


def qwen_cfg(**kw):
    return reduced_config(get_config("qwen2.5-3b")).replace(**kw)


def moe_cfg(e: int):
    return reduced_config(get_config("mixtral-8x22b")).replace(
        d_model=64, d_ff=128, n_experts=e, capacity_factor=8.0)


def job_loss(rank, spec):
    """The loss of reduced qwen2.5-3b under TRAIN_RULES on (data=2,
    model=2), its parameters placed by `reshard_tree`."""
    cfg = qwen_cfg()
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    params = params_from_numpy(spec["qwen"], cfg, device=CPU)
    params = reshard_tree(params, mesh, param_specs(params), TRAIN_RULES)
    toks = torch.as_tensor(spec["tokens"])
    with use_sharding(mesh, TRAIN_RULES):
        loss, _ = loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    return float(full_tensor(loss))


def job_moe(rank, spec):
    """The expert-parallel FFN's prefill and decode branches on each mesh
    of ``spec["moe"]``: {(E, data, model): (prefill out, decode out)}."""
    out = {}
    for (e, dn, mn), (p, x, xd) in spec["moe"].items():
        cfg = moe_cfg(e)
        mesh = make_host_mesh(data=dn, model=mn, device_type="cpu")
        pt = {k: torch.as_tensor(v) for k, v in p.items()}
        with use_sharding(mesh, TRAIN_RULES):
            y, _ = moe_ffn(torch.as_tensor(x), pt, cfg, True)
            yd, _ = moe_ffn(torch.as_tensor(xd), pt, cfg, True)
        out[(e, dn, mn)] = (_np(y), _np(yd))
    return out


def job_gqa(rank, spec):
    """`blockwise_attention` under a (1, 4) mesh at each head layout."""
    out = {}
    mesh = make_host_mesh(data=1, model=4, device_type="cpu")
    for (h, g), (q, k, v) in spec["gqa"].items():
        cfg = get_config("qwen1.5-0.5b").replace(n_heads=h, n_kv_heads=g)
        with use_sharding(mesh, TRAIN_RULES):
            o = blockwise_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                                    cfg, causal=True)
        out[(h, g)] = _np(o)
    return out


def serve(cfg, params, toks, steps: int, mesh, extra=None):
    """Prefill + ``steps`` teacher-forced decode steps (column p + 1 of
    ``toks``) through `build_step`'s prefill and serve steps; ``extra``:
    more prefill inputs (an audio model's frames). Returns the prefill
    logits and every step's logits, whole."""
    b, s0 = toks.shape[0], toks.shape[1] - steps
    pre, _, _ = build_step(cfg, SHAPES["prefill_32k"].replace(
        seq_len=s0, global_batch=b), mesh)
    dec, _, _ = build_step(cfg, SHAPES["decode_32k"].replace(
        seq_len=s0 + steps, global_batch=b), mesh)
    logits, caches = pre(params, {"tokens": toks[:, :s0], **(extra or {})},
                         max_seq=s0 + steps)
    outs = [_np(logits)]
    for t in range(steps):
        pos = torch.full((b,), s0 + t, dtype=torch.int32)
        logits, caches = dec(params, toks[:, s0 + t:s0 + t + 1], caches,
                             pos)
        outs.append(_np(logits))
    return outs


def job_decode(rank, spec):
    """Aligned-cache serving of reduced qwen2.5-3b (kv_cache_align 4) on a
    (1, 4) mesh (the serve step under DECODE_HEADS_RULES), and the int8
    cache on (2, 2)."""
    cfg = qwen_cfg(kv_cache_align=4)
    toks = torch.as_tensor(spec["serve_tokens"])
    params = params_from_numpy(spec["qwen"], cfg, device=CPU)
    mesh = make_host_mesh(data=1, model=4, device_type="cpu")
    before = REDISTRIBUTIONS[0]
    out = {"aligned": serve(cfg, params, toks, spec["steps"], mesh)}
    mesh22 = make_host_mesh(data=2, model=2, device_type="cpu")
    out["int8"] = serve(cfg.replace(kv_cache_dtype="int8"), params, toks,
                        spec["steps"], mesh22)
    out["serve_redistributions"] = REDISTRIBUTIONS[0] - before
    rules = build_step(cfg, SHAPES["decode_32k"].replace(
        seq_len=16, global_batch=2), mesh)[2]
    out["decode_heads_over_model"] = (rules["kv_heads"] == "model"
                                      and rules["cache_seq"] is None)
    return out


def job_families(rank, spec):
    """Reduced mamba2-1.3b, zamba2-1.2b, whisper-large-v3 and
    internvl2-76b served on (2, 2): the Mamba2 blocks and the attention
    (zamba2's shared block, whisper's self- and cross-attention,
    internvl2's backbone behind its patches) tensor-parallel."""
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    toks = torch.as_tensor(spec["serve_tokens"])
    out = {}
    for arch in spec["families"]:
        cfg = reduced_config(get_config(arch))
        params = params_from_numpy(spec[arch], cfg, device=CPU)
        extra = {k: torch.as_tensor(spec[k]) for k in
                 (("frames",) if cfg.family == "audio" else
                  ("patches",) if cfg.frontend == "vision" else ())}
        out[arch] = serve(cfg, params, toks, spec["steps"], mesh, extra)
    return out


def job_checkpoint(rank, spec):
    """A checkpoint written by one process, restored with ``shardings=``
    onto the 4-rank (1, 4) mesh and onto `resize_mesh` at level 0.5 with
    model parallelism 2 (ranks 0-1), whole again; and the 4-rank leaves
    resharded onto the 2-rank mesh by `reshard_tree`."""
    cfg = qwen_cfg(kv_cache_align=4)
    template = params_from_numpy(spec["qwen"], cfg, device=CPU)
    out = {}
    mesh4 = make_host_mesh(data=1, model=4, device_type="cpu")
    mesh2 = resize_mesh(4, 0.5, model_parallel=2, device_type="cpu")
    for name, mesh in (("four", mesh4), ("two", mesh2)):
        sh = shardings_for(param_specs(template), template, mesh,
                           TRAIN_RULES)
        tree, meta = load_checkpoint(spec["ckpt_dir"], template,
                                     shardings=sh)
        out[name] = {k: v for k, v in _flat(tree).items()} \
            if mesh.get_coordinate() is not None else None
        if name == "four":
            placed = tree
        out[f"{name}_step"] = meta["step"]
    moved = reshard_tree(placed, mesh2, param_specs(template), TRAIN_RULES)
    out["resharded"] = _flat(moved) if mesh2.get_coordinate() is not None \
        else None
    return out


def job_sharded_init(rank, spec):
    """`init_params_sharded` (each rank draws and keeps its own shards)
    against `reshard_tree` of the whole `init_params` draw, on (data 2,
    model 2) under TRAIN_RULES, for reduced qwen2.5-3b and an 8-expert
    MoE: per rank, whether every local shard, its placements and its
    global shape are the same, from an int seed and from a generator."""
    out = {}
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    for name, cfg in (("qwen", qwen_cfg()), ("moe", moe_cfg(8))):
        for how in ("seed", "generator"):
            def key():
                return 3 if how == "seed" else \
                    torch.Generator().manual_seed(3)
            full = init_params(key(), cfg, device=CPU)
            want = _flat_local(reshard_tree(full, mesh, param_specs(full),
                                            TRAIN_RULES))
            got = _flat_local(init_params_sharded(key(), cfg, mesh,
                                                  TRAIN_RULES, device=CPU))
            out[f"{name}/{how}"] = got.keys() == want.keys() and all(
                torch.equal(got[k][0], want[k][0])
                and got[k][1:] == want[k][1:] for k in want)
    return out


def _flat_local(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_local(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.to_local(), tuple(v.placements),
                               tuple(v.shape))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = full_tensor(v).cpu() if \
                axes.is_dtensor(v) and v.device_mesh.get_coordinate() \
                is not None else v
    return out


JOBS = {"loss": job_loss, "moe": job_moe, "gqa": job_gqa,
        "decode": job_decode, "families": job_families,
        "checkpoint": job_checkpoint, "sharded_init": job_sharded_init}


def main(rank: int, world: int, rendezvous: str, spec_file: str,
         out_dir: str) -> None:
    torch.set_num_threads(1)
    _guard_dtensor_redistribution()
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        spec = torch.load(spec_file, weights_only=False)
        out = {name: JOBS[name](rank, spec) for name in spec["jobs"]}
        out["dtensor_redistributions"] = REDISTRIBUTIONS[0]
        out["comm"] = axes.comm_stats()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
