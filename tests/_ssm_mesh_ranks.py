"""Rank programs of `tests/test_torch_ssm_mesh.py`: the tensor-parallel
Mamba2 block under the model mesh. Each spawned rank joins a gloo
process group through a ``file://`` rendezvous (the helpers of
`tests/_model_mesh_ranks.py`), runs the named jobs on the CPU and saves
what it saw for the test process to hold against the reference. Imports
the port only (no JAX).

    main(rank, world, rendezvous, spec_file, out_dir)

``spec_file`` (`torch.save`) holds ``{"jobs": [...], ...}`` with the
jobs' numpy inputs; rank r writes ``{job: result}`` to
``out_dir/rank{r}.pt``, with the count of DTensor's own redistributions
(``dtensor_redistributions``, which must stay 0).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

import _model_mesh_ranks as mm
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.configs.inputs import reduced_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models.model import (_PARAM_AXES, _SSM_CACHE_AXES,
                                      loss_fn, param_specs,
                                      params_from_numpy)
from repro_torch.models.ssm import ssm_block
from repro_torch.parallel import axes
from repro_torch.parallel.axes import (TRAIN_RULES, distribute, full_tensor,
                                       sanitized_spec, spec_placements,
                                       use_sharding)
from repro_torch.runtime.elastic import reshard_tree

CPU = torch.device("cpu")
SCANS: list = []         # x's shape at every `ops.ssd_scan` call
CALLS: list = []         # (kind, payload bytes) of every collective


def _guard() -> None:
    """Count DTensor's own redistributions wherever DTensor calls them:
    `_model_mesh_ranks`' count (an explicit ``redistribute``) plus the
    backward of ``from_local`` and the operator dispatch."""
    from torch.distributed.tensor import _api, _dispatch

    mm._guard_dtensor_redistribution()
    for mod in (_api, _dispatch):
        orig = mod.redistribute_local_tensor

        def counted(*args, _orig=orig, **kwargs):
            mm.REDISTRIBUTIONS[0] += 1
            return _orig(*args, **kwargs)
        mod.redistribute_local_tensor = counted


def _spy() -> None:
    """Record the shape of x at each SSD scan and the payload of each
    collective of the port's transport."""
    scan, count = ops.ssd_scan, axes._count

    def spied_scan(x, *args, **kwargs):
        SCANS.append(tuple(x.shape))
        return scan(x, *args, **kwargs)

    def spied_count(kind, t, n):
        CALLS.append((kind, t.numel() * t.element_size()))
        count(kind, t, n)
    ops.ssd_scan = spied_scan
    axes._count = spied_count


def ssm_cfg(arch: str, **kw):
    return reduced_config(get_config(arch)).replace(**kw)


def _placements(t) -> tuple:
    return tuple(str(p) for p in t.placements)


def serve(cfg, params, toks, steps: int, mesh) -> dict:
    """Prefill + ``steps`` teacher-forced decode steps through
    `build_step` (as `_model_mesh_ranks.serve`), with what the block did:
    every rank's x at the SSD scans of the prefill, the SSM cache leaves'
    placements after it beside those of the reference's cache axes, and
    the collectives of the first decode step."""
    b, s0 = toks.shape[0], toks.shape[1] - steps
    pre, _, prules = build_step(cfg, SHAPES["prefill_32k"].replace(
        seq_len=s0, global_batch=b), mesh)
    dec, _, drules = build_step(cfg, SHAPES["decode_32k"].replace(
        seq_len=s0 + steps, global_batch=b), mesh)
    before = mm.REDISTRIBUTIONS[0]
    SCANS.clear()
    logits, caches = pre(params, {"tokens": toks[:, :s0]},
                         max_seq=s0 + steps)
    out = {"logits": [mm._np(logits)], "scans": list(SCANS)}
    ssm = caches["ssm"]
    out["placements"] = {name: (_placements(getattr(ssm, name)), tuple(
        str(p) for p in spec_placements(sanitized_spec(
            tuple(getattr(ssm, name).shape),
            getattr(_SSM_CACHE_AXES, name), prules, mesh), mesh)))
        for name in ("conv", "state")}
    for t in range(steps):
        pos = torch.full((b,), s0 + t, dtype=torch.int32)
        CALLS.clear()
        logits, caches = dec(params, toks[:, s0 + t:s0 + t + 1], caches,
                             pos)
        if t == 0:
            out["decode_calls"] = list(CALLS)
        out["logits"].append(mm._np(logits))
    out["redistributions"] = mm.REDISTRIBUTIONS[0] - before
    return out


def job_serve(rank, spec):
    """Reduced mamba2-1.3b and zamba2-1.2b served on each mesh of
    ``spec["meshes"]``: {(arch, (data, model)): `serve`'s record}."""
    toks = torch.as_tensor(spec["serve_tokens"])
    out = {}
    for arch in spec["archs"]:
        cfg = ssm_cfg(arch)
        params = params_from_numpy(spec[arch], cfg, device=CPU)
        for dn, mn in spec["meshes"]:
            mesh = make_host_mesh(data=dn, model=mn, device_type="cpu")
            out[(arch, (dn, mn))] = serve(cfg, params, toks, spec["steps"],
                                          mesh)
    return out


def job_narrow(rank, spec):
    """The 6-head variant (d_model 48) on (1, 4): the model axis does not
    divide the heads, which stay whole on every rank."""
    cfg = ssm_cfg("mamba2-1.3b", d_model=48)
    params = params_from_numpy(spec["narrow"], cfg, device=CPU)
    mesh = make_host_mesh(data=1, model=4, device_type="cpu")
    return serve(cfg, params, torch.as_tensor(spec["serve_tokens"]),
                 spec["steps"], mesh)


def job_train(rank, spec):
    """The loss of reduced mamba2-1.3b under TRAIN_RULES on (data 2, model
    2) (the sequence split over ``model`` between blocks), its parameters
    placed by `reshard_tree`, and the gradients of the Mamba2 weights
    named in ``spec["grad_leaves"]``, whole."""
    cfg = ssm_cfg("mamba2-1.3b")
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    params = params_from_numpy(spec["mamba2-1.3b"], cfg, device=CPU)
    params = reshard_tree(params, mesh, param_specs(params), TRAIN_RULES)
    leaves = [params["blocks"]["ssm"][k] for k in spec["grad_leaves"]]
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.as_tensor(spec["train_tokens"])
    before = mm.REDISTRIBUTIONS[0]
    with use_sharding(mesh, TRAIN_RULES):
        loss, _ = loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return {"loss": float(full_tensor(loss.detach())),
            "grads": {k: mm._np(g) for k, g in zip(spec["grad_leaves"],
                                                    grads)},
            "redistributions": mm.REDISTRIBUTIONS[0] - before}


def _placed(full, logical, mesh):
    return distribute(torch.as_tensor(full), mesh, spec_placements(
        sanitized_spec(tuple(full.shape), logical, TRAIN_RULES, mesh),
        mesh))


def job_block_grad(rank, spec):
    """One Mamba2 block (layer 0 of reduced mamba2-1.3b) under TRAIN_RULES
    on (2, 2): its input on (batch, seq), its weights on the reference's
    axes; the block's output and its vector-Jacobian product with
    ``spec["block"]``'s cotangent for the input and every weight, whole,
    and DTensor's own redistributions in forward and backward."""
    cfg = ssm_cfg("mamba2-1.3b")
    mesh = make_host_mesh(data=2, model=2, device_type="cpu")
    x, cot = spec["block"]
    tree = spec["mamba2-1.3b"]["blocks"]["ssm"]
    p = {k: _placed(v[0], _PARAM_AXES[k], mesh).requires_grad_(True)
         for k, v in tree.items()}
    xd = _placed(x, ("batch", "seq", None), mesh).requires_grad_(True)
    before = mm.REDISTRIBUTIONS[0]
    with use_sharding(mesh, TRAIN_RULES):
        out, _ = ssm_block(xd, p, cfg)
        grads = torch.autograd.grad(
            out, [xd, *p.values()],
            _placed(cot, ("batch", "seq", None), mesh))
    return {"out": mm._np(out),
            "grads": {k: mm._np(g) for k, g in zip(["x", *p], grads)},
            "out_placements": _placements(out),
            "redistributions": mm.REDISTRIBUTIONS[0] - before}


JOBS = {"serve": job_serve, "narrow": job_narrow, "train": job_train,
        "block_grad": job_block_grad}


def main(rank: int, world: int, rendezvous: str, spec_file: str,
         out_dir: str) -> None:
    torch.set_num_threads(1)
    _guard()
    _spy()
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        spec = torch.load(spec_file, weights_only=False)
        out = {name: JOBS[name](rank, spec) for name in spec["jobs"]}
        out["dtensor_redistributions"] = mm.REDISTRIBUTIONS[0]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
