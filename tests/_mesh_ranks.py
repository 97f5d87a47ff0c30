"""Rank programs of `tests/test_torch_mesh.py`: each spawned rank joins a
gloo process group through a ``file://`` rendezvous, runs the named jobs
on the CPU and saves what it saw for the test process to compare. Imports
the port only (no JAX), as a rank on the card would.

    main(rank, world, rendezvous, spec_file, out_dir)

``spec_file`` (`torch.save`) holds ``{"jobs": [...], "grids": {name:
(fields, names)}, ...}``; rank r writes ``{job: result}`` to
``out_dir/rank{r}.pt``.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.dispatch import DispatchConfig
from repro_torch.execution import Coupling, ExecutionPlan, take_rows
from repro_torch.fleet import grid_from_numpy
from repro_torch.optim.compress import compressed_pmean
from repro_torch.parallel import axes
from repro_torch.tune import (PolicyParams, TuneConfig,
                              dispatch_coupling_from_grid, init_from_grid,
                              optimize, problem_from_grid,
                              sharded_soft_objective, soft_objective)
from repro_torch.tune.optimizer import (_COUPLING_SHARED, _pad_rows,
                                        _take_problem)

DCFG = dict(demand_frac=0.25, migrate_cost=4.0, min_dwell_h=2)
TAU = 3.0


def grid(spec, name):
    fields, names = spec["grids"][name]
    return grid_from_numpy(fields, market_names=names[0],
                           system_names=names[1], policy_names=names[2],
                           device="cpu")


def _np(x):
    return x.detach().cpu().numpy()


def job_collectives(rank, spec):
    """psum_id / psum / pmax values and backward, all_gather, the mesh
    surface under a live mesh, and `compressed_pmean`."""
    out = {}
    try:
        axes.psum(torch.ones(2), "rows")
    except NameError as e:
        out["unbound"] = str(e)
    mesh = axes.row_mesh(2)
    w = torch.tensor([1.0, 10.0]) * (rank + 1)       # rank-specific weights
    with axes.use_sharding(mesh, axes.TRAIN_RULES):
        for name, fn in (("psum_id", axes.psum_id), ("psum", axes.psum)):
            x = torch.tensor([1.0, 2.0]).mul(rank + 1).requires_grad_(True)
            y = fn(x, "rows")
            (y * w).sum().backward()
            out[name] = (_np(y), _np(x.grad))
        x = torch.tensor([3.0, -1.0]) * (1 - 2 * rank)
        y = axes.pmax(x.requires_grad_(True), "rows")
        out["pmax"] = (_np(y), y.requires_grad)
        out["gather"] = _np(axes.all_gather(
            torch.arange(3, dtype=torch.int8) + 10 * rank, "rows"))
        out["axis_size"] = (axes.axis_size("rows"), axes.axis_size("data"))
        placed = axes.constrain(torch.ones(2), "batch")
        out["constrain"] = (type(placed).__name__,
                            [type(p).__name__ for p in placed.placements])
        out["constrain_none"] = axes.local(
            axes.constrain(torch.ones(2), None)).tolist()
        out["named_sharding"] = tuple(axes.named_sharding("batch").spec)
        r = np.random.default_rng(rank)
        grads = {"a": torch.as_tensor(r.normal(size=(3, 4)),
                                      dtype=torch.float32),
                 "b": [torch.as_tensor(r.normal(size=5) * 1e-3,
                                       dtype=torch.bfloat16)]}
        err = {"a": torch.as_tensor(r.normal(size=(3, 4)) * 1e-2,
                                    dtype=torch.float32),
               "b": [torch.zeros(5)]}
        mean, new_err = compressed_pmean(grads, err, "rows")
        out["compress"] = dict(
            grads={"a": _np(grads["a"]), "b": _np(grads["b"][0].float())},
            err={"a": _np(err["a"]), "b": _np(err["b"][0])},
            mean={"a": _np(mean["a"]), "b": _np(mean["b"][0].float())},
            mean_dtype=str(mean["b"][0].dtype),
            new_err={"a": _np(new_err["a"]), "b": _np(new_err["b"][0])})
    data = axes.row_mesh(2, axis="data")
    out["spec"] = [tuple(axes.sanitized_spec(shape, logical, axes.TRAIN_RULES,
                                             mesh=data))
                   for shape, logical in spec["spec_cases"]]
    try:
        axes.row_mesh(3)
    except ValueError as e:
        out["too_many"] = str(e)
    return out


def job_objective(rank, spec):
    """`soft_objective(axis_name=, scale_rows=)` on this rank's shard of
    the padded ``"odd"`` grid: base, coupled and the local gradients."""
    g = grid(spec, "odd")
    n = g.n_rows
    problem = problem_from_grid(g)
    coupling = dispatch_coupling_from_grid(g, DispatchConfig(**DCFG))
    width = -(-n // 2)
    raw0, problem, coupling = _pad_rows(init_from_grid(g), problem,
                                        coupling, n, 2 * width)
    sl = np.arange(rank * width, (rank + 1) * width)
    coupling = take_rows(coupling, sl, shared=_COUPLING_SHARED)
    leaves = [x[torch.as_tensor(sl)].clone().requires_grad_(True)
              for x in raw0]
    with axes.use_sharding(axes.row_mesh(2), axes.SINGLE_DEVICE_RULES):
        loss, aux = soft_objective(
            PolicyParams(*leaves), _take_problem(problem, sl), TAU,
            dispatch=coupling, dispatch_min_dwell=DCFG["min_dwell_h"],
            dispatch_fused=True, reduction="sum", axis_name="rows",
            scale_rows=n, **spec["penalties"])
        grads = torch.autograd.grad(loss, leaves)
    return dict(base=float(aux["base"].detach()),
                coupled=float(aux["coupled"].detach()),
                ratio=_np(aux["ratio"]), grads=[_np(x) for x in grads])


def job_sharded_loss(rank, spec):
    """`sharded_soft_objective` on the ``"even"`` grid: value and
    gradient in float32, then float64 central differences."""
    g = grid(spec, "even")
    problem = problem_from_grid(g)
    coupling = dispatch_coupling_from_grid(g, DispatchConfig(**DCFG))
    kw = dict(dispatch_min_dwell=DCFG["min_dwell_h"], dispatch_fused=True,
              **spec["penalties"])
    leaves = [x.clone().requires_grad_(True) for x in init_from_grid(g)]
    loss = sharded_soft_objective(PolicyParams(*leaves), problem, TAU,
                                  n_dev=2, coupling=coupling, **kw)
    loss.backward()
    out = dict(loss=float(loss), grads=[_np(x.grad) for x in leaves])

    # float64, as the reference's test_coupled_sharded_gradient_fd_x64
    p64 = problem._replace(**{f: getattr(problem, f).double()
                              for f in problem._fields if f != "market_idx"})
    raw = PolicyParams(*(x.double() for x in init_from_grid(g)))

    def f64(r):
        return sharded_soft_objective(
            r, p64, TAU, n_dev=2, coupling=coupling, fused=False,
            dispatch_min_dwell=DCFG["min_dwell_h"])

    leaves = [x.clone().requires_grad_(True) for x in raw]
    f64(PolicyParams(*leaves)).backward()
    eps = 1e-5
    pick = np.random.default_rng(11)
    fd_rows = []
    with torch.no_grad():
        for k, name in enumerate(raw._fields):
            for b in pick.choice(g.n_rows, size=2, replace=False):
                hi, lo = raw[k].clone(), raw[k].clone()
                hi[b] += eps
                lo[b] -= eps
                fd = (float(f64(raw._replace(**{name: hi})))
                      - float(f64(raw._replace(**{name: lo})))) / (2 * eps)
                fd_rows.append((name, int(b), fd, float(leaves[k].grad[b])))
    out["fd"] = fd_rows
    return out


def _tune(g, steps, plan, coupling=True, warm_start=None):
    coup = Coupling(dispatch=DispatchConfig(**DCFG)) if coupling else None
    return optimize(g, TuneConfig(steps=steps, plan=plan, coupling=coup),
                    warm_start=warm_start, device="cpu")


def _result(res):
    return dict(raw=[_np(x) for x in res.raw], cpc=res.cpc,
                cpc_tuned=res.cpc_tuned, source=res.source,
                history={k: np.asarray(v) for k, v in res.history.items()},
                stage_cpc=res.stage_cpc,
                dispatch=None if res.dispatch is None else
                res.dispatch["cpc_tuned"])


def job_optimize(rank, spec):
    """`optimize` with ``mode='sharded'`` and the dispatch coupling on the
    padded ``"odd"`` grid beside the single program, warm (from the single
    program's result) and cold restarts through the padding, and
    ``mode='auto'`` uncoupled on the ``"even"`` grid with telemetry off
    and on."""
    odd, even = grid(spec, "odd"), grid(spec, "even")
    sharded = ExecutionPlan(mode="sharded")
    single = _tune(odd, spec["steps"], ExecutionPlan(mode="single"))
    out = {"single": _result(single),
           "sharded": _result(_tune(odd, spec["steps"], sharded))}
    out["warm"] = _result(_tune(odd, 2, sharded, warm_start=single))
    out["cold"] = _result(_tune(odd, 2, sharded))
    auto = ExecutionPlan()
    out["auto"] = _result(_tune(even, spec["steps"], auto, coupling=False))
    with obs.capture(Path(spec["out_dir"]) / f"trace{rank}"):
        out["auto_telemetry"] = _result(
            _tune(even, spec["steps"], auto, coupling=False))
    return out


def job_subset(rank, spec):
    """A row mesh over 2 of 3 ranks: the third receives the result."""
    return _result(_tune(grid(spec, "even"), 3,
                         ExecutionPlan(mode="sharded", devices=2)))


JOBS = {"collectives": job_collectives, "objective": job_objective,
        "sharded_loss": job_sharded_loss, "optimize": job_optimize,
        "subset": job_subset}


def main(rank: int, world: int, rendezvous: str, spec_file: str,
         out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        spec = torch.load(spec_file, weights_only=False)
        out = {name: JOBS[name](rank, spec) for name in spec["jobs"]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
