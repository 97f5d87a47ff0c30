"""Batched gradient tuning of shutdown policies over a whole fleet grid.

`optimize` turns every row of a `ScenarioGrid` into an independent
optimization problem: the row's three policy variables (threshold,
hysteresis gap, off-capacity level — reparameterized unconstrained, see
`repro_torch.tune.objective`) descend the temperature-relaxed CPC
objective together, with the whole [B]-row gradient computed in one
backward pass through the soft scan — by default the hand-written
forward and backward of `repro_torch.kernels.soft_scan_vjp`
(``TuneConfig.fused``; the CUDA kernels on the card).

The update rule is `repro_torch.optim.adamw.adamw_update` with the row
axis written out (``per_row=True``): each row carries its own Adam
moments and its own gradient clip.

The hot loop (`tune_loop`) is a Python loop over steps whose tensors stay
on the device: the tau-annealing schedule, every Adam step and the staged
hard (tau -> 0) re-evaluations run without reading a value back to the
host, and the per-step history comes back once, at the end. The per-row
gradients are batch-independent (sum-reduction, see `soft_objective`), so
row chunking — ``ExecutionPlan(mode="chunked")`` — tunes fixed row slices
(padded to one shape) with the same per-row results as one program.

``ExecutionPlan(mode="sharded")`` splits the rows over a 1-D
`repro_torch.parallel.row_mesh` of the ranks of `torch.distributed`'s
default process group: each rank tunes its contiguous slice, the fleet
aggregates of a coupled objective reduce across the ranks every step
(`soft_objective(axis_name=)`), so coupled objectives shard too, and the
per-row results are all-gathered, ULP-equal to the single program. It is
SPMD: every rank calls `optimize` with the whole grid and returns the
whole result. Without a process group (or with one rank) it is the single
program.

Temperature annealing: the sigmoid temperature follows a geometric
schedule from ``tau_start`` (smooth, wide basins) down to ``tau_end``
(nearly hard). After the last step the result is re-evaluated under the
*hard* scan, and each row keeps the best of {tuned params, its own swept
policy, the best swept policy of its (market, system) cell} — so the
reported CPC is never worse than the swept grid it started from.

With ``Coupling(reeval=DispatchConfig(...))`` the selected and the
best-swept policy sets are re-scored on the feasible cross-site
dispatcher (`repro_torch.dispatch`, the CUDA `dispatch_scan` kernel on
the card) and reported in `TuneResult.dispatch`. With
``Coupling(dispatch=DispatchConfig(...))`` the annealed objective also
differentiates through the relaxed water-fill dispatcher
(`repro_torch.tune.objective.soft_dispatch_ratio`): every step launches
the fused soft-dispatch forward and backward kernels on the card, and
the result is re-scored on feasible dispatch under the same config.

With a telemetry run active (`repro_torch.obs`) the steps also return
each step's mean per-row gradient norm and clip fraction, gathered with
the rest of the history, and `optimize` emits ``tune.step``,
``tune.stage`` and ``tune.result`` events; the tuned parameters are the
same bit for bit.

With a `repro_torch.workload.Workload` (``TuneConfig.workload``, or the
grid's own) the annealed objective adds the soft work-ledger term (the
ledger kernel pair of `repro_torch.kernels.queue_scan` every step on the
card) and the final selection is judged by realized workload cost
(`repro_torch.workload.realized_cost`, the hard ledger kernel).

The reference's pre-redesign `TuneConfig` spellings (``chunk_rows=``,
``power_cap_mw=``, ...) raise `TypeError` naming ``plan=`` / ``coupling=``
(`repro_torch.execution.refuse_renamed`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dispatch import (DispatchConfig, DispatchInfeasible,
                                  build_problem)
from repro_torch.dispatch import dispatch as dispatch_solve
from repro_torch.execution import (Coupling, ExecutionPlan, refuse_renamed,
                                   take_rows, validate_plan_coupling)
from repro_torch.fleet.engine import backtest, fleet_costs
from repro_torch.fleet.grid import concat_rows, row_chunks
from repro_torch.kernels.fleet_scan import fleet_scan
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     tree_map)
from repro_torch.parallel.axes import (all_gather, axis_size, current_mesh,
                                       current_rules, psum, row_mesh,
                                       use_sharding)
from repro_torch.tune.objective import (DispatchCoupling, PhysicalPolicy,
                                        PolicyParams, TuneProblem,
                                        cell_index,
                                        dispatch_coupling_from_grid,
                                        init_from_grid, inverse_transform,
                                        problem_from_grid, soft_objective,
                                        transform)


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Hyperparameters of a fleet tuning run (hashable).

    Execution layout and fleet coupling are the `repro_torch.execution`
    pair: ``plan`` (`ExecutionPlan`: single, chunked or sharded) and
    ``coupling`` (`Coupling`: power cap, aggregate-compute floor, the
    dispatch-aware term ``dispatch``, the hard-dispatch re-scoring
    ``reeval`` and its shed pricing ``relief``). The chunk-under-coupling legality rule is
    checked here, at construction. ``workload`` (a hashable
    `repro_torch.workload.Workload`) adds the SLO-aware work-ledger term
    to the objective and selects candidates by realized workload cost
    (energy + deferral + drop) instead of bare CPC; None falls back to
    the grid's own workload, and neither keeps the runs as they were.
    The reference's deprecated spellings of ``plan`` and ``coupling``
    raise `TypeError` naming their replacement.
    """

    steps: int = 300
    lr: float = 0.5              # raw-space Adam step (price units for
                                 # raw_off; Adam normalizes per-coordinate)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 0.0       # per-row grad clip; 0 disables. The
                                 # clipped quantity is the row's gradient
                                 # of its *own* CPC ratio (sum-reduction)
    tau_start: float = 30.0      # EUR/MWh-scale smoothing at the start
    tau_end: float = 0.3         # nearly hard by the end
    fused: bool = True           # hand-written soft-scan and
                                 # soft-dispatch VJPs (False: autograd
                                 # through the plain operations, the
                                 # native baseline; the dispatch-aware
                                 # term runs it on the CPU only)
    block_t: int = 256           # checkpoint block length (hours)
    eval_stages: int = 4         # hard (tau -> 0) re-evaluations spread
                                 # over the anneal -> TuneResult.stage_cpc;
                                 # clamped to [1, steps]
    workload: Optional[object] = None
    plan: Optional[ExecutionPlan] = None
    coupling: Optional[Coupling] = None

    def __new__(cls, *args, **kw):
        refuse_renamed(kw, "TuneConfig")
        return super().__new__(cls)

    def __post_init__(self):
        validate_plan_coupling(self.resolved_plan, self.resolved_coupling,
                               context="TuneConfig")

    @property
    def resolved_plan(self) -> ExecutionPlan:
        return self.plan if self.plan is not None else ExecutionPlan()

    @property
    def resolved_coupling(self) -> Coupling:
        return self.coupling if self.coupling is not None else Coupling()

    def _replace(self, **kw) -> "TuneConfig":
        return dataclasses.replace(self, **kw)


class TuneResult(NamedTuple):
    """Output of `optimize` (per-row arrays of shape [B])."""

    params: PhysicalPolicy       # selected per-row policy (hard-eval best)
    raw: PolicyParams            # final raw params of the gradient run
    cpc: np.ndarray              # hard CPC of the selected policy
    cpc_tuned: np.ndarray        # hard CPC of the gradient-tuned params
    cpc_swept: np.ndarray        # engine CPC of the row's own swept policy
    cpc_swept_best: np.ndarray   # best engine CPC in the row's cell
    improvement_vs_best: np.ndarray   # 1 - cpc / cpc_swept_best
    improvement_vs_own: np.ndarray    # 1 - cpc / cpc_swept
    source: np.ndarray           # 0 = tuned, 1 = own swept, 2 = cell best
    history: dict                # per-step arrays: loss, tau, penalty, ...
    # mean hard CPC at each anneal-stage boundary ([cfg.eval_stages]; the
    # last entry is mean(cpc_tuned)); chunked runs average over chunks
    stage_cpc: Optional[np.ndarray] = None
    # feasible-dispatch re-scoring (None unless Coupling(reeval=)):
    # {"cpc_tuned", "cpc_swept", "chosen", "tuned", "swept", "rows",
    # "site_names", "infeasible_tuned", "infeasible_swept"}; "tuned" and
    # "swept" are `repro_torch.dispatch.DispatchResult`s (None when
    # infeasible), "rows" the operated row per (market, system) cell
    dispatch: Optional[dict] = None
    # total row-steps the finite-step guard rejected (0 on a healthy run)
    guard_count: int = 0
    # [B] realized workload cost (energy + deferral + drop, EUR, mean over
    # the shared demand draws) of the selected policy — None unless a
    # Workload was configured; when set, ``source`` was chosen by this
    # yardstick instead of bare CPC
    workload_cost: Optional[np.ndarray] = None


def _tau_schedule(cfg: TuneConfig, device) -> torch.Tensor:
    """Geometric anneal tau_start -> tau_end over ``cfg.steps``, in
    float32 as the reference computes it."""
    if cfg.steps == 1:
        return torch.tensor([cfg.tau_start], dtype=torch.float32,
                            device=device)
    i = torch.arange(cfg.steps, dtype=torch.float32,
                     device=device) / (cfg.steps - 1)
    return cfg.tau_start * (cfg.tau_end / cfg.tau_start) ** i


def _hard_cpc_rows(p_on, p_off, off_level, problem: TuneProblem,
                   p_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard (tau -> 0) CPC of per-row policy variables under each row's
    own hardware: the engine's scan (the CUDA `fleet_scan` kernel on the
    card) and cost assembly."""
    p = problem.row_prices() if p_rows is None else p_rows
    scan = fleet_scan(p, p_on, p_off, off_level, problem.idle_frac)
    return fleet_costs(
        scan, price_sum=problem.price_sum, fixed=problem.fixed,
        power=problem.power, period=problem.period,
        restart_energy_mwh=problem.restart_energy_mwh,
        restart_time_h=problem.restart_time_h, n_samples=p.shape[1]).cpc


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def hard_cpc(p_on, p_off, off_level, problem: TuneProblem) -> torch.Tensor:
    """[B] hard CPC of the given per-row policy variables (tensors or
    arrays) on ``problem``'s rows, on ``problem``'s device."""
    dev = problem.market_idx.device
    problem = problem._replace(**{
        f: _f32(getattr(problem, f), dev) for f in TuneProblem._fields
        if f != "market_idx"})
    return _hard_cpc_rows(_f32(p_on, dev), _f32(p_off, dev),
                          _f32(off_level, dev), problem)


def _stage_bounds(cfg: TuneConfig) -> list:
    """Step indices of the anneal-stage boundaries: ``eval_stages``
    near-equal segments of [0, steps] (clamped to at most one stage per
    step)."""
    stages = max(1, min(int(cfg.eval_stages), cfg.steps))
    return [(i * cfg.steps) // stages for i in range(stages + 1)]


_LR_BACKOFF_FLOOR = 2.0 ** -10   # per-row lr multiplier never decays
                                 # below this — a row that recovers still
                                 # moves


def _init_carry(raw0: PolicyParams):
    """The loop carry: raw params, per-row Adam moments, and the per-row
    guard lr multiplier (1.0 until a step is rejected)."""
    b = raw0.raw_off.shape[0]
    dev = raw0.raw_off.device
    state0 = AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        mu=tree_map(torch.zeros_like, raw0),
                        nu=tree_map(torch.zeros_like, raw0))
    return (raw0, state0, torch.ones(b, dtype=torch.float32, device=dev))


def _make_step(problem: TuneProblem, cfg: TuneConfig,
               coupling: Optional[DispatchCoupling], b: int,
               p_rows: torch.Tensor, telemetry: bool = False,
               axis_name: Optional[str] = None,
               scale_rows: Optional[int] = None):
    """The per-step function of the Adam loop, shared by `tune_loop` and
    the stage segments of `tune_loop_checkpointed`. ``coupling`` switches
    on the dispatch-aware term; on the card it needs ``cfg.fused`` (the
    fused kernels), since autograd through the plain water-fill is the
    CPU's baseline only.

    Every step carries a branchless finite-step guard: a row whose soft
    CPC ratio or gradient is not finite has its gradient zeroed, its
    parameters and Adam moments held, and its lr multiplier halved (floor
    ``_LR_BACKOFF_FLOOR``). On an all-finite run every guard op is an
    exact identity (``where(True, x, _)``, ``where(lr == 1.0, new, _)``),
    so healthy trajectories equal the unguarded loop bit for bit. The
    per-step reject count streams out as ``history["guard_rejects"]``.

    ``telemetry`` adds the step's mean per-row gradient norm and the
    fraction of rows whose norm exceeds ``cfg.clip_norm`` to its outputs
    (``grad_norm``, ``clip_frac``): observers of the gradients the update
    consumes, never inputs to it, so the parameters stay bit-identical.

    ``axis_name`` / ``scale_rows`` (a rank's shard of a sharded run) flow
    into `soft_objective`, whose fleet aggregates then reduce across the
    ranks. Every rank's loss carries the whole coupled term, so the
    history's loss keeps 1/n of it: the ranks' average then is the single
    program's loss / B.
    """
    rc = cfg.resolved_coupling
    if coupling is not None and not cfg.fused and p_rows.is_cuda:
        raise ValueError(
            "TuneConfig(fused=False) with Coupling(dispatch=) on the card: "
            "the dispatch-aware term differentiates the water-fill through "
            "its fused kernels; use TuneConfig(fused=True) (autograd through "
            "the plain per-hour operations is the CPU's baseline)")
    opt = AdamWConfig(lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                      weight_decay=0.0, clip_norm=cfg.clip_norm)
    min_dwell = rc.dispatch.min_dwell_h if rc.dispatch is not None else 0
    wl = cfg.workload
    # the [T] mean demand profile, made once on the host; each row serves
    # it on its own, so the workload term stays per-row separable
    wl_demand = None if wl is None else torch.as_tensor(
        wl.mean_demand_mw(int(p_rows.shape[1])), dtype=torch.float32,
        device=p_rows.device)

    def step(carry, tau):
        raw, st, lr_scale = carry
        leaves = [x.detach().requires_grad_(True) for x in raw]
        with torch.enable_grad():
            loss, aux = soft_objective(
                PolicyParams(*leaves), problem, tau,
                power_cap_mw=rc.power_cap_mw, min_up_hours=rc.min_up_hours,
                penalty_weight=rc.penalty_weight, dispatch=coupling,
                dispatch_blend=rc.dispatch_blend,
                dispatch_min_dwell=min_dwell,
                dispatch_mw_scale=rc.dispatch_mw_scale,
                dispatch_fused=cfg.fused, relief=rc.relief_config,
                workload=wl, workload_demand=wl_demand,
                fused=cfg.fused, block_t=cfg.block_t, reduction="sum",
                axis_name=axis_name, scale_rows=scale_rows,
                row_prices=p_rows)
            grads = PolicyParams(*torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if axis_name is not None:
            loss = loss - aux["coupled"].detach() * (
                1.0 - 1.0 / axis_size(axis_name))
        ratio = aux["ratio"].detach()
        ok = (torch.isfinite(ratio) & torch.isfinite(grads.raw_off)
              & torch.isfinite(grads.raw_gap)
              & torch.isfinite(grads.raw_lvl))                    # [B]
        out = {"loss": loss / b, "tau": tau,
               "penalty": aux["penalty"].detach(),
               "dispatch_ratio": aux["dispatch_ratio"].detach(),
               "guard_rejects": torch.sum((~ok).to(torch.float32))}
        if telemetry:
            norm = torch.sqrt(grads.raw_off ** 2 + grads.raw_gap ** 2
                              + grads.raw_lvl ** 2)              # [B]
            out["grad_norm"] = torch.mean(norm)
            out["clip_frac"] = (
                torch.mean((norm > cfg.clip_norm).to(norm.dtype))
                if cfg.clip_norm else torch.zeros((), dtype=norm.dtype,
                                                  device=norm.device))
        g_safe = tree_map(lambda g: torch.where(ok, g, 0.0), grads)
        new_p, new_st, _ = adamw_update(g_safe, st, raw, opt, per_row=True,
                                        stats=False)
        # backed-off rows blend toward the Adam target; where(lr == 1)
        # selects new_p itself because raw + 1.0 * (new_p - raw) is NOT a
        # bitwise identity
        applied = tree_map(
            lambda n, r: torch.where(lr_scale == 1.0, n,
                                     r + lr_scale * (n - r)), new_p, raw)
        raw_new = tree_map(lambda a, r: torch.where(ok, a, r), applied, raw)
        st_new = AdamWState(
            step=new_st.step,       # the global step counts every attempt
            mu=tree_map(lambda n, o: torch.where(ok, n, o), new_st.mu,
                        st.mu),
            nu=tree_map(lambda n, o: torch.where(ok, n, o), new_st.nu,
                        st.nu))
        lr_new = torch.where(ok, lr_scale,
                             torch.clamp(lr_scale * 0.5,
                                         min=_LR_BACKOFF_FLOOR))
        return (raw_new, st_new, lr_new), out

    return step


def _run_steps(carry, problem: TuneProblem, coupling, cfg: TuneConfig,
               lo: int, hi: int, p_rows: torch.Tensor,
               telemetry: bool = False, axis_name: Optional[str] = None,
               scale_rows: Optional[int] = None):
    """Steps ``lo``..``hi`` of the anneal, then the boundary's hard
    re-evaluation. Returns ``(carry, outs, cpc_rows)``, all on the
    device."""
    b = carry[0].raw_off.shape[0]
    step = _make_step(problem, cfg, coupling, b, p_rows, telemetry,
                      axis_name, scale_rows)
    taus = _tau_schedule(cfg, p_rows.device)
    outs = []
    for i in range(lo, hi):
        carry, o = step(carry, taus[i])
        outs.append(o)
    with torch.no_grad():
        ph = transform(carry[0])
        cpc_rows = _hard_cpc_rows(ph.p_on, ph.p_off, ph.off_level, problem,
                                  p_rows)
    return carry, outs, cpc_rows


def _stack(outs: list) -> dict:
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def tune_loop(raw0: PolicyParams, problem: TuneProblem, coupling=None, *,
              cfg: TuneConfig, telemetry: bool = False,
              axis_name: Optional[str] = None,
              scale_rows: Optional[int] = None):
    """The tuner hot loop: tau-annealed Adam over all rows in
    ``cfg.eval_stages`` stages, with the hard CPC re-evaluated at each
    stage boundary. The row prices are gathered once; nothing is read
    back to the host. Returns ``(raw_f, history, cpc_tuned)`` as device
    tensors: history arrays are [steps], ``history["stage_cpc"]``
    [stages] (its last entry is the mean of ``cpc_tuned``, the final hard
    re-evaluation). ``coupling`` (a `DispatchCoupling`, from
    `dispatch_coupling_from_grid`) switches on the dispatch-aware fleet
    term. ``telemetry`` adds ``grad_norm`` / ``clip_frac`` to the history
    (see `_make_step`), with the parameters unchanged bit for bit.
    ``axis_name`` / ``scale_rows`` run one rank's shard of a sharded run
    under an active row mesh (see `_make_step`)."""
    p_rows = problem.row_prices()
    bounds = _stage_bounds(cfg)
    carry = _init_carry(raw0)
    outs, stage_cpc = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        carry, o, cpc_rows = _run_steps(carry, problem, coupling, cfg, lo,
                                        hi, p_rows, telemetry, axis_name,
                                        scale_rows)
        outs += o
        stage_cpc.append(torch.mean(cpc_rows))
    hist = _stack(outs)
    hist["stage_cpc"] = torch.stack(stage_cpc)
    return carry[0], hist, cpc_rows


def _ckpt_template(carry, n_steps_done: int, n_stages_done: int,
                   telemetry: bool = False) -> dict:
    """Zero-filled tree matching a `tune_loop_checkpointed` save after
    ``n_stages_done`` stages — what `load_checkpoint` restores into."""
    keys = ["dispatch_ratio", "guard_rejects", "loss", "penalty", "tau"]
    if telemetry:
        keys += ["clip_frac", "grad_norm"]
    return {
        "carry": carry,
        "hist": {k: np.zeros((n_steps_done,), np.float32) for k in keys},
        "stage_cpc": np.zeros((n_stages_done,), np.float32),
        "cpc_rows": torch.zeros_like(carry[2]),
    }


def tune_loop_checkpointed(raw0: PolicyParams, problem: TuneProblem,
                           coupling=None, *, cfg: TuneConfig, directory,
                           telemetry: bool = False, keep: int = 2):
    """`tune_loop` as resumable anneal stages with the full optimizer
    carry checkpointed at every stage boundary (`repro_torch.checkpoint`,
    the reference's layout and leaf keys).

    After each stage the carry — raw params, per-row Adam moments, the
    guard's lr multipliers — plus the accumulated history and stage CPCs
    land under ``directory``. A rerun over the same directory restores
    the newest stage and continues: a killed run resumed this way equals
    one that never died bit for bit, because the restored carry is the
    exact bytes the uninterrupted run carried and every remaining stage
    runs the same per-step code (every kernel of the step is
    deterministic). ``coupling`` switches on the dispatch-aware term as
    in `tune_loop`, ``telemetry`` the per-step ``grad_norm`` /
    ``clip_frac`` (a run resumes with the flag it was saved with).
    Returns ``(raw_f, history, cpc_tuned)`` with numpy histories."""
    dev = problem.market_idx.device
    raw0 = PolicyParams(*(_f32(a, dev) for a in raw0))
    p_rows = problem.row_prices()
    bounds = _stage_bounds(cfg)
    n_stages = len(bounds) - 1
    mgr = CheckpointManager(directory, keep=keep)
    carry = _init_carry(raw0)
    hists: list = []
    stage_cpc: list = []
    cpc_rows = None
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        k = min(int(latest), n_stages)
        tree, _ = mgr.restore(_ckpt_template(carry, bounds[k], k,
                                             telemetry), step=latest)
        carry = tree["carry"]
        hists = [tree["hist"]]
        stage_cpc = [np.float32(v) for v in tree["stage_cpc"]]
        cpc_rows = tree["cpc_rows"]
        start = k
    for k in range(start, n_stages):
        carry, outs, cpc_rows = _run_steps(carry, problem, coupling, cfg,
                                           bounds[k], bounds[k + 1], p_rows,
                                           telemetry)
        hists.append({kk: v.cpu().numpy() for kk, v in _stack(outs).items()})
        stage_cpc.append(np.float32(torch.mean(cpc_rows).item()))
        hist_acc = {kk: np.concatenate([hh[kk] for hh in hists])
                    for kk in hists[0]}
        mgr.save(k + 1, {
            "carry": carry, "hist": hist_acc,
            "stage_cpc": np.asarray(stage_cpc, np.float32),
            "cpc_rows": cpc_rows},
            metadata={"stage": k + 1, "steps": cfg.steps}, blocking=True)
    hist = {kk: np.concatenate([np.asarray(hh[kk]) for hh in hists])
            for kk in hists[0]}
    hist["stage_cpc"] = np.asarray(stage_cpc, np.float32)
    return carry[0], hist, cpc_rows


# history keys that count events over rows merge across chunks and shards
# by summing; everything else (losses, taus, fractions) averages
_HIST_MERGE = {"guard_rejects": np.sum}

_PROBLEM_ROW_FIELDS = tuple(f for f in TuneProblem._fields if f != "prices")
_COUPLING_SHARED = ("prices", "keys", "order", "demand", "migrate_cost",
                    "cpc_ref")


def _take_problem(problem: TuneProblem, idx: np.ndarray) -> TuneProblem:
    """Row-slice every [B] field of a `TuneProblem` (prices stay
    shared)."""
    return take_rows(problem, idx, shared=("prices",))


def _merge(hists: dict) -> dict:
    """Stacked [chunks or shards, ...] histories merged as numpy."""
    return {k: _HIST_MERGE.get(k, np.mean)(np.asarray(v), axis=0)
            for k, v in hists.items()}


def _pad_rows(raw0: PolicyParams, problem: TuneProblem,
              coupling: Optional[DispatchCoupling], n_rows: int,
              b_pad: int):
    """Pad the row axis to ``b_pad`` for equal shard widths by repeating
    row 0, the warm start in ``raw0`` included. Padded rows drop out of
    every fleet aggregate: zero site weight (power cap, up-hours), zero
    coupling power and fixed cost, and the dummy dispatch cell ``C`` that
    `soft_dispatch_ratio`'s sharded form discards. Their own trajectory is
    dropped on return, and sum-reduction keeps them out of the real rows'
    gradients."""
    pad = b_pad - n_rows

    def rep0(x):
        return torch.cat([x, x[:1].expand(pad, *x.shape[1:])])

    raw0 = tree_map(rep0, raw0)
    problem = problem._replace(
        **{f: rep0(getattr(problem, f)) for f in _PROBLEM_ROW_FIELDS})
    problem.site_weight[n_rows:] = 0.0
    if coupling is not None:
        c = coupling.prices.shape[0]
        coupling = coupling._replace(
            cell_id=torch.cat([coupling.cell_id, torch.full_like(
                coupling.cell_id[:1], c).expand(pad)]),
            fixed=rep0(coupling.fixed), power=rep0(coupling.power))
        coupling.fixed[n_rows:] = 0.0
        coupling.power[n_rows:] = 0.0
    return raw0, problem, coupling


def _share(out, n_dev: int):
    """Hand a mesh's result to the ranks outside it (the row mesh takes
    the first ``n_dev`` ranks; its rank 0 sends)."""
    if dist.get_world_size() == n_dev:
        return out
    box = [None]
    if out is not None:
        raw_f, hist, cpc = out
        box = [([x.cpu() for x in raw_f], hist, cpc.cpu())]
    dist.broadcast_object_list(box, src=0)
    if out is not None:
        return out
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    raw_f, hist, cpc = box[0]
    return PolicyParams(*(x.to(dev) for x in raw_f)), hist, cpc.to(dev)


def _run_sharded(raw0: PolicyParams, problem: TuneProblem, cfg: TuneConfig,
                 n_rows: int, n_dev: int,
                 coupling: Optional[DispatchCoupling], telemetry: bool):
    """The loop over a row mesh of ``n_dev`` ranks: rows padded to equal
    shard widths (`_pad_rows`), each rank's contiguous slice tuned with
    the fleet aggregates reduced across the ranks, and every per-row
    output all-gathered and trimmed, so each rank returns the whole
    result; the ranks' histories merge as chunks' do."""
    width = -(-n_rows // n_dev)
    b_pad = width * n_dev
    if b_pad != n_rows:
        raw0, problem, coupling = _pad_rows(raw0, problem, coupling, n_rows,
                                            b_pad)
    mesh = row_mesh(n_dev)
    coord = mesh.get_coordinate()
    out = None
    if coord is not None:
        sl = np.arange(coord[0] * width, (coord[0] + 1) * width)
        idx = torch.as_tensor(sl, device=raw0.raw_off.device)
        if coupling is not None:
            coupling = take_rows(coupling, sl, shared=_COUPLING_SHARED)
        with use_sharding(mesh, current_rules()):
            raw_f, hist, cpc = tune_loop(
                tree_map(lambda x: x[idx], raw0), _take_problem(problem, sl),
                coupling, cfg=cfg, telemetry=telemetry, axis_name="rows",
                scale_rows=n_rows)
            out = (PolicyParams(*(all_gather(x, "rows").reshape(-1)[:n_rows]
                                  for x in raw_f)),
                   _merge({k: all_gather(v, "rows").cpu()
                           for k, v in hist.items()}),
                   all_gather(cpc, "rows").reshape(-1)[:n_rows])
    return _share(out, n_dev)


def _run_loop(raw0: PolicyParams, problem: TuneProblem, cfg: TuneConfig,
              n_rows: int, coupling: Optional[DispatchCoupling] = None,
              telemetry: bool = False):
    """Run the hot loop under the `ExecutionPlan`: one program; fixed row
    chunks padded to one shape by repeating row 0 (per-row math is
    batch-independent, so the real rows are unaffected; the loss
    *history*, a diagnostic, averages over the padding); or shards over
    the ranks of the default process group (`_run_sharded`):
    ``mode='sharded'`` over ``min(devices, ranks, B // 2)`` of them,
    coupled objectives included, and ``mode='auto'`` an uncoupled,
    unchunked loop over the largest divisor of B that keeps >= 2 rows a
    shard. With one rank both are the single program. Returns
    ``(raw_f, history as numpy, cpc_tuned)``."""
    plan = cfg.resolved_plan
    rc = cfg.resolved_coupling
    coupled = coupling is not None or rc.power_cap_mw is not None \
        or rc.min_up_hours is not None
    validate_plan_coupling(plan, rc, context="TuneConfig")
    chunk = plan.chunk_rows
    if chunk and n_rows > chunk:
        raws, cpcs, hists = [], [], []
        for sl in row_chunks(n_rows, chunk):
            idx = torch.as_tensor(sl, device=raw0.raw_off.device)
            r, h, cp = tune_loop(tree_map(lambda x: x[idx], raw0),
                                 _take_problem(problem, sl), cfg=cfg,
                                 telemetry=telemetry)
            raws.append(r)
            hists.append({k: v.cpu().numpy() for k, v in h.items()})
            cpcs.append(cp)
        return (concat_rows(raws, n_rows),
                _merge({k: [h[k] for h in hists] for k in hists[0]}),
                concat_rows(cpcs, n_rows))
    n_avail = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = 1
    if plan.mode == "sharded":
        cap = plan.devices if plan.devices else n_avail
        # >= 2 rows a shard, as the reference keeps
        n_dev = max(1, min(cap, n_avail, n_rows // 2))
    elif plan.mode == "auto" and not coupled and not chunk:
        n_dev = next((d for d in range(min(n_avail, n_rows // 2), 0, -1)
                      if n_rows % d == 0), 1)
    if n_dev > 1:
        return _run_sharded(raw0, problem, cfg, n_rows, n_dev, coupling,
                            telemetry)
    raw_f, hist, cpc = tune_loop(raw0, problem, coupling, cfg=cfg,
                                 telemetry=telemetry)
    return raw_f, {k: v.cpu().numpy() for k, v in hist.items()}, cpc


class _ShardedLoss(torch.autograd.Function):
    """The global coupled loss of `sharded_soft_objective`, differentiable
    in the raw parameters: the forward keeps this rank's graph of its
    *local* loss, the backward differentiates it and all-gathers the
    rows' gradients (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, local_fn, sl, n_rows, *raw):
        leaves = [x.detach()[sl].requires_grad_(True) for x in raw]
        with torch.enable_grad():
            loss, aux = local_fn(PolicyParams(*leaves))
        ctx.local = (loss, leaves, n_rows, current_mesh())
        # the separable part summed over the ranks, the coupled one once
        return psum(aux["base"].detach(), "rows") + aux["coupled"].detach()

    @staticmethod
    def backward(ctx, ct):
        loss, leaves, n_rows, mesh = ctx.local
        grads = torch.autograd.grad(loss, leaves)
        with use_sharding(mesh, current_rules()):
            return (None, None, None) + tuple(
                all_gather(g, "rows").reshape(-1)[:n_rows] * ct
                for g in grads)


def sharded_soft_objective(raw: PolicyParams, problem: TuneProblem, tau,
                           *, n_dev: int,
                           coupling: Optional[DispatchCoupling] = None,
                           **kwargs) -> torch.Tensor:
    """The global coupled loss evaluated over a row mesh of ``n_dev``
    ranks — the acceptance probe of the sharded tuner.

    Every rank of the mesh calls it with the whole ``raw`` and
    ``problem`` (SPMD). Each evaluates `soft_objective` on its contiguous
    slice of the rows with ``axis_name='rows'`` (fleet aggregates reduced
    across the ranks, the coupled term the same on every rank) and the
    global value is ``psum(aux['base']) + aux['coupled']``: ULP-equal to
    the single program's ``reduction='sum'`` loss. Its gradient in
    ``raw`` is each rank's gradient of its *local* loss ``base +
    coupled`` in its own rows, all-gathered: the single program's per-row
    gradient (other ranks' base terms do not touch these rows, and the
    coupled aggregates reduce through `psum_id`). ``kwargs`` forward into
    `soft_objective`; ``problem``, ``coupling`` and ``tau`` are constants.
    B must split evenly over the ``n_dev`` ranks.
    """
    b = raw.raw_off.shape[0]
    if b % n_dev:
        raise ValueError(
            f"sharded_soft_objective: {b} rows do not split evenly over "
            f"{n_dev} shards — pad the batch (see _pad_rows) or pick a "
            "divisor shard count")
    mesh = row_mesh(n_dev)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"sharded_soft_objective: rank {dist.get_rank()} "
                         f"is outside the {n_dev}-rank row mesh")
    width = b // n_dev
    sl = np.arange(coord[0] * width, (coord[0] + 1) * width)
    problem_s = _take_problem(problem, sl)
    coupling_s = None if coupling is None else take_rows(
        coupling, sl, shared=_COUPLING_SHARED)

    def local_fn(raw_s):
        return soft_objective(raw_s, problem_s, tau, dispatch=coupling_s,
                              reduction="sum", axis_name="rows",
                              scale_rows=b, **kwargs)

    with use_sharding(mesh, current_rules()):
        return _ShardedLoss.apply(local_fn, slice(sl[0], sl[-1] + 1), b,
                                  *raw)


def _hard_cpc_batched(p_on, p_off, off_level, problem: TuneProblem,
                      chunk_rows: int) -> np.ndarray:
    """`hard_cpc`, optionally in row chunks so the [B, T] price gather
    never exceeds the chunk footprint."""
    b = p_on.shape[0]
    if not chunk_rows or b <= chunk_rows:
        return hard_cpc(p_on, p_off, off_level, problem).cpu().numpy() \
            .astype(np.float64)
    parts = []
    for sl in row_chunks(b, chunk_rows):
        idx = torch.as_tensor(sl, device=p_on.device)
        parts.append(hard_cpc(p_on[idx], p_off[idx], off_level[idx],
                              _take_problem(problem, sl)))
    return concat_rows(parts, b).cpu().numpy().astype(np.float64)


def cell_best_rows(grid, cpc: np.ndarray) -> np.ndarray:
    """Index of the lowest-CPC row within each row's (market, system)
    cell, mapped back onto rows (robust to row permutations)."""
    key = cell_index(grid)
    best: dict[int, int] = {}
    for b in range(len(key)):
        c = int(key[b])
        if c not in best or cpc[b] < cpc[best[c]]:
            best[c] = b
    return np.asarray([best[int(c)] for c in key], np.int64)


def _dispatch_reeval(grid, params: PhysicalPolicy, cpc: np.ndarray,
                     best_row: np.ndarray, dcfg: DispatchConfig) -> dict:
    """Score the selected (tuned) and the best-swept policy sets under the
    feasible cross-site dispatcher — one site per (market, system) cell,
    hard constraints instead of the soft tuning penalties — on the grid's
    device. A policy set that cannot meet the configured demand is not
    clipped to fit: it scores ``cpc = inf`` with the `DispatchInfeasible`
    reason recorded, and the feasible set (if any) is chosen."""
    key = cell_index(grid)
    sel: dict[int, int] = {}
    for b in range(len(key)):
        c = int(key[b])
        if c not in sel or cpc[b] < cpc[sel[c]]:
            sel[c] = b
    rows = np.asarray([sel[c] for c in sorted(sel)], np.int64)
    dev = grid.prices.device
    markets = grid.market_idx.cpu().numpy()[rows]
    rows_t = torch.as_tensor(rows, device=dev)

    def run(p_on, p_off, lvl, take):
        take = torch.as_tensor(take, device=dev)
        try:
            return dispatch_solve(build_problem(
                grid.prices[torch.as_tensor(markets, device=dev)],
                p_on[take], p_off[take], lvl[take], grid.power[rows_t],
                dcfg, fixed=grid.fixed[rows_t], device=dev),
                plan=dcfg.plan, device=dev), None
        except DispatchInfeasible as e:
            return None, str(e)

    tuned, why_t = run(params.p_on, params.p_off, params.off_level, rows)
    swept, why_s = run(grid.p_on, grid.p_off, grid.off_level,
                       best_row[rows])
    cpc_t = tuned.cpc if tuned is not None else float("inf")
    cpc_s = swept.cpc if swept is not None else float("inf")
    chosen = None if tuned is None and swept is None else \
        ("tuned" if cpc_t <= cpc_s else "swept")
    names = tuple(f"{grid.market_names[n]}/{grid.system_names[m]}"
                  for n, m in zip(markets,
                                  grid.system_idx.cpu().numpy()[rows])) \
        if grid.market_names and grid.system_names else ()
    return {"cpc_tuned": cpc_t, "cpc_swept": cpc_s, "chosen": chosen,
            "tuned": tuned, "swept": swept, "rows": rows,
            "site_names": names,
            "infeasible_tuned": why_t, "infeasible_swept": why_s}


def _raw_start(grid, warm_start, dev) -> PolicyParams:
    if warm_start is None:
        return init_from_grid(grid)
    if isinstance(warm_start, TuneResult):
        raw0 = warm_start.raw
    elif isinstance(warm_start, PhysicalPolicy):
        raw0 = inverse_transform(warm_start, device=dev)
    elif isinstance(warm_start, PolicyParams):
        raw0 = warm_start
    else:
        raise TypeError("warm_start must be PolicyParams, PhysicalPolicy "
                        f"or TuneResult, got {type(warm_start).__name__}")
    if tuple(np.shape(raw0.raw_off)) != (grid.n_rows,):
        raise ValueError(
            f"warm_start has {tuple(np.shape(raw0.raw_off))} raw_off for a "
            f"{grid.n_rows}-row grid")
    # a copy: the caller's warm-start source stays as it was
    return PolicyParams(*(_f32(a, dev).clone() for a in raw0))


def optimize(grid, cfg: TuneConfig = TuneConfig(), *, warm_start=None,
             device: DeviceLike = None) -> TuneResult:
    """Gradient-tune every scenario row of ``grid`` on ``device``; then
    re-evaluate hard.

    Each row is seeded at its own swept `PolicySpec` (so the grid's K
    policies double as K restarts per (market, system) cell) and tuned
    for ``cfg.steps`` Adam steps under the annealed soft objective.
    ``warm_start`` overrides the seed: a `PolicyParams` (raw), a
    `PhysicalPolicy` (mapped through `inverse_transform`), or a prior
    `TuneResult` (its ``.raw``). The final selection keeps, per row, the
    best hard-CPC policy among the tuned parameters and the swept
    baselines, so when hardware parameters are uniform within a cell the
    reported ``cpc`` matches or beats the best swept policy on every row.
    With coupling penalties or the dispatch-aware term configured the
    swept fallback is disabled (swept policies ignore the constraints) and
    ``cpc`` reports the tuned params. The hard re-evaluations run the
    engine's `fleet_scan` (the CUDA kernel on the card). With
    ``Coupling(dispatch=...)`` every step differentiates through the
    relaxed water-fill (the fused soft-dispatch kernels on the card). With
    ``Coupling(reeval=...)``, or ``dispatch=`` alone, the selected and the
    best-swept policy sets are then re-scored on feasible dispatch
    (`_dispatch_reeval`, the CUDA `dispatch_scan` kernel on the card) into
    `TuneResult.dispatch`; a Coupling-level ``relief`` covers that
    re-scoring too. With a telemetry run active the run's history carries
    ``grad_norm`` / ``clip_frac`` and lands in the trace as ``tune.step``,
    ``tune.stage`` and ``tune.result`` events (`_emit_tune_events`).

    With a `repro_torch.workload.Workload` (``cfg.workload``, defaulting
    to ``grid.workload``) the annealed objective adds the soft work-ledger
    term and the final per-row selection is judged by *realized workload
    cost* — energy + SLO deferral + VoLL drops on one shared demand sample
    (`repro_torch.workload.realized_cost`) — instead of bare CPC, landing
    in ``TuneResult.workload_cost``; the selected policy never costs more
    than the best swept policy of its cell under the same workload.
    """
    telemetry = obs.enabled()
    dev = resolve_device(device)
    grid = grid.to(dev)
    problem = problem_from_grid(grid)
    raw0 = _raw_start(grid, warm_start, dev)
    rc = cfg.resolved_coupling
    chunk = cfg.resolved_plan.chunk_rows
    wl = cfg.workload if cfg.workload is not None \
        else getattr(grid, "workload", None)
    if wl is not None and cfg.workload is None:
        # a grid-carried Workload flows into the loop too
        cfg = cfg._replace(workload=wl)
    coupling = dispatch_coupling_from_grid(grid, rc.dispatch) \
        if rc.dispatch is not None else None
    raw_f, hist, cpc_tuned_dev = _run_loop(raw0, problem, cfg, grid.n_rows,
                                           coupling, telemetry)
    stage_cpc = np.asarray(hist.pop("stage_cpc"), np.float64)
    cpc_tuned = cpc_tuned_dev.cpu().numpy().astype(np.float64)

    # hard re-evaluation of the swept baselines (chunked under the same
    # memory bound the tuning run declared)
    swept_plan = ExecutionPlan(mode="chunked", chunk_rows=chunk,
                               contract="bitwise") if chunk \
        else ExecutionPlan(mode="single")
    swept = backtest(grid, plan=swept_plan, device=dev)
    cpc_swept = swept.cpc.cpu().numpy().astype(np.float64)

    with torch.no_grad():
        tuned = transform(raw_f)
    wc_tuned = wc_swept = None
    if wl is not None:
        # the hard selection yardstick becomes the *realized* workload
        # cost — energy + SLO deferral + VoLL drops — on one shared demand
        # sample, so the tuned/swept comparison is paired and the selected
        # policy can never cost more than the best swept one under the
        # same workload
        from repro_torch.workload import realized_cost
        wl_demand = wl.sample_demand_mw(grid.n_hours)
        wc_tuned, wc_swept = (
            realized_cost(grid, p_on, p_off, lvl, wl, demand_mw=wl_demand)
            .cpu().numpy().astype(np.float64)
            for p_on, p_off, lvl in ((tuned.p_on, tuned.p_off,
                                      tuned.off_level),
                                     (grid.p_on, grid.p_off,
                                      grid.off_level)))
        best_row = cell_best_rows(grid, wc_swept)
    else:
        best_row = cell_best_rows(grid, cpc_swept)
    cpc_swept_best = cpc_swept[best_row]
    bi = torch.as_tensor(best_row, device=dev)
    # cell-best swept params evaluated under *this* row's hardware
    cb = PhysicalPolicy(p_on=grid.p_on[bi], p_off=grid.p_off[bi],
                        off_level=grid.off_level[bi])
    cpc_cb = _hard_cpc_batched(cb.p_on, cb.p_off, cb.off_level, problem,
                               chunk)

    cand = np.stack([cpc_tuned, cpc_swept, cpc_cb])        # [3, B]
    # the selection yardstick: realized workload cost when a Workload is
    # configured, bare hard CPC otherwise
    yard = np.stack([wc_tuned, wc_swept, wc_swept[best_row]]) \
        if wl is not None else cand
    if rc.binds:
        # the swept baselines ignore the coupling constraints: falling
        # back to one would silently violate them — keep the tuned params
        # (dispatch-aware runs likewise: a per-row swept fallback judged on
        # isolated CPC would undo the fleet roles the dispatch term taught;
        # the swept set still competes, as a whole fleet, in the hard
        # re-scoring below)
        source = np.zeros(cand.shape[1], np.int64)
    else:
        source = np.argmin(yard, axis=0)
    cpc = cand[source, np.arange(cand.shape[1])]
    workload_cost = yard[source, np.arange(yard.shape[1])] \
        if wl is not None else None
    src = torch.as_tensor(source, device=dev)
    cols = torch.arange(grid.n_rows, device=dev)

    def pick(tuned_v, own_v, cb_v):
        return torch.stack([tuned_v, own_v, cb_v])[src, cols]

    params = PhysicalPolicy(
        p_on=pick(tuned.p_on, grid.p_on, cb.p_on),
        p_off=pick(tuned.p_off, grid.p_off, cb.p_off),
        off_level=pick(tuned.off_level, grid.off_level, cb.off_level))

    dispatch_out = None
    reeval_cfg = rc.reeval_config
    if reeval_cfg is not None:
        if rc.relief_config is not None and reeval_cfg.relief is None:
            # a Coupling-level relief covers the hard re-scoring too: a
            # degraded policy set sheds at VoLL instead of scoring inf
            reeval_cfg = reeval_cfg._replace(relief=rc.relief_config)
        dispatch_out = _dispatch_reeval(grid, params, cpc, best_row,
                                        reeval_cfg)
    result = TuneResult(
        params=params, raw=raw_f, cpc=cpc, cpc_tuned=cpc_tuned,
        cpc_swept=cpc_swept, cpc_swept_best=cpc_swept_best,
        improvement_vs_best=1.0 - cpc / cpc_swept_best,
        improvement_vs_own=1.0 - cpc / cpc_swept,
        source=source, history=hist, stage_cpc=stage_cpc,
        dispatch=dispatch_out,
        guard_count=int(np.sum(hist.get("guard_rejects", 0.0))),
        workload_cost=workload_cost)
    if telemetry:
        _emit_tune_events(cfg, result)
    return result


def _emit_tune_events(cfg: TuneConfig, res: TuneResult) -> None:
    """Stream the finished run's history into the trace: one
    ``tune.step`` per optimization step (loss / tau / penalty, plus
    grad-norm and clip-fraction — present because the loop ran with its
    telemetry side-outputs), one ``tune.stage`` per hard re-eval
    boundary, one ``tune.result``."""
    hist = res.history
    step_keys = [k for k in ("loss", "tau", "penalty", "dispatch_ratio",
                             "grad_norm", "clip_frac") if k in hist]
    for i in range(len(hist["loss"])):
        obs.trace_event("tune.step",
                        {"step": i,
                         **{k: float(hist[k][i]) for k in step_keys}})
        if "grad_norm" in hist:
            obs.histogram("tune.grad_norm").observe(hist["grad_norm"][i])
    bounds = _stage_bounds(cfg)
    for k, v in enumerate(res.stage_cpc):
        obs.trace_event("tune.stage", {"stage": k,
                                       "through_step": bounds[k + 1],
                                       "cpc_hard_mean": float(v)})
    src_names = ("tuned", "own_swept", "cell_best")
    obs.trace_event("tune.result", {
        "rows": int(res.cpc.shape[0]), "steps": cfg.steps,
        "cpc_mean": float(np.mean(res.cpc)),
        "cpc_tuned_mean": float(np.mean(res.cpc_tuned)),
        "cpc_swept_best_mean": float(np.mean(res.cpc_swept_best)),
        "improvement_vs_best_mean": float(np.mean(res.improvement_vs_best)),
        "source_counts": {src_names[s]: int(n) for s, n in
                          zip(*np.unique(res.source, return_counts=True))}})
    if res.guard_count:
        rej = np.asarray(res.history["guard_rejects"])
        obs.trace_event("tune.guard", {
            "rejects_total": int(res.guard_count),
            "steps_affected": int((rej > 0).sum()),
            "first_step": int(np.argmax(rej > 0)),
            "rows": int(res.cpc.shape[0])})
        obs.counter("tune.guard_rejects").inc(int(res.guard_count))
    obs.gauge("tune.cpc_mean").set(float(np.mean(res.cpc)))
    obs.counter("tune.runs").inc()
