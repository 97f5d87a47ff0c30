"""The ``tune`` entry: a closed loop of one caller running tuner jobs.

Set-up builds the grid of the configuration's markets (the mix's number
of price years each) x systems x the mix's policies, the tuning problem
and, with a ``dispatch`` coupling, the fleet's dispatch coupling; it
warms up with a job of ``eval_stages`` steps (every kernel and shape of
a job). Each job in the window starts from the swept policies
(`init_from_grid`) and runs `tune_loop` with the mix's `TuneConfig`; it
ends when its loss history, guard count and hard-evaluated CPC are on
the host. The window starts at the first job's start and ends at the end
of the job that crosses ``--seconds``. The rate is reported under each
of the cell's end-to-end metrics in ``row-steps/s``. With ``--trace 1``
the mix's ``trace_jobs`` jobs run under the profiler first, outside the
window.

Check, every job: no row-step rejected by the finite-step guard and
every loss finite; the first ``check_steps`` losses against the
reference's replay from its own swept start; the job's final thresholds
re-backtested hard against its CPC. Uncoupled (``replay_rows`` in the
mix), each row is a problem of its own, so the reference also replays
all the steps for a sample of rows drawn from the seed, and each job's
final raw variables of those rows are held against it: the parameters'
change from the start, by the worst leaf.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import inputs
from harness.entries import Outcome, Run, memory_peak
from harness.trace import Tracer
from reference import fleet as ref_fleet
from reference import grid as ref_grid
from reference import soft as ref_soft

# rows x hours of one block of the reference's uncoupled objective: its
# doubling scan keeps ~40 [rows, hours] float64 tensors for autograd
REF_BLOCK_ELEMS = 2 ** 25
N_BISECT = 30   # the water-fill's bisection levels an hour (the port's)
REPLAY_STREAM = 4
MIX_KEYS = {"entry", "why", "years_per_market", "policies", "coupling",
            "tune", "check_steps", "replay_rows", "trace_jobs"}
LEAVES = ("off", "gap", "lvl")
# a leaf whose first gradient in the reference is under this share of the
# median leaf's moves by round-off alone, and is left out of the change
QUIET_LEAF = 1e-3
# the [B] fields of a row that its relaxed ratio reads
ROW_FIELDS = ("fixed", "power", "period", "idle_frac", "restart_energy_mwh",
              "restart_time_h", "price_sum")


def setup(r: Run, hours: int | None = None) -> dict:
    from repro_torch.fleet import build_grid
    from repro_torch.tune import (Coupling, TuneConfig,
                                  dispatch_coupling_from_grid,
                                  problem_from_grid)

    cfg, mix = r.cell.config, r.cell.mix
    prices = inputs.prices(cfg, mix, r.seed, r.device, hours)
    grid = build_grid(prices, inputs.port_systems(cfg, hours),
                      inputs.port_policies(mix["policies"]),
                      market_names=inputs.market_names(cfg, mix),
                      device=r.device)
    coupling, kw = None, dict(mix["tune"])
    if mix.get("coupling"):
        from repro_torch.dispatch import DispatchConfig
        c = dict(mix["coupling"])
        if c.pop("kind") != "dispatch":
            raise ValueError("the tune entry couples by dispatch only")
        dcfg = DispatchConfig(**r.cell.config["dispatch"])
        coupling = dispatch_coupling_from_grid(grid, dcfg)
        kw["coupling"] = Coupling(dispatch=dcfg, **c)
    return {"prices": prices, "grid": grid,
            "problem": problem_from_grid(grid), "coupling": coupling,
            "tcfg": TuneConfig(**kw), "warm": TuneConfig(**{
                **kw, "steps": int(kw.get("eval_stages", 4))})}


def job(st: dict, tcfg=None) -> dict:
    """One job: swept start, `tune_loop`, results on the host."""
    from repro_torch.tune import init_from_grid, tune_loop
    t0 = time.perf_counter()
    raw0 = init_from_grid(st["grid"])
    raw, hist, cpc = tune_loop(raw0, st["problem"], st["coupling"],
                               cfg=tcfg or st["tcfg"])
    t_enqueued = time.perf_counter()
    out = {"loss": hist["loss"].cpu().numpy(),
           "guard_rejects": float(hist["guard_rejects"].sum()),
           "cpc": cpc.cpu().numpy(),
           "raw": {"off": raw.raw_off.cpu().numpy(),
                   "gap": raw.raw_gap.cpu().numpy(),
                   "lvl": raw.raw_lvl.cpu().numpy()}}
    out["enqueue_s"] = t_enqueued - t0
    out["wall_s"] = time.perf_counter() - t0
    return out


def run(r: Run) -> Outcome:
    st = setup(r)
    job(st, st["warm"])
    r.sync()
    steps = st["tcfg"].steps
    b = st["grid"].n_rows
    setup_s = time.perf_counter() - r.t0
    jobs, failed = [], 0

    def one() -> bool:
        nonlocal failed
        try:
            jobs.append(job(st))
            return True
        except RuntimeError as e:       # a job the port failed
            print(f"perfbench: job {len(jobs)} failed: {e}",
                  file=sys.stderr)
            failed += 1
            return False

    # the traced job runs before the window: stopping the profiler takes
    # seconds that no job of the window should wait on
    n_traced = int(r.cell.mix.get("trace_jobs", 1)) if r.trace else 0
    with Tracer(n_traced > 0, r.sync) as tracer:
        ok = all(one() for _ in range(n_traced))
    n_traced = len(jobs)
    t_start = time.perf_counter()
    while ok and one() and time.perf_counter() - t_start < r.seconds:
        pass
    window_s = time.perf_counter() - t_start
    peak = memory_peak(r.device)
    tr = tracer.result()
    prices = st["prices"]
    del st
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    rate = b * steps * (len(jobs) - n_traced) / window_s
    e2e = {m["name"]: rate for m in r.cell.end_to_end
           if m["unit"] == "row-steps/s"}
    shape = _shape(r, b, prices.shape[1])
    shape["traced_jobs"] = n_traced
    spans = {"enqueue_ms_per_step": [1e3 * j["enqueue_s"] / steps
                                     for j in jobs],
             "wall_ms_per_step": [1e3 * j["wall_s"] / steps for j in jobs]}
    t_check = time.perf_counter()
    checks = check(r, prices, jobs) if jobs else {}
    check_s = time.perf_counter() - t_check
    return Outcome(setup_s=setup_s, window_s=window_s,
                   attempted=len(jobs) + failed, failed=failed, e2e=e2e,
                   checks=checks, memory_peak_bytes=peak, shape=shape,
                   spans=spans, trace=tr,
                   check_s=check_s)


def _shape(r: Run, b: int, t: int) -> dict:
    mix = r.cell.mix
    sites = None
    if mix.get("coupling"):
        sites = len(r.cell.config["markets"]) * int(mix["years_per_market"]) \
            * len(r.cell.config["systems"]["psi"])
    return {"rows": b, "hours": t, "steps": int(mix["tune"]["steps"]),
            "block_t": int(mix["tune"].get("block_t", 256)), "sites": sites,
            "n_bisect": N_BISECT}


# --- the check ------------------------------------------------------------

def reference_inputs(r: Run, prices: torch.Tensor, dtype) -> dict:
    cfg = r.cell.config
    rows = ref_grid.rows(prices, inputs.systems(cfg, prices.shape[1]),
                         r.cell.mix["policies"], dtype)
    rows["price_sum"] = rows["market_price_sum"][rows["market"]]
    return rows


def reference_start(rows: dict, dtype) -> dict:
    """The swept start of every row, as the reference maps it."""
    raw32 = ref_soft.initial_raw(rows["p_on"], rows["p_off"],
                                 rows["off_level"],
                                 rows["market_p_max"][rows["market"]])
    return {k: v.to(dtype) for k, v in raw32.items()}


def reference_losses(r: Run, prices: torch.Tensor, dtype) -> np.ndarray:
    """The first ``check_steps`` losses (/ rows) of the tuner, replayed
    by the reference in ``dtype`` from its own swept start."""
    mix = r.cell.mix
    tk = mix["tune"]
    rows = reference_inputs(r, prices, dtype)
    raw = reference_start(rows, dtype)
    adam = ref_soft.Adam(raw, tk["lr"], tk["b1"], tk["b2"], tk["eps"])
    taus = ref_soft.tau_schedule(int(tk["steps"]), tk["tau_start"],
                                 tk["tau_end"], prices.device)
    b = rows["market"].shape[0]
    losses = []
    n = int(mix["check_steps"])
    for i in range(n):
        tau = taus[i].to(dtype)
        loss, grads = _loss_and_grads(r, prices, rows, raw, tau, dtype,
                                      want_grad=i < n - 1)
        losses.append(float(loss) / b)
        if i < n - 1:
            raw = adam.step(raw, grads)
    return np.array(losses)


def _loss_and_grads(r, prices, rows, raw, tau, dtype, want_grad):
    b, t = rows["market"].shape[0], prices.shape[1]
    coupling = r.cell.mix.get("coupling")
    if coupling:
        block = b
    else:
        block = max(1, REF_BLOCK_ELEMS // t)
    total = torch.zeros((), dtype=torch.float64)
    grads = {k: torch.zeros_like(v) for k, v in raw.items()}
    for lo in range(0, b, block):
        sl = slice(lo, min(b, lo + block))
        leaves = {k: v[sl].detach().clone().requires_grad_(want_grad)
                  for k, v in raw.items()}
        with torch.set_grad_enabled(want_grad):
            p = prices[rows["market"][sl]].to(dtype)
            ratio, cap = ref_soft.row_ratio(
                leaves, {f: rows[f][sl] for f in ROW_FIELDS}, p, tau)
            loss = ratio.sum()
            if coupling:
                loss = _coupled_loss(r, prices, rows, ratio, cap, tau, dtype,
                                     loss)
        if want_grad:
            for k, g in zip(leaves, torch.autograd.grad(loss,
                                                        list(leaves.values()))):
                grads[k][sl] = g
        total += loss.detach().double().cpu()
    return total, grads


def _coupled_loss(r, prices, rows, ratio, cap, tau, dtype, base):
    """(1 - blend) sum ratio + blend B fleet_ratio + B weight shortfall,
    the fleet term's hour loop on the host."""
    from reference import dispatch as ref_dispatch

    c = r.cell.mix["coupling"]
    d = r.cell.config["dispatch"]
    m, k = len(r.cell.config["systems"]["psi"]), len(r.cell.mix["policies"])
    cell = rows["market"] * m + rows["system"]
    cells = int(cell.max()) + 1
    cpu = torch.device("cpu")
    members = (cell[None, :] == torch.arange(cells, device=cell.device)
               [:, None]).to(torch.float64) / k               # [C, B] means
    power_c = members @ rows["power"].double()
    fixed_c = members @ rows["fixed"].double()
    prices_c = prices[torch.arange(cells, device=cell.device) // m].double()
    demand = torch.full((prices.shape[1],),
                        float(np.float32(d["demand_frac"]
                                         * float(power_c.sum()))),
                        dtype=torch.float64)
    cpc_ref = (fixed_c.sum() + (demand.to(cell.device)
                                * prices_c.mean(0)).sum()) / demand.sum().to(
        cell.device)
    site = {"cell": cell.to(cpu), "power": rows["power"].to(cpu),
            "fixed": rows["fixed"].to(cpu), "prices": prices_c.to(cpu),
            "demand": demand, "migrate_cost": float(d["migrate_cost"]),
            "min_dwell": int(d["min_dwell_h"]),
            "mw_scale": float(c["dispatch_mw_scale"]),
            "cpc_ref": float(cpc_ref)}
    tau_c = tau.to(cpu)
    dratio, short = ref_dispatch.fleet_ratio(cap.to(cpu), ratio.to(cpu),
                                             site, tau_c)
    b = ratio.shape[0]
    blend, weight = float(c["dispatch_blend"]), float(c["penalty_weight"])
    loss = (1.0 - blend) * base.to(cpu) + blend * b * dratio \
        + b * weight * short
    return loss


def replay_rows(r: Run, b: int) -> np.ndarray:
    """The rows the reference tunes through every step: ``replay_rows``
    of the ``b``, drawn from the seed (none where the mix couples)."""
    n = int(r.cell.mix.get("replay_rows", 0))
    if not n or r.cell.mix.get("coupling"):
        return np.zeros(0, np.int64)
    return np.sort(r.rng(REPLAY_STREAM).choice(b, min(n, b), replace=False))


def reference_replay(r: Run, prices: torch.Tensor, idx: np.ndarray,
                     dtype) -> dict:
    """Rows ``idx`` tuned by the reference through all the mix's steps in
    ``dtype``, from its own swept start: uncoupled, each row's gradient
    is that of its own ratio, so the sample is tuned as in the whole job.
    Returns the start, the final raw variables and each leaf's first
    gradient norm."""
    tk = r.cell.mix["tune"]
    rows = reference_inputs(r, prices, dtype)
    start = reference_start(rows, dtype)
    sel = torch.as_tensor(idx, device=rows["market"].device)
    rows = {k: rows[k][sel] for k in ("market",) + ROW_FIELDS}
    raw = {k: v[sel] for k, v in start.items()}
    start = dict(raw)
    adam = ref_soft.Adam(raw, tk["lr"], tk["b1"], tk["b2"], tk["eps"])
    taus = ref_soft.tau_schedule(int(tk["steps"]), tk["tau_start"],
                                 tk["tau_end"], prices.device)
    g0 = None
    for tau in taus:
        _, grads = _loss_and_grads(r, prices, rows, raw, tau.to(dtype),
                                   dtype, want_grad=True)
        if g0 is None:
            g0 = {k: float(torch.linalg.vector_norm(g.double()))
                  for k, g in grads.items()}
        raw = adam.step(raw, grads)
    return {"start": {k: v.double().cpu().numpy() for k, v in start.items()},
            "final": {k: v.double().cpu().numpy() for k, v in raw.items()},
            "grad0": g0}


def change_gap(got_final: dict, want: dict) -> float:
    """The parameters' change from the reference's start, by the worst
    leaf: the gap between the job's norm of a leaf's change and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose first gradient is nought to
    round-off in the reference are left out."""
    g0 = want["grad0"]
    med_g = float(np.median(list(g0.values())))
    keep = [k for k in LEAVES if g0[k] >= QUIET_LEAF * med_g]
    norm = {k: float(np.linalg.norm(want["final"][k] - want["start"][k]))
            for k in LEAVES}
    med = float(np.median([norm[k] for k in keep]))
    gaps = [abs(float(np.linalg.norm(np.asarray(got_final[k], np.float64)
                                      - want["start"][k])) - norm[k])
            / max(norm[k], med, 1e-30) for k in keep]
    return max(gaps)


def reference_cpc(r: Run, prices: torch.Tensor, raw: dict,
                  dtype) -> np.ndarray:
    """[B] hard CPC at a job's final raw variables: the reference's
    float32 map onto the thresholds (as stated) and its backtest, sums in
    ``dtype``."""
    rows = reference_inputs(r, prices, dtype)
    ph = ref_soft.transform({k: torch.as_tensor(v, device=prices.device)
                             .to(torch.float32) for k, v in raw.items()})
    sums = ref_fleet.hard_sums(prices, rows["market"], ph["p_on"],
                               ph["p_off"], ph["off_level"],
                               rows["idle_frac"], dtype)
    out = ref_fleet.costs(sums, rows["price_sum"], rows["fixed"],
                          rows["power"], rows["period"],
                          rows["restart_energy_mwh"], rows["restart_time_h"],
                          prices.shape[1])
    return out["cpc"].double().cpu().numpy()


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    return float(np.nanmax(np.where(np.isfinite(g), g, np.inf)))


def check(r: Run, prices: torch.Tensor, jobs: list,
          dtype=torch.float64) -> dict:
    lim = r.cell.limits
    out = {"guard_rejects": (sum(j["guard_rejects"] for j in jobs),
                             lim["guard_rejects"]),
           "nonfinite_losses": (sum(int(np.sum(~np.isfinite(j["loss"])))
                                    for j in jobs), lim["nonfinite_losses"])}
    want_loss = reference_losses(r, prices, dtype)
    n = len(want_loss)
    out["loss_gap"] = (max(rel_gap(j["loss"][:n], want_loss) for j in jobs),
                       lim["loss_gap"])
    cpc_gap, seen = 0.0, {}
    for j in jobs:
        key = b"".join(np.ascontiguousarray(j["raw"][k]).tobytes()
                       for k in LEAVES)
        if key not in seen:
            seen[key] = reference_cpc(r, prices, j["raw"], dtype)
        cpc_gap = max(cpc_gap, rel_gap(j["cpc"], seen[key]))
    out["cpc_gap"] = (cpc_gap, lim["cpc_gap"])
    idx = replay_rows(r, len(jobs[0]["cpc"]))
    if len(idx):
        want = reference_replay(r, prices, idx, dtype)
        out["change_gap"] = (max(change_gap(
            {k: j["raw"][k][idx] for k in LEAVES}, want) for j in jobs),
            lim["change_gap"])
    return out
