"""Trace event schema: one registry of every event kind the subsystem
emits, with the fields a consumer may rely on.

The schema is additive-versioned: bump `SCHEMA_VERSION` (re-exported
from `registry`) only when an existing field changes meaning; adding
kinds or optional fields is free. `repro_torch.obs.report` treats
unknown kinds as opaque, so older readers survive newer traces.

A copy of the reference's catalogue (`repro.obs.schema`), kept identical
— the kinds of slices not ported yet included — so that either package's
reader validates either package's traces. The emitter names are the
reference's; the port's counterparts sit at the same module paths.
"""

from __future__ import annotations

from .registry import SCHEMA_VERSION  # noqa: F401  (single source of truth)

# kind -> (emitter, required payload fields). Fields not listed here may
# appear but are not contractual. All array fields are JSON lists in
# hour order (index == hour within the instrumented call).
EVENT_KINDS: dict[str, tuple[str, tuple[str, ...]]] = {
    # lifecycle -----------------------------------------------------------
    "run.meta": ("registry.Run", (
        "run_id", "schema_version", "git_sha", "jax", "jaxlib", "backend",
        "device_kind", "timestamp")),
    "run.close": ("registry.Run", ("n_events", "metrics")),
    # tuning --------------------------------------------------------------
    "tune.step": ("tune.optimizer.optimize", (
        "step", "loss", "tau", "penalty")),            # + grad_norm/clip_frac
    "tune.stage": ("tune.optimizer.optimize", (
        "stage", "through_step", "cpc_hard_mean")),
    "tune.result": ("tune.optimizer.optimize", (
        "rows", "steps", "cpc_tuned_mean", "cpc_swept_best_mean",
        "improvement_vs_best_mean", "source_counts")),
    # fleet backtest ------------------------------------------------------
    "fleet.hourly": ("fleet.engine._backtest_jit (io_callback drain)", (
        "on_mw", "draw_price", "starts", "stops")),    # [T] each
    "fleet.backtest": ("fleet.engine.backtest", (
        "rows", "hours", "use_pallas", "n_starts_total")),
    "fleet.summary": ("fleet.report.summarize", (
        "total_cost", "best_reduction", "top_regret")),
    # dispatch ------------------------------------------------------------
    "dispatch.hourly": ("dispatch.allocate.summarize_alloc", (
        "delivered_mwh", "energy_cost", "moved_mw", "slack_capacity_mw",
        "demand_mw", "move_tol", "fixed_cost", "migrate_cost")),
    "dispatch.result": ("dispatch.allocate.summarize_alloc", (
        "cpc", "energy_cost", "migration_cost", "migration_mw",
        "n_migrations", "delivered_mwh", "slack_power_mw",
        "slack_capacity_mw", "slack_floor_mwh", "near_infeasible_hours")),
    "dispatch.infeasible": ("dispatch.allocate._check_feasible", (
        "reason",)),
    # live operator -------------------------------------------------------
    "live.step": ("live.controller._live_scan (io_callback drain)", (
        "on_mw", "cost_rate", "transitions", "abs_err1", "commits")),
    "live.result": ("live.report.summarize_live", (
        "rows", "hours", "cpc_mean", "regret_oracle_mean",
        "regret_offline_mean", "mae1_mean", "churn_total")),
    # workload ------------------------------------------------------------
    "workload.hourly": (
        "workload.backtest._workload_backtest_jit (io_callback drain)", (
            "demand_mwh", "served_mwh", "dropped_mwh", "backlog_mwh")),
    "workload.result": ("workload.backtest.workload_backtest", (
        "rows", "hours", "n_draws", "served_mwh", "dropped_mwh",
        "deferred_mwh_h", "drop_frac", "cpc_p10_mean", "cpc_p50_mean",
        "cpc_p90_mean")),
    # faults & degradation ------------------------------------------------
    "fault.injected": ("faults.inject.emit_fault_events", (
        "fault", "target", "start", "duration", "magnitude", "scope")),
    "dispatch.shed": ("dispatch.allocate.summarize_alloc", (
        "shed_mwh", "shed_cost", "n_shed_hours", "voll_eur_mwh")),
    "live.fallback": ("live.controller.live_backtest", (
        "fresh", "stale_shift", "seasonal_naive", "persistence",
        "forced_off_row_hours", "stale_price_row_hours")),
    "tune.guard": ("tune.optimizer.optimize", (
        "rejects_total", "steps_affected", "first_step", "rows")),
    # data loading --------------------------------------------------------
    "loader.skipped_rows": ("energy.smard._finalize", (
        "loader", "path", "n_rows", "n_parsed", "n_skipped", "n_nan",
        "skip_frac", "action")),
    # profiling -----------------------------------------------------------
    "profile.span": ("obs.profiling.profiled", ("label", "seconds")),
    "profile.trace": ("obs.profiling.xla_trace", ("label", "dir")),
    "profile.xla": ("obs.profiling.record_compiled", ("label",)),
    # benchmarks ----------------------------------------------------------
    "bench.artifact": ("benchmarks.common.write_artifact", (
        "name", "path")),
}


def validate(event: dict) -> list[str]:
    """Return a list of problems with one decoded trace line (empty ==
    valid). Unknown kinds are allowed; missing contractual fields are
    not."""
    problems = []
    kind = event.get("kind")
    if not kind:
        return ["event has no 'kind'"]
    if event.get("schema") != SCHEMA_VERSION:
        problems.append(
            f"schema {event.get('schema')!r} != {SCHEMA_VERSION}")
    spec = EVENT_KINDS.get(kind)
    if spec is not None:
        missing = [f for f in spec[1] if f not in event]
        if missing:
            problems.append(f"{kind}: missing fields {missing}")
    return problems
