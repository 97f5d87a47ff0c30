"""Operator digest of a telemetry run: ``python -m repro_torch.obs.report
<run-dir>`` renders ``trace.jsonl`` into text/markdown — CPC
trajectory, shutdown churn, slack minima, top-k regret rows — and
reconstructs the dispatch totals *from the trace alone* (bit-exact
against `repro_torch.dispatch.DispatchResult`, because
`summarize_alloc` derives its totals from the same per-hour float64
aggregates the ``dispatch.hourly`` event carries). A copy of the
reference's reader (`repro.obs.report`): the same digest from the same
trace file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np

from .schema import SCHEMA_VERSION, validate


def load_events(run_dir) -> list:
    """Decode ``<run-dir>/trace.jsonl`` (list of dicts, file order)."""
    path = Path(run_dir) / "trace.jsonl"
    return [json.loads(line)
            for line in path.read_text(encoding="utf-8").splitlines()
            if line.strip()]


def load_metrics(run_dir) -> dict:
    path = Path(run_dir) / "metrics.json"
    if not path.exists():
        return {}
    return json.loads(path.read_text())


def reconstruct_dispatch(events: list) -> Optional[dict]:
    """Recompute the dispatch totals from the last ``dispatch.hourly``
    event — same float64 arrays, same summation order and the same
    closing expressions as `repro_torch.dispatch.summarize_alloc`, so ``cpc``
    and ``n_migrations`` match the `DispatchResult` bit for bit."""
    hourly = [e for e in events if e.get("kind") == "dispatch.hourly"]
    if not hourly:
        return None
    e = hourly[-1]
    energy_t = np.asarray(e["energy_cost"], np.float64)
    delivered_t = np.asarray(e["delivered_mwh"], np.float64)
    moved = np.asarray(e["moved_mw"], np.float64)
    slack_t = np.asarray(e["slack_capacity_mw"], np.float64)
    energy_cost = float(energy_t.sum())
    migration_mw = float(moved.sum())
    migration_cost = e["migrate_cost"] * migration_mw
    delivered = float(delivered_t.sum())
    return {
        "cpc": (e["fixed_cost"] + energy_cost + migration_cost)
        / max(delivered, 1e-9),
        "energy_cost": energy_cost,
        "migration_cost": migration_cost,
        "migration_mw": migration_mw,
        "n_migrations": int((moved > e["move_tol"]).sum()),
        "delivered_mwh": delivered,
        "slack_capacity_mw": float(slack_t.min()),
        "hours": int(moved.shape[0]),
    }


def _fmt(v, sig: int = 4) -> str:
    """Significant-figure number rendering (stable across jax/platform
    ULP differences — what makes the golden-file test portable)."""
    if v is None:
        return "-"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if not np.isfinite(v):
        return str(v)
    return f"{float(v):.{sig}g}"


def _section(out: list, title: str) -> None:
    out.append(f"\n## {title}\n")


def render_digest(run_dir, *, top_k: int = 5,
                  redact_meta: bool = False) -> str:
    """Markdown digest of one run directory. ``redact_meta`` replaces
    the volatile stamp fields (run id, sha, versions, timestamps) with
    ``<redacted>`` — used by the golden-file test, and handy for
    sharing traces."""
    events = load_events(run_dir)
    by_kind: dict = {}
    for e in events:
        by_kind.setdefault(e.get("kind"), []).append(e)

    out = ["# Telemetry run digest"]
    meta = by_kind.get("run.meta", [{}])[0]
    _section(out, "Run")
    volatile = ("run_id", "git_sha", "timestamp", "jax", "jaxlib",
                "python", "machine", "device_kind", "backend",
                "n_devices")
    for key in ("run_id", "schema_version", "git_sha", "jax", "jaxlib",
                "backend", "device_kind", "n_devices", "timestamp"):
        if key in meta:
            val = "<redacted>" if redact_meta and key in volatile \
                else meta[key]
            out.append(f"- {key}: {val}")
    out.append(f"- events: {len(events)} "
               f"({len(by_kind)} kinds)" if not redact_meta else
               "- events: <redacted>")

    # tuning ----------------------------------------------------------
    steps = by_kind.get("tune.step", [])
    stages = by_kind.get("tune.stage", [])
    results = by_kind.get("tune.result", [])
    if steps or results:
        _section(out, "Tuning")
        if results:
            r = results[-1]
            out.append(f"- rows: {r['rows']}  steps: {r['steps']}")
            out.append(f"- mean CPC: {_fmt(r.get('cpc_mean'))} "
                       f"(tuned {_fmt(r.get('cpc_tuned_mean'))}, best "
                       f"swept {_fmt(r.get('cpc_swept_best_mean'))})")
            out.append("- mean improvement vs best swept: "
                       f"{_fmt(r.get('improvement_vs_best_mean'), 3)}")
            src = r.get("source_counts", {})
            if src:
                out.append("- selection: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(src.items())))
        if steps:
            first, last = steps[0], steps[-1]
            out.append(f"- soft loss: {_fmt(first['loss'])} -> "
                       f"{_fmt(last['loss'])} over {len(steps)} steps "
                       f"(tau {_fmt(first['tau'], 3)} -> "
                       f"{_fmt(last['tau'], 3)})")
            if "grad_norm" in first:
                out.append(f"- grad norm: {_fmt(first['grad_norm'], 3)} "
                           f"-> {_fmt(last['grad_norm'], 3)}; mean clip "
                           "fraction "
                           f"{_fmt(float(np.mean([s['clip_frac'] for s in steps])), 3)}")
        if stages:
            out.append("- hard-CPC anneal curve (per stage boundary):")
            for s in stages:
                out.append(f"  - stage {s['stage']} (through step "
                           f"{s['through_step']}): "
                           f"{_fmt(s['cpc_hard_mean'])}")

    # fleet backtests -------------------------------------------------
    backs = by_kind.get("fleet.backtest", [])
    hourly = by_kind.get("fleet.hourly", [])
    if backs or hourly:
        _section(out, "Fleet backtests")
        if backs:
            b = backs[-1]
            out.append(f"- calls: {len(backs)}; last: {b['rows']} rows x "
                       f"{b['hours']} h, mean CPC {_fmt(b['cpc_mean'])}, "
                       f"mean reduction {_fmt(b['reduction_mean'], 3)}")
        if hourly:
            h = hourly[-1]
            starts = np.asarray(h["starts"], np.float64)
            stops = np.asarray(h["stops"], np.float64)
            on = np.asarray(h["on_mw"], np.float64)
            churn = float(starts.sum() + stops.sum())
            out.append(f"- churn: {_fmt(churn)} transitions "
                       f"({_fmt(float(starts.sum()))} starts, peak hour "
                       f"{int((starts + stops).argmax())})")
            out.append(f"- fleet capacity online: min {_fmt(on.min())} "
                       f"MW, mean {_fmt(on.mean())} MW, max "
                       f"{_fmt(on.max())} MW")

    # workload --------------------------------------------------------
    wl_res = by_kind.get("workload.result", [])
    wl_hourly = by_kind.get("workload.hourly", [])
    if wl_res or wl_hourly:
        _section(out, "Workload")
        if wl_res:
            w = wl_res[-1]
            out.append(f"- coupled backtests: {len(wl_res)}; last: "
                       f"{w['rows']} rows x {w['hours']} h x "
                       f"{w['n_draws']} demand draws")
            out.append(f"- mean per (row, draw): served "
                       f"{_fmt(w['served_mwh'])} MWh, dropped "
                       f"{_fmt(w['dropped_mwh'])} MWh "
                       f"(drop fraction {_fmt(w['drop_frac'], 3)}), "
                       f"deferred {_fmt(w['deferred_mwh_h'])} MWh-h")
            out.append(f"- CPC over draws (row means): p10 "
                       f"{_fmt(w['cpc_p10_mean'])}, p50 "
                       f"{_fmt(w['cpc_p50_mean'])}, p90 "
                       f"{_fmt(w['cpc_p90_mean'])} EUR/MWh")
        if wl_hourly:
            h = wl_hourly[-1]
            dem = np.asarray(h["demand_mwh"], np.float64)
            srv = np.asarray(h["served_mwh"], np.float64)
            drp = np.asarray(h["dropped_mwh"], np.float64)
            bkl = np.asarray(h["backlog_mwh"], np.float64)
            out.append(f"- hourly (fleet means over {dem.shape[0]} h): "
                       f"offered {_fmt(dem.sum())} MWh, served "
                       f"{_fmt(srv.sum())} MWh, dropped "
                       f"{_fmt(drp.sum())} MWh")
            out.append(f"- backlog: peak {_fmt(bkl.max())} MWh (hour "
                       f"{int(bkl.argmax())}), mean {_fmt(bkl.mean())} "
                       "MWh")

    # dispatch --------------------------------------------------------
    recon = reconstruct_dispatch(events)
    disp = by_kind.get("dispatch.result", [])
    if recon or disp:
        _section(out, "Dispatch")
        if disp:
            d = disp[-1]
            out.append(f"- sites: {d.get('n_sites', '-')}; hours: "
                       f"{d.get('hours', '-')}")
            out.append(f"- CPC: {_fmt(d['cpc'])} (energy "
                       f"{_fmt(d['energy_cost'])}, migration "
                       f"{_fmt(d['migration_cost'])})")
            out.append(f"- moves: {d['n_migrations']} hours, "
                       f"{_fmt(d['migration_mw'])} MW total")
            out.append(f"- slack minima: capacity "
                       f"{_fmt(d['slack_capacity_mw'])} MW, power "
                       f"{_fmt(d['slack_power_mw'])} MW, floor "
                       f"{_fmt(d['slack_floor_mwh'])} MWh")
            out.append(f"- near-infeasible hours (< "
                       f"{_fmt(100 * d.get('near_frac', 0.05), 2)}% "
                       f"capacity slack): {d['near_infeasible_hours']}")
        if recon:
            out.append(f"- reconstructed from trace: CPC "
                       f"{_fmt(recon['cpc'])}, {recon['n_migrations']} "
                       "move hours"
                       + (" (matches emitted result exactly)"
                          if disp and recon["cpc"] == disp[-1]["cpc"]
                          and recon["n_migrations"]
                          == disp[-1]["n_migrations"] else ""))
    infeas = by_kind.get("dispatch.infeasible", [])
    if infeas:
        _section(out, "Dispatch infeasibilities")
        for e in infeas:
            out.append(f"- [{e.get('constraint', '?')}] {e['reason']}")

    # degradation (faults, shed, fallbacks, guard) --------------------
    faults = by_kind.get("fault.injected", [])
    sheds = by_kind.get("dispatch.shed", [])
    fallbacks = by_kind.get("live.fallback", [])
    guards = by_kind.get("tune.guard", [])
    if faults or sheds or fallbacks or guards:
        _section(out, "Degradation")
        if faults:
            per_kind: dict = {}
            for e in faults:
                per_kind.setdefault(e["fault"], []).append(e)
            scopes = sorted({e.get("scope", "?") for e in faults})
            out.append(f"- faults injected: {len(faults)} "
                       f"(scope: {', '.join(scopes)})")
            for kind, evs in sorted(per_kind.items()):
                hours = sum(int(e.get("duration", 0)) for e in evs)
                out.append(f"  - {kind}: {len(evs)} events, "
                           f"{hours} fault-hours")
        if sheds:
            s = sheds[-1]
            out.append(f"- load shed: {_fmt(s['shed_mwh'])} MWh over "
                       f"{s['n_shed_hours']} hours at VoLL "
                       f"{_fmt(s['voll_eur_mwh'])} EUR/MWh "
                       f"(cost {_fmt(s['shed_cost'])} EUR)")
        if fallbacks:
            f = fallbacks[-1]
            out.append(f"- forecast fallbacks: fresh {f['fresh']}, "
                       f"stale-shift {f['stale_shift']}, seasonal-naive "
                       f"{f['seasonal_naive']}, persistence "
                       f"{f['persistence']} row-hours")
            out.append(f"- forced-off row-hours: "
                       f"{f['forced_off_row_hours']}; stale-price "
                       f"row-hours: {f['stale_price_row_hours']}")
        if guards:
            g = guards[-1]
            out.append(f"- tuner guard: {g['rejects_total']} non-finite "
                       f"steps rejected across {g['steps_affected']} "
                       f"steps (first at step {g['first_step']}, "
                       f"{g['rows']} rows)")

    # live operation --------------------------------------------------
    live_res = by_kind.get("live.result", [])
    live_steps = by_kind.get("live.step", [])
    if live_res or live_steps:
        _section(out, "Live operation")
        if live_res:
            r = live_res[-1]
            out.append(f"- controllers: {r['rows']} rows x "
                       f"{r['hours']} h")
            out.append(f"- mean realized CPC: {_fmt(r['cpc_mean'])} "
                       f"(regret vs hindsight oracle "
                       f"{_fmt(r['regret_oracle_mean'], 3)}, vs offline "
                       f"{_fmt(r['regret_offline_mean'], 3)})")
            out.append(f"- one-step forecast MAE: {_fmt(r['mae1_mean'])} "
                       f"EUR/MWh; threshold churn: "
                       f"{_fmt(r['churn_total'])} commits")
            best = r.get("best")
            if best:
                out.append(f"- best design: {best['forecaster']} "
                           f"H={best['horizon']} cadence={best['cadence']} "
                           f"{best['family']} (CPC {_fmt(best['cpc'])})")
        if live_steps:
            h = live_steps[-1]
            on = np.asarray(h["on_mw"], np.float64)
            trans = np.asarray(h["transitions"], np.float64)
            err = np.asarray(h["abs_err1"], np.float64)
            out.append(f"- fleet capacity online: min {_fmt(on.min())} "
                       f"MW, mean {_fmt(on.mean())} MW over "
                       f"{on.shape[0]} hours")
            out.append(f"- transitions: {_fmt(float(trans.sum()))} "
                       f"(peak hour {int(trans.argmax())}); mean "
                       f"one-step |err|: {_fmt(float(err.mean()))}")

    # fleet summary / regret ------------------------------------------
    summaries = by_kind.get("fleet.summary", [])
    if summaries:
        s = summaries[-1]
        _section(out, f"Top-{top_k} regret rows")
        out.append(f"- fleet total cost: {_fmt(s['total_cost'])} EUR; "
                   f"up hours: {_fmt(s['total_up_hours'])}")
        rows = s.get("top_regret", [])[:top_k]
        if rows:
            out.append("")
            out.append("| market | system | policy | regret | reduction |")
            out.append("|---|---|---|---|---|")
            for r in rows:
                out.append(f"| {r['market']} | {r['system']} | "
                           f"{r['policy']} | {_fmt(r['regret'], 3)} | "
                           f"{_fmt(r['reduction'], 3)} |")

    # loaders ---------------------------------------------------------
    loads = by_kind.get("loader.skipped_rows", [])
    if loads:
        _section(out, "Data loading")
        for e in loads:
            path = Path(e["path"]).name if redact_meta else e["path"]
            filled = int(e.get("n_filled", 0) or 0)
            tail = f", {filled} gap-filled" if filled else ""
            out.append(f"- [{e['action']}] {e['loader']} {path}: "
                       f"{e['n_parsed']}/{e['n_rows']} rows parsed "
                       f"({e['n_skipped']} skipped, {e['n_nan']} empty"
                       f"{tail})")

    # profiling -------------------------------------------------------
    spans = by_kind.get("profile.span", [])
    xla = by_kind.get("profile.xla", [])
    if spans or xla:
        _section(out, "Profile")
        for e in spans:
            extra = {k: v for k, v in e.items()
                     if k not in ("schema", "kind", "ts", "seq", "label",
                                  "seconds")}
            tail = ("  (" + ", ".join(f"{k}={v}"
                                      for k, v in sorted(extra.items()))
                    + ")") if extra and not redact_meta else ""
            sec = "<redacted>" if redact_meta else _fmt(e["seconds"], 3)
            out.append(f"- span {e['label']}: {sec} s{tail}")
        for e in xla:
            parts = [f"{k}={_fmt(v)}" for k, v in sorted(e.items())
                     if k in ("flops", "bytes_accessed", "temp_bytes",
                              "output_bytes")]
            out.append(f"- xla {e['label']}: " + ", ".join(parts))

    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a telemetry run directory into an operator "
        "digest (markdown).")
    ap.add_argument("run_dir", help="directory containing trace.jsonl")
    ap.add_argument("--top-k", type=int, default=5,
                    help="regret rows to show (default 5)")
    ap.add_argument("-o", "--output", default=None,
                    help="write the digest to this file instead of stdout")
    ap.add_argument("--redact-meta", action="store_true",
                    help="replace volatile stamp fields (ids, versions, "
                    "timings) — for diff-stable output")
    ap.add_argument("--validate", action="store_true",
                    help="also schema-check every trace line and report "
                    "problems")
    args = ap.parse_args(argv)

    digest = render_digest(args.run_dir, top_k=args.top_k,
                           redact_meta=args.redact_meta)
    rc = 0
    if args.validate:
        problems = [f"line {i}: {p}"
                    for i, e in enumerate(load_events(args.run_dir))
                    for p in validate(e)]
        if problems:
            digest += (f"\n## Schema problems (v{SCHEMA_VERSION})\n\n"
                       + "\n".join(f"- {p}" for p in problems) + "\n")
            rc = 1
    if args.output:
        Path(args.output).write_text(digest)
        print(f"wrote {args.output}")
    else:
        print(digest, end="")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
