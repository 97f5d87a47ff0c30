"""Run the live fleet operator over a controller-design sweep and score
every design against the hindsight oracle and the offline-tuned policy.

The offline examples (`fleet_backtest`, `tune_policies`) assume the
whole price year is known up front. This demo runs the receding-horizon
controller of `repro_torch.live` instead: every simulated hour each
controller forecasts the next H hours from its trailing window,
re-solves its shutdown threshold on its cadence tick, then realizes
costs at the TRUE price — the whole forecaster x horizon x cadence x
family sweep in one loop over hours on the device. The regret table
answers the paper's open operational question: how much of the
perfect-foresight saving survives when you only know prices a day
ahead?

``--ensemble`` repeats the sweep on block-bootstrap pseudo-years
(`repro_torch.energy.ensemble`) and reports confidence bands on the
regret gap; ``--retune`` demonstrates the host-level re-tune path — the
full annealed tuner re-entered each tick via
``repro_torch.tune.optimize(warm_start=...)``.

  PYTHONPATH=src python -m repro_torch.examples.live_operator   # the card
  PYTHONPATH=src python -m repro_torch.examples.live_operator \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.examples.live_operator \\
      --smoke --trace out/run
  PYTHONPATH=src python -m repro_torch.examples.live_operator --ensemble
  PYTHONPATH=src python -m repro_torch.examples.live_operator --retune

The exit code is the guarantee: 0 when the hindsight oracle lower-bounds
every live controller (``--retune``: when the warm-started re-tune is
never clearly worse than a cold restart).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from repro_torch.core.tco import make_system
from repro_torch.device import resolve_device
from repro_torch.energy.ensemble import block_bootstrap
from repro_torch.energy.presets import region_params
from repro_torch.examples import traced
from repro_torch.fleet import PolicySpec, build_grid
from repro_torch.live import (LiveConfig, build_live_grid, live_backtest,
                              summarize_live)
from repro_torch.obs.profiling import profiled
from repro_torch.tune import TuneConfig, optimize

POLICIES = (PolicySpec("always_on"), PolicySpec("x8", x=0.08),
            PolicySpec("x15", x=0.15))


def build(args, device=None):
    """The sweep: 4 German market draws x 1 system (Psi 2) x `POLICIES`
    over 2190 h, crossed with every forecaster, horizons {24, 168},
    cadences {1, 24} and both families (384 controllers over the whole
    2190 h); ``--smoke``: 2 draws over 400 h, seasonal-naive and perfect
    forecasts, horizon 24, cadence 1, both families (24 controllers over
    336 h)."""
    hours = 400 if args.smoke else 2190
    n_markets = 2 if args.smoke else 4
    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(n_markets)]
    p_avg = markets[0].p_avg
    systems = [make_system(2.0 * hours * 1.0 * p_avg, 1.0, float(hours),
                           device=device)]
    policies = list(POLICIES)
    grid = build_grid(markets, systems, policies, device=device)
    if args.smoke:
        lgrid = build_live_grid(
            grid, policies, forecasters=("seasonal_naive", "perfect"),
            horizons=(24,), cadences=(1,), families=("quantile", "tuned"))
        cfg = LiveConfig(start=0, hours=336, season=168)
    else:
        lgrid = build_live_grid(
            grid, policies,
            horizons=(24, 168), cadences=(1, 24),
            families=("quantile", "tuned"))
        cfg = LiveConfig(start=0, hours=hours, season=168)
    return grid, lgrid, cfg, policies


def run_sweep(lgrid, cfg, device=None):
    with profiled("live.backtest", rows=lgrid.n_rows, hours=cfg.hours):
        res = live_backtest(lgrid, cfg, device=device)
    return summarize_live(lgrid, res, cfg)


def ensemble_demo(args, grid, lgrid, cfg, policies, device) -> dict:
    """Re-run the sweep on block-bootstrap pseudo-years: does the
    forecaster ranking (and the live-vs-oracle gap) survive on price
    paths the controllers never saw?"""
    n_res = 2 if args.smoke else 5
    prices = grid.prices.cpu().numpy()
    fixed = float(grid.fixed[0])
    period = float(grid.period[0])
    reg_o, reg_f = [], []
    for r in range(n_res):
        resampled = np.stack([
            block_bootstrap(prices[n], 1, block_hours=7 * 24,
                            seed=1000 * r + n)[0]
            for n in range(prices.shape[0])])
        grid_r = build_grid(resampled, [make_system(
            fixed, 1.0, period, device=device)], policies, device=device)
        lgrid_r = build_live_grid(
            grid_r, policies, forecasters=lgrid.forecaster_names,
            horizons=lgrid.horizons, cadences=lgrid.cadences,
            families=lgrid.family_names)
        s = run_sweep(lgrid_r, cfg, device)
        reg_o.append(s.regret_oracle)
        reg_f.append(s.regret_offline)
    reg_o, reg_f = np.stack(reg_o), np.stack(reg_f)   # [R, B]
    mo, so = reg_o.mean(axis=0), reg_o.std(axis=0)
    print(f"\nensemble ({n_res} pseudo-years/market, weekly blocks):")
    print(f"  regret vs oracle:  mean {mo.mean():.2%}  "
          f"band +/- {so.mean():.2%} (per-row std across resamples)")
    print(f"  regret vs offline: mean {reg_f.mean():.2%}  "
          f"band +/- {reg_f.std(axis=0).mean():.2%}")
    return {"resamples": n_res,
            "regret_oracle_mean": float(mo.mean()),
            "regret_oracle_band": float(so.mean()),
            "regret_offline_mean": float(reg_f.mean()),
            "regret_offline_band": float(reg_f.std(axis=0).mean())}


def retune_demo(args, device) -> int:
    """Host-level receding-horizon re-tuning: re-enter the full annealed
    tuner each tick from the previous tick's solution
    (`optimize(warm_start=...)`) and compare against cold restarts with
    the same step budget — the warm path should never be worse."""
    wlen = 336 if args.smoke else 730
    ticks = 3 if args.smoke else 4
    hours = wlen * ticks
    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(2)]
    p_avg = markets[0].p_avg
    policies = [PolicySpec("x8", x=0.08)]
    full = build_grid(markets, [make_system(
        2.0 * hours * 1.0 * p_avg, 1.0, float(hours), device=device)],
        policies, device=device)
    prices = full.prices
    warm_steps = 20 if args.smoke else 60
    cold_steps = warm_steps

    prev = None
    print(f"{'tick':>4} {'window':>14} {'cpc cold':>9} {'cpc warm':>9} "
          f"{'warm gain':>10}")
    gains = []
    for k in range(ticks):
        sl = prices[:, k * wlen:(k + 1) * wlen]
        grid_w = build_grid(sl, [make_system(
            2.0 * wlen * 1.0 * p_avg, 1.0, float(wlen), device=device)],
            policies, device=device)
        cold = optimize(grid_w, TuneConfig(steps=cold_steps), device=device)
        warm = cold if prev is None else optimize(
            grid_w, TuneConfig(steps=warm_steps), warm_start=prev,
            device=device)
        gain = 1.0 - warm.cpc.mean() / cold.cpc.mean()
        gains.append(gain)
        print(f"{k:>4} {k * wlen:>6}..{(k + 1) * wlen:<6} "
              f"{cold.cpc.mean():>9.3f} {warm.cpc.mean():>9.3f} "
              f"{gain:>10.3%}")
        prev = warm
    ok = all(g >= -1e-2 for g in gains)   # warm never clearly worse
    print(f"\nwarm-started re-tune {'OK' if ok else 'REGRESSED'} over "
          f"{ticks} ticks of {wlen} h")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep, short window (CI)")
    ap.add_argument("--ensemble", action="store_true",
                    help="repeat the sweep on block-bootstrap "
                    "pseudo-years and report regret confidence bands")
    ap.add_argument("--retune", action="store_true",
                    help="host-level receding-horizon demo: "
                    "optimize(warm_start=...) per tick vs cold restarts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", metavar="FILE", default=None,
                    help="write the sweep's summary as JSON to FILE")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record a repro_torch.obs telemetry run into DIR "
                    "(trace.jsonl + metrics.json + digest.md) — numeric "
                    "results are bit-identical with or without it")
    args = ap.parse_args(argv)
    with traced(args.trace, "live_operator"):
        return _main(args)


def _main(args) -> int:
    dev = resolve_device(args.device)
    if args.retune:
        return retune_demo(args, dev)

    grid, lgrid, cfg, policies = build(args, dev)
    print(f"live sweep: {lgrid.n_rows} controllers "
          f"({grid.n_markets} markets x {grid.n_policies} policies x "
          f"{len(lgrid.forecaster_names)} forecasters x "
          f"{len(lgrid.horizons)} horizons x {len(lgrid.cadences)} "
          f"cadences x {len(lgrid.family_names)} families) "
          f"over {cfg.hours} h")
    summary = run_sweep(lgrid, cfg, dev)
    print()
    print(summary.render_table())

    sandwich = bool(np.all(
        summary.cpc_oracle <= summary.cpc_live * (1 + 1e-5) + 1e-6))
    best = summary.table[0]
    print(f"\nbest design: {best['forecaster']} H={best['horizon']} "
          f"cadence={best['cadence']} {best['family']} — regret "
          f"{best['regret_oracle']:.2%} vs oracle, "
          f"{best['regret_offline']:+.2%} vs offline-tuned")
    print(f"hindsight-oracle lower bound holds on all rows: {sandwich}")

    out = {
        "rows": lgrid.n_rows, "hours": cfg.hours,
        "cpc_live_mean": float(summary.cpc_live.mean()),
        "regret_oracle_mean": float(summary.regret_oracle.mean()),
        "regret_offline_mean": float(summary.regret_offline.mean()),
        "best": best, "sandwich_holds": sandwich,
        "table": list(summary.table),
    }
    if args.ensemble:
        out["ensemble"] = ensemble_demo(args, grid, lgrid, cfg, policies,
                                        dev)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
        print(f"summary -> {args.out}")
    if not sandwich:
        print("ERROR: a live controller beat the hindsight oracle — "
              "bound violated")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
