"""Workload-coupled demand: serve a stochastic request trace through the
fleet and price shutdowns by what they do to users.

A `repro_torch.workload.Workload` turns the exogenous-demand backtest into
a closed loop: a seeded doubly-stochastic Poisson arrival process
(diurnal base rate x bursty Gamma overdispersion) is converted to MW
through per-model serving throughput, and every scenario row serves all
demand draws hour by hour with its *realised* capacity. Unserved work
defers into a bounded, deadline-aged queue (priced at the SLO penalty per
MWh-hour) or drops (priced at the `repro_torch.dispatch.Relief` VoLL
rate), so the CPC of a shutdown policy becomes a *distribution* over
demand draws instead of a point value.

The run walks the full loop:

  1. coupled backtest (`repro_torch.workload.workload_backtest`, the
     ledger kernel on the card): CPC p10/p50/p90 over the draws per
     policy, served/deferred/dropped;
  2. SLO-aware tuning (`repro_torch.tune.optimize` with
     ``TuneConfig(workload=...)``, the soft ledger's kernel pair every
     step): thresholds learned under the soft work-ledger term, selected
     by realized workload cost — never worse than the best swept policy
     under the same workload;
  3. live operation (`repro_torch.live.live_fleet_dispatch(workload=...)`)
     with a demand-surge fault hitting the arrival process itself.

  PYTHONPATH=src python -m repro_torch.examples.workload_fleet  # full run
  PYTHONPATH=src python -m repro_torch.examples.workload_fleet --smoke \
      --device cpu                                                # tiny run
  PYTHONPATH=src python -m repro_torch.examples.workload_fleet --smoke \
      --trace out/run
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.tco import make_system
from repro_torch.device import resolve_device
from repro_torch.energy.markets import MarketParams
from repro_torch.examples import traced
from repro_torch.faults import FaultEvent, FaultTrace
from repro_torch.fleet import PolicySpec, build_grid, summarize
from repro_torch.live import live_fleet_dispatch
from repro_torch.tune import TuneConfig, optimize
from repro_torch.workload import Workload, workload_backtest


def build(args, device):
    hours = 400 if args.smoke else 2190
    n_markets = 2 if args.smoke else 4
    markets = [MarketParams(n_hours=hours, seed=s)
               for s in range(n_markets)]
    systems = [make_system(0.8 * hours * 1.0 * 80.0, 1.0, float(hours),
                           device=device)]
    policies = [PolicySpec("always_on"),
                PolicySpec("x10", x=0.10, off_level=0.3),
                PolicySpec("x25", x=0.25, off_level=0.3),
                PolicySpec("x40", x=0.40, off_level=0.3)]
    workload = Workload(n_draws=8 if args.smoke else 32, seed=args.seed)
    grid = build_grid(markets, systems, policies, workload=workload,
                      device=device)
    return grid, policies, workload, hours


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def coupled_backtest(grid, device):
    run = workload_backtest(grid, device=device)
    res = run.workload
    names = grid.policy_names
    print(f"coupled backtest: {grid.n_rows} rows x {grid.n_hours} h x "
          f"{res.n_draws} demand draws")
    print(f"{'policy':>10} {'cpc p10':>9} {'cpc p50':>9} {'cpc p90':>9} "
          f"{'served':>8} {'dropped':>8}")
    pol = _np(grid.policy_idx)
    for p in range(len(names)):
        rows = pol == p
        print(f"{names[p]:>10} "
              f"{np.mean(_np(res.cpc_p10)[rows]):9.2f} "
              f"{np.mean(_np(res.cpc_p50)[rows]):9.2f} "
              f"{np.mean(_np(res.cpc_p90)[rows]):9.2f} "
              f"{np.mean(_np(res.served_mwh)[rows]):8.1f} "
              f"{np.mean(_np(res.dropped_mwh)[rows]):8.2f}")
    # the summary view carries the same result
    summary = summarize(grid, run.report)
    if summary.workload is None:
        raise AssertionError("summarize() lost the grid's workload")
    return res


def slo_tuning(grid, workload, args, device):
    steps = 40 if args.smoke else 200
    res = optimize(grid, TuneConfig(steps=steps, workload=workload),
                   device=device)
    ok = bool(np.all(np.isfinite(res.workload_cost)))
    print(f"\nSLO-aware tuning ({steps} steps): mean realized workload "
          f"cost {np.mean(res.workload_cost):.0f} EUR "
          f"(sources tuned={int(np.sum(res.source == 0))} "
          f"own={int(np.sum(res.source == 1))} "
          f"cell-best={int(np.sum(res.source == 2))})")
    return res, ok


def live_surge(grid, workload, hours, args, device):
    start = hours // 2
    live_h = min(96, hours - start)
    surge = FaultTrace(events=(
        FaultEvent("demand_surge", 0, start + live_h // 4,
                   max(6, live_h // 8), 3.0),), seed=args.seed)
    sites = min(3, grid.n_markets)
    prices = grid.prices[:sites]
    kw = dict(start=start, hours=live_h, workload=workload, device=device)
    base = live_fleet_dispatch(prices, 1.0, 30.0, 60.0, 0.0, 0.0,
                               np.full(sites, 0.25), **kw)
    hit = live_fleet_dispatch(prices, 1.0, 30.0, 60.0, 0.0, 0.0,
                              np.full(sites, 0.25), faults=surge, **kw)
    print(f"\nlive ({sites} sites, {live_h} h): CPC p50 "
          f"{base.workload['cpc_p50']:.2f} -> {hit.workload['cpc_p50']:.2f} "
          "under a 3x demand surge "
          f"(dropped {np.mean(base.workload['dropped_mwh']):.2f} -> "
          f"{np.mean(hit.workload['dropped_mwh']):.2f} MWh)")
    return base, hit


def _main(args) -> int:
    dev = resolve_device(args.device)
    grid, policies, workload, hours = build(args, dev)
    print(f"workload: base {workload.base_rps:g} req/s, "
          f"{workload.tokens_per_request:g} tok/req -> "
          f"{workload.mw_per_request_hour * workload.base_rps * 3600.0:.3f}"
          f" MW mean demand at base rate; deadline {workload.deadline_h} h,"
          f" queue bound {workload.queue_bound_mwh:g} MWh\n")

    res = coupled_backtest(grid, dev)
    tuned, tune_ok = slo_tuning(grid, workload, args, dev)
    base, hit = live_surge(grid, workload, hours, args, dev)

    finite = (bool(np.all(np.isfinite(_np(res.cpc_p50))))
              and tune_ok
              and np.isfinite(hit.workload["cpc_p50"]))
    surged = (np.mean(hit.workload["dropped_mwh"])
              >= np.mean(base.workload["dropped_mwh"]))
    ok = finite and surged
    print(f"\n{'PASS' if ok else 'FAIL'} (finite={finite}, "
          f"surge increased drops={surged})")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny trace, few draws (CI)")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload / surge seed (default 0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record a repro_torch.obs telemetry run into DIR "
                    "(trace.jsonl + digest.md with a Workload section) — "
                    "numeric results are bit-identical with or without it")
    args = ap.parse_args(argv)
    with traced(args.trace, "workload_fleet"):
        return _main(args)


if __name__ == "__main__":
    raise SystemExit(main())
