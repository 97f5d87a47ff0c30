"""Chaos harness: run the fleet through a seeded fault storm and check it
degrades instead of crashing.

A `repro_torch.faults.FaultTrace` — site outages, price-feed gaps,
forecast blackouts, demand surges, all compiled to [S, T] / [N, T] masks
that flow through the engines as tensor arithmetic — is injected into
the three operating layers and each is compared against its fault-free
twin:

  1. the fleet backtest (`repro_torch.faults.faulted_backtest`):
     stale-price decisions, forced outage state, true-price settlement;
  2. cross-site dispatch (`repro_torch.faults.faulted_problem` +
     `repro_torch.dispatch.Relief`): storm-induced infeasible hours shed
     at VoLL instead of raising `DispatchInfeasible`;
  3. the live operator (`repro_torch.live.live_backtest(faults=...)`):
     the forecast fallback ladder (fresh -> age-shifted last-published ->
     seasonal-naive -> persistence) under blackouts, outage-aware state
     carry with restarts billed on recovery.

The run PASSES when every layer returns finite results and the CPC
degradation stays inside a sanity bound (a storm should cost percent,
not orders of magnitude). With ``--trace`` the telemetry digest gains a
Degradation section with per-fault shed/fallback counts.

  PYTHONPATH=src python -m repro_torch.examples.chaos_fleet    # full storm
  PYTHONPATH=src python -m repro_torch.examples.chaos_fleet --smoke \
      --device cpu                                               # tiny run
  PYTHONPATH=src python -m repro_torch.examples.chaos_fleet --smoke \
      --trace out/run
  PYTHONPATH=src python -m repro_torch.examples.chaos_fleet --seed 11
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.tco import make_system
from repro_torch.device import resolve_device
from repro_torch.dispatch import (DispatchConfig, Relief, build_problem,
                                  dispatch)
from repro_torch.energy.markets import MarketParams
from repro_torch.examples import traced
from repro_torch.faults import (FaultTrace, faulted_backtest,
                                faulted_problem, random_storm)
from repro_torch.fleet import PolicySpec, backtest, build_grid, summarize
from repro_torch.live import LiveConfig, build_live_grid, live_backtest

# a storm should cost percent, not orders of magnitude: fail the run if
# mean CPC degrades by more than this factor
MAX_CPC_DEGRADATION = 0.5


def build(args, device):
    hours = 400 if args.smoke else 2190
    n_markets = 2 if args.smoke else 4
    markets = [MarketParams(n_hours=hours, seed=s)
               for s in range(n_markets)]
    systems = [make_system(0.8 * hours * 1.0 * 80.0, 1.0, float(hours),
                           device=device)]
    policies = [PolicySpec("always_on"),
                PolicySpec("x10", x=0.10, off_level=0.3),
                PolicySpec("x25", x=0.25, off_level=0.3)]
    return (build_grid(markets, systems, policies, device=device),
            policies, hours)


def storm_for(args, grid, hours) -> FaultTrace:
    n = 1 if args.smoke else 3
    return random_storm(args.seed, grid.n_rows, grid.n_markets, hours,
                        n_outages=2 * n, n_price_gaps=2 * n,
                        n_blackouts=n, n_surges=n,
                        max_duration=max(24, hours // 12))


def _mean(x) -> float:
    return float(np.mean(x.cpu().numpy()))


def chaos_backtest(grid, storm, device) -> tuple:
    ref = backtest(grid, device=device)
    hit = faulted_backtest(grid, storm, device=device)
    base, got = _mean(ref.cpc), _mean(hit.cpc)
    print(f"backtest   mean CPC {base:9.3f} -> {got:9.3f} "
          f"({got / base - 1.0:+.2%})")
    return base, got


def _site_problem(grid, summary, cfg, device):
    rows = summary.dispatch_rows
    r = grid.market_idx.new_tensor(rows)
    return build_problem(
        grid.prices[grid.market_idx[r]], grid.p_on[r], grid.p_off[r],
        grid.off_level[r], grid.power[r], cfg, fixed=grid.fixed[r],
        device=device)


def chaos_dispatch(grid, args, hours, device) -> tuple:
    cfg = DispatchConfig(demand_frac=0.3, migrate_cost=2.0)
    summary = summarize(grid, backtest(grid, device=device),
                        dispatch_cfg=cfg)
    prob = _site_problem(grid, summary, cfg, device)
    n_sites = np.asarray(prob.avail_mw).shape[0]
    # outage targets index dispatch *sites* here, so the dispatch layer
    # gets its own storm drawn at the site count
    storm = random_storm(args.seed, n_sites, grid.n_markets, hours,
                         max_duration=max(24, hours // 12))
    fp = faulted_problem(
        prob, storm.compile(n_sites, grid.n_markets, hours),
        site_market_idx=grid.market_idx.cpu().numpy()[
            summary.dispatch_rows])
    res = dispatch(fp._replace(relief=Relief(voll_eur_mwh=3000.0)),
                   device=device)
    base = float(summary.dispatch.cpc)
    print(f"dispatch   CPC {base:9.3f} -> {float(res.cpc):9.3f} "
          f"(shed {res.shed_mwh:.2f} MWh over {res.n_shed_hours} h "
          f"at VoLL)")
    return base, float(res.cpc)


def chaos_live(grid, policies, args, hours, device) -> tuple:
    lgrid = build_live_grid(
        grid, policies, forecasters=("seasonal_naive", "persistence"),
        horizons=(24,), cadences=(1,), families=("quantile",))
    # smoke keeps the window short; the full run covers the whole trace
    # tail so every storm event lands inside the live window
    live_h = min(336, hours - 168) if hours <= 400 else hours - 168
    cfg = LiveConfig(start=168, hours=live_h, season=168)
    live_storm = random_storm(args.seed, lgrid.n_rows, grid.n_markets,
                              hours, max_duration=max(24, hours // 12))
    ref = live_backtest(lgrid, cfg, device=device)
    hit = live_backtest(lgrid, cfg, faults=live_storm, device=device)
    base, got = _mean(ref.cpc), _mean(hit.cpc)
    print(f"live       mean CPC {base:9.3f} -> {got:9.3f} "
          f"({got / base - 1.0:+.2%})")
    return base, got


def _main(args) -> int:
    dev = resolve_device(args.device)
    grid, policies, hours = build(args, dev)
    storm = storm_for(args, grid, hours)
    print(f"chaos storm (seed {args.seed}): {len(storm)} faults over "
          f"{grid.n_rows} rows x {grid.n_markets} markets x {hours} h")
    for ev in storm.events:
        print(f"  - {ev.kind:>18} target={ev.target:<3} "
              f"hours {ev.start}..{ev.start + ev.duration} "
              f"magnitude={ev.magnitude:g}")
    print()

    pairs = [chaos_backtest(grid, storm, dev),
             chaos_dispatch(grid, args, hours, dev),
             chaos_live(grid, policies, args, hours, dev)]

    worst = max(got / base - 1.0 for base, got in pairs)
    finite = all(np.isfinite(got) for _, got in pairs)
    ok = finite and worst <= MAX_CPC_DEGRADATION
    print(f"\nworst CPC degradation: {worst:+.2%} "
          f"(bound {MAX_CPC_DEGRADATION:.0%}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny storm, short traces (CI)")
    ap.add_argument("--seed", type=int, default=7,
                    help="storm seed (default 7)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record a repro_torch.obs telemetry run into DIR "
                    "(trace.jsonl + digest.md with a Degradation section) "
                    "— numeric results are bit-identical with or without "
                    "it")
    args = ap.parse_args(argv)
    with traced(args.trace, "chaos_fleet"):
        return _main(args)


if __name__ == "__main__":
    raise SystemExit(main())
