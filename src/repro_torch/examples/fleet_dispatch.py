"""Feasible cross-site dispatch over a multi-market fleet.

`fleet_backtest` answers "what does each site's policy cost in
isolation?"; this example answers the operator's next question: with
sites in several markets, where should the fleet's load actually run each
hour? The dispatcher (`repro_torch.dispatch`) allocates a fleet-wide
compute demand across the best-policy site schedules under hard
constraints — per-site capacity, a total power cap, an aggregate compute
floor — charging every cross-site move a migration fee and locking newly
placed load for a minimum dwell.

The sweep shows the thrash/price trade-off: free migration chases the
hourly cheapest price (constant movement), while fees and dwell locks cut
the move count for a small energy premium. The last section swaps the
constant demand for a diurnal [T] profile (`diurnal_demand`), which the
dispatcher follows hour by hour (ramps are demand changes, not billed
migrations).

  PYTHONPATH=src python -m repro_torch.examples.fleet_dispatch [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.tco import make_system
from repro_torch.device import resolve_device
from repro_torch.dispatch import DispatchConfig, diurnal_demand
from repro_torch.energy.presets import region_params
from repro_torch.fleet import (PolicySpec, backtest, build_grid,
                               elastic_policy, summarize)

SWEEP = ((0.0, 0), (2.0, 0), (5.0, 4), (20.0, 24))   # (fee, dwell) rows
DEMAND_FRAC = 0.35
POLICIES = (       # candidate policies per site; 1 MW sites at 1, 0.5, 0.25
    PolicySpec("always_on"),
    PolicySpec("x5_part", x=0.05, off_level=0.25),
    PolicySpec("x10_part", x=0.10, off_level=0.25, hysteresis=0.9),
    elastic_policy("x10_half_dp", level=0.5, dp_total=16, x=0.10),
)


def fleet(device=None, hours: int = 8760):
    """The example's fleet: 8 German market draws, one Psi = 2 system of
    1 MW, the four `POLICIES`. Returns ``(grid, report)`` on ``device``."""
    dev = resolve_device(device)
    n_markets = 8
    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(n_markets)]
    p_avg = markets[0].p_avg           # generator rescales to this exactly
    systems = [make_system(2.0 * hours * 1.0 * p_avg, 1.0, float(hours),
                           device=dev)]
    grid = build_grid(markets, systems, list(POLICIES),
                      market_names=[f"de-seed{s}" for s in range(n_markets)],
                      system_names=["psi2.0"], device=dev)
    return grid, backtest(grid, device=dev)


def run(device=None, hours: int = 8760) -> None:
    grid, report = fleet(device, hours)
    print(f"fleet: {grid.n_markets} sites x {grid.n_policies} candidate "
          f"policies x {grid.n_hours} h")

    print(f"\n{'migrate fee':>12s} {'dwell':>6s} {'fleet CPC':>10s} "
          f"{'energy':>12s} {'migration':>10s} {'moves':>6s} "
          f"{'cap slack MW':>13s}")
    for fee, dwell in SWEEP:
        cfg = DispatchConfig(demand_frac=DEMAND_FRAC, migrate_cost=fee,
                             min_dwell_h=dwell)
        d = summarize(grid, report, dispatch_cfg=cfg).dispatch
        print(f"{fee:12.1f} {dwell:6d} {d.cpc:10.2f} "
              f"{d.energy_cost:12.0f} {d.migration_cost:10.0f} "
              f"{d.n_migrations:6d} {d.slack_capacity_mw:13.2f}")

    # where did the compute actually run?
    cfg = DispatchConfig(demand_frac=DEMAND_FRAC, migrate_cost=5.0,
                         min_dwell_h=4)
    summ = summarize(grid, report, dispatch_cfg=cfg)
    d = summ.dispatch
    share = d.site_mwh / d.delivered_mwh
    best = [grid.policy_names[k] for k in summ.best_policy[:, 0]]
    print(f"\nsite shares of {d.delivered_mwh:.0f} MWh delivered "
          f"(fee 5, dwell 4):")
    for name, pol, s in zip(grid.market_names, best, share):
        print(f"  {name:10s} ({pol:12s}) {s:6.1%}")
    print(f"\nfloor slack {d.slack_floor_mwh:.0f} MWh, "
          f"power slack {d.slack_power_mw:.1f} MW")

    # diurnal demand profile: same fleet, load that breathes with the day
    # (base 0.35 and swing 0.15 of the fleet's rating, peak at 18:00)
    n_mw = float(grid.power.cpu().numpy()[::grid.n_policies].sum())
    prof = diurnal_demand(grid.n_hours, base_mw=DEMAND_FRAC * n_mw,
                          swing_mw=0.15 * n_mw, peak_hour=18.0)
    cfg_d = DispatchConfig(demand_mw=prof, migrate_cost=5.0, min_dwell_h=4)
    dd = summarize(grid, report, dispatch_cfg=cfg_d).dispatch
    profile = np.asarray(prof)
    print(f"\ndiurnal demand {profile.min():.1f}-{profile.max():.1f} MW "
          f"(peak 18:00): fleet CPC {dd.cpc:.2f} "
          f"(constant-demand CPC {d.cpc:.2f}), {dd.n_migrations} moves, "
          f"cap slack {dd.slack_capacity_mw:.2f} MW")
    night = profile.argmin() % 24
    print(f"delivered follows the profile exactly: hour-{night:02d} "
          f"trough {dd.alloc_mw.sum(axis=0)[profile.argmin()]:.2f} MW vs "
          f"peak {dd.alloc_mw.sum(axis=0)[profile.argmax()]:.2f} MW")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record a telemetry run into DIR (comes with the "
                    "telemetry slice)")
    args = ap.parse_args(argv)
    if args.trace:
        raise NotImplementedError(
            "--trace: telemetry comes to the port with the telemetry slice "
            "(ROADMAP queue 1)")
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
