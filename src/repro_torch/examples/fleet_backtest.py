"""Fleet backtest: a Monte-Carlo market ensemble x systems x policies in
one pass.

8 seeds of the calibrated German market (a Monte-Carlo ensemble giving
confidence bands on the Eq. 19 viability question), 3 systems spanning
the paper's Psi range, and 6 operational policies — thresholds from the
PV set, hysteresis, partial shutdown (paper §V-C).

  PYTHONPATH=src python -m repro_torch.examples.fleet_backtest [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.tco import make_system
from repro_torch.device import resolve_device
from repro_torch.energy.presets import region_params
from repro_torch.fleet import (PolicySpec, backtest, build_grid,
                               elastic_policy, summarize)

POLICIES = (
    PolicySpec("always_on"),
    PolicySpec("x1", x=0.01),
    PolicySpec("x3", x=0.03),
    PolicySpec("x3_hyst", x=0.03, hysteresis=0.9,
               restart_energy_mwh=0.3, restart_time_h=0.25),
    PolicySpec("x8_idle", x=0.08, idle_frac=0.05),
    elastic_policy("x8_half_dp", level=0.5, dp_total=16, x=0.08),
)


def run(device=None, hours: int = 8760, n_seeds: int = 8):
    dev = resolve_device(device)
    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(n_seeds)]
    p_avg = markets[0].p_avg           # generator rescales to this exactly
    systems = [                        # Psi ~ F / (T C p_avg):  0.8 / 2 / 4
        make_system(psi * hours * 1.0 * p_avg, 1.0, float(hours),
                    device=dev)
        for psi in (0.8, 2.0, 4.0)]
    grid = build_grid(markets, systems, list(POLICIES),
                      market_names=[f"de-seed{s}" for s in range(n_seeds)],
                      system_names=["psi0.8", "psi2.0", "psi4.0"],
                      device=dev)
    report = backtest(grid, device=dev)
    return grid, report, summarize(grid, report)


def print_tables(grid, summ) -> None:
    print(f"grid: {grid.n_markets} markets x {grid.n_systems} systems x "
          f"{grid.n_policies} policies = {grid.n_rows} rows x "
          f"{grid.n_hours} h")
    print(f"\n{'system':8s} {'best policy (mode)':20s} "
          f"{'CPC red %  mean [min, max]':28s} {'oracle %':>9s} "
          f"{'regret pp':>10s}")
    for m, sname in enumerate(grid.system_names):
        best_k = np.bincount(summ.best_policy[:, m],
                             minlength=grid.n_policies).argmax()
        red = summ.reduction[:, m, best_k] * 100
        oracle = summ.oracle_reduction[:, m].mean() * 100
        regret = summ.regret[:, m, best_k].mean() * 100
        print(f"{sname:8s} {grid.policy_names[best_k]:20s} "
              f"{red.mean():6.2f} [{red.min():5.2f}, {red.max():5.2f}]"
              f"{'':>7s}{oracle:9.2f} {regret:10.2f}")

    # Monte-Carlo confidence on viability: share of market draws where
    # the best non-AO policy beats always-on, per system
    print("\nviability across the ensemble (share of market draws with "
          "positive reduction):")
    for m, sname in enumerate(grid.system_names):
        frac = float((summ.best_reduction[:, m] > 1e-4).mean())
        print(f"  {sname:8s} {frac:6.1%}")

    print("\ncross-site dispatch totals per policy (all markets/systems):")
    for k, pname in enumerate(grid.policy_names):
        print(f"  {pname:12s} energy cost {summ.energy_by_policy[k]:14.0f}"
              f"  compute {summ.up_hours_by_policy[k]:12.0f} h")
    print(f"\nfleet TCO {summ.total_cost:.3e}, "
          f"compute {summ.total_up_hours:.3e} h")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    grid, _, summ = run(ap.parse_args().device)
    print_tables(grid, summ)


if __name__ == "__main__":
    main()
