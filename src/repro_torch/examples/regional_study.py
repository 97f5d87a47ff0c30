"""Regional comparison (paper Section IV-E / Table II / Fig. 7):
where in the world does variable capacity pay?

Runs the model over all ten calibrated regional markets, prints the table
ours-vs-paper, then goes beyond the paper: per-partition plans for a
heterogeneous cluster (§V-C) and the capacity schedule they induce. The
reference's example (`examples/regional_study.py`) on the port.

  PYTHONPATH=src python -m repro_torch.examples.regional_study \
      [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np

from repro_torch.core.regions import PAPER_TABLE2, compute_region_row
from repro_torch.device import resolve_device
from repro_torch.energy.markets import (MarketDraws, MarketParams,
                                        generate_market)
from repro_torch.energy.presets import region_params
from repro_torch.runtime.elastic import capacity_schedule
from repro_torch.runtime.scheduler import Partition, partition_plans

DrawsFn = Optional[Callable[[MarketParams], MarketDraws]]

PARTITIONS = [
    Partition("gpu-2019", power_mw=1.2, fixed_cost_per_hour=60.0),
    Partition("gpu-2023", power_mw=0.8, fixed_cost_per_hour=140.0),
    Partition("cpu-only", power_mw=0.4, fixed_cost_per_hour=30.0),
]


def _prices(region: str, dev, draws: DrawsFn) -> np.ndarray:
    mp = region_params(region)
    md = generate_market(mp, draws=draws(mp) if draws else None, device=dev)
    return md.prices.cpu().numpy()


def study(device=None, draws: DrawsFn = None) -> dict:
    """The Table II rows of the ten regions, the German market's
    partition plans and the capacity schedule they induce. ``draws`` maps
    a market's parameters to its random draws (default: the port's own,
    from the market's seed)."""
    dev = resolve_device(device)
    rows = [(compute_region_row(region, _prices(region, dev, draws),
                                psi=paper.psi, device=dev), paper)
            for region, paper in PAPER_TABLE2.items()]
    prices = _prices("germany", dev, draws)
    plans = partition_plans(PARTITIONS, prices, device=dev)
    cap = capacity_schedule(prices, plans,
                            {p.name: p.power_mw for p in PARTITIONS})
    return {"rows": rows, "plans": plans, "capacity": cap}


def report(out: dict) -> None:
    """The reference's tables."""
    print(f"{'region':16s} {'p_avg':>7s} {'Psi':>5s} "
          f"{'x_BE% (paper)':>14s} {'x_opt% (paper)':>15s} "
          f"{'CPCred% (paper)':>16s}")

    def fmt(v, pv, w=5):
        a = f"{v:.2f}" if v is not None else "-"
        b = f"{pv:.2f}" if pv is not None else "-"
        return f"{a:>{w}s} ({b:>5s})"

    for row, paper in out["rows"]:
        print(f"{row.region:16s} {row.p_avg:7.2f} {row.psi:5.2f} "
              f"{fmt(row.x_be_pct, paper.x_be_pct):>14s} "
              f"{fmt(row.x_opt_pct, paper.x_opt_pct):>15s} "
              f"{fmt(row.cpc_red_pct, paper.cpc_red_pct):>16s}")

    print("\nheterogeneous cluster, Germany market (paper §V-C):")
    for name, plan in out["plans"].items():
        print(f"  {name:10s} Psi={plan['psi']:.2f} "
              f"viable={plan['viable']} x_opt={plan['x_opt']:.2%} "
              f"CPC red={plan['cpc_reduction']:.2%}")
    cap = out["capacity"]
    frac_full = float((cap >= 0.999).mean())
    frac_partial = float(((cap > 0.0) & (cap < 0.999)).mean())
    print(f"  capacity schedule: full {frac_full:.1%} of hours, "
          f"partial {frac_partial:.1%}, mean capacity {cap.mean():.1%}")


def main(argv=None, draws: DrawsFn = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    report(study(ap.parse_args(argv).device, draws))


if __name__ == "__main__":
    main()
