"""Quickstart: the paper's model end-to-end.

Reproduces the Lichtenberg case study (Section IV-A) on the calibrated
synthetic German market, then asks the question the paper's model
answers: should this cluster shut down during price spikes, and for how
long?

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core.optimizer import optimal_shutdown
from repro_torch.core.price_model import price_variability, resample
from repro_torch.core.regions import PAPER_LICHTENBERG, PSI_LICHTENBERG
from repro_torch.core.tco import shutdowns_viable
from repro_torch.device import resolve_device
from repro_torch.energy.markets import generate_market
from repro_torch.energy.presets import region_params


def lichtenberg(device=None) -> dict:
    """The case study's numbers on one year of calibrated German prices."""
    dev = resolve_device(device)
    prices = generate_market(region_params("germany"), device=dev).prices
    psi = PSI_LICHTENBERG
    k_small_x = float(price_variability(prices, device=dev).k[10])
    plan = optimal_shutdown(prices, psi, device=dev)
    weekly = optimal_shutdown(resample(prices, 24 * 7, device=dev), psi,
                              device=dev)
    return {
        "p_avg": float(prices.mean()), "p_min": float(prices.min()),
        "p_max": float(prices.max()), "psi": psi, "k_small_x": k_small_x,
        "viable": bool(shutdowns_viable(psi, k_small_x)),
        "x_be": float(plan.x_break_even), "x_opt": float(plan.x_opt),
        "p_thresh": float(plan.p_thresh),
        "cpc_reduction": float(plan.cpc_reduction),
        "weekly_viable": bool(weekly.viable),
    }


def report(r: dict) -> None:
    print(f"p_avg = {r['p_avg']:.2f} EUR/MWh "
          f"(paper: 77.84), min {r['p_min']:.0f}, max {r['p_max']:.0f}")
    print(f"k at small x: {r['k_small_x']:.2f}; viable iff k > Psi+1 = "
          f"{r['psi'] + 1}: {r['viable']}")
    print(f"break-even x  : {r['x_be']:7.2%} "
          f"(paper {PAPER_LICHTENBERG['x_be_pct']}%)")
    print(f"optimal x     : {r['x_opt']:7.2%} "
          f"(paper {PAPER_LICHTENBERG['x_opt_pct']}%)")
    print(f"threshold     : {r['p_thresh']:7.2f} EUR/MWh "
          f"(paper {PAPER_LICHTENBERG['p_thresh']})")
    print(f"CPC reduction : {r['cpc_reduction']:7.2%} "
          f"(paper {PAPER_LICHTENBERG['cpc_red_pct']}%)")
    print(f"weekly-scale shutdowns viable: {r['weekly_viable']} "
          "(paper: never)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    report(lichtenberg(ap.parse_args().device))


if __name__ == "__main__":
    main()
