"""Fit market-generator presets to the paper's Table II statistics.

Usage:  PYTHONPATH=src python -m repro_torch.core.fit_presets [--regions a,b,...]

For each region the fit targets are the two k-x points pinned down by
Table II (see `repro_torch.core.calibration`): k(x_BE) = Psi+1 and
k(x_opt) = k_opt(Psi, x_opt, red). Germany additionally targets the
Section IV-A threshold ratio p_thresh/p_avg = 237.84/77.84 at x_opt
(matched implicitly through the tail shape). Results are written to the
port's own `repro_torch/configs/market_presets.json` (``OUT``) and the
residuals reported. The command line is the reference's
(`repro.core.fit_presets`); the markets are generated on the card
(`main`'s and `fit_region`'s ``device``, default cuda).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from repro_torch.core.calibration import (KTargets, calibrate_market,
                                          interp_k, k_opt_from_table)
from repro_torch.core.optimizer import optimal_shutdown
from repro_torch.core.regions import PAPER_TABLE2
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.energy.markets import MarketParams, generate_market

OUT = Path(__file__).resolve().parent.parent / "configs" / \
    "market_presets.json"

# Starting points: spikier markets get spikier inits.
_SPIKY = dict(spike_enter=0.02, spike_stay=0.5, spike_mu=2.2,
              spike_sigma=1.2)
_CALM = dict(spike_enter=0.002, spike_stay=0.4, spike_mu=0.3,
             spike_sigma=0.5, price_sens=0.8)
_INIT_STYLE = {
    "south_australia": _SPIKY,
    "finland": _SPIKY,
    "estonia": _SPIKY,
    "germany": dict(spike_enter=0.006, spike_stay=0.5, spike_mu=1.0,
                    spike_sigma=0.8),
    "south_sweden": dict(spike_enter=0.006, spike_stay=0.5, spike_mu=1.2,
                         spike_sigma=0.9),
    "poland": _CALM,
    "netherlands": dict(spike_enter=0.004, spike_stay=0.5, spike_mu=0.8,
                        spike_sigma=0.7),
    "great_britain": _CALM,
    "france": _CALM,
    "spain": dict(spike_enter=0.0005, spike_stay=0.3, spike_mu=-0.5,
                  spike_sigma=0.3, price_sens=0.5, wind_sigma=0.02),
}


def targets_for(region: str) -> KTargets:
    row = PAPER_TABLE2[region]
    if row.x_be_pct is None:      # Spain: not viable at Psi+1 = 3.47; keep
        # the whole curve below even at the single-highest sample.
        return KTargets(xs=(0.000115, 0.001, 0.01), ks=(3.0, 2.4, 1.9))
    x_be = row.x_be_pct / 100.0
    x_opt = row.x_opt_pct / 100.0
    red = row.cpc_red_pct / 100.0
    k_be = row.psi + 1.0
    k_opt = k_opt_from_table(row.psi, x_opt, red)
    if region == "germany":
        # Fig. 2 pins the extreme tail too: max 2024 price ~ 900 EUR/MWh
        # => k(1/8760) ~ 900/77.84 ~ 11.6.
        return KTargets(xs=(1.0 / 8760, x_opt, x_be),
                        ks=(11.6, k_opt, k_be), weights=(0.5, 2.0, 2.0))
    return KTargets(xs=(x_opt, x_be), ks=(k_opt, k_be),
                    weights=(2.0, 1.0))


def fit_region(region: str, max_iter: int, *,
               device: DeviceLike = None) -> tuple[dict, dict]:
    dev = resolve_device(device)
    row = PAPER_TABLE2[region]
    # seed is part of the preset: calibrate on (and average over) the seeds
    # the preset will actually use, so the fit cannot overfit one draw.
    s0 = sum(ord(c) for c in region) * 7919 % (2 ** 16)
    base = MarketParams(p_avg=row.p_avg, seed=s0,
                        **_INIT_STYLE.get(region, {}))
    tgt = targets_for(region)
    t0 = time.time()
    fitted, loss = calibrate_market(base, tgt, max_iter=max_iter,
                                    seeds=(s0, s0 + 1, s0 + 2), device=dev)
    prices = generate_market(fitted, device=dev).prices
    k_hat = interp_k(prices, tgt.xs)
    plan = optimal_shutdown(prices, row.psi, device=dev)
    report = {
        "region": region,
        "loss": loss,
        "seconds": round(time.time() - t0, 1),
        "k_targets": list(tgt.ks),
        "k_fitted": [float(v) for v in k_hat],
        "paper": {"x_be_pct": row.x_be_pct, "x_opt_pct": row.x_opt_pct,
                  "cpc_red_pct": row.cpc_red_pct},
        "ours": {
            "viable": bool(plan.viable),
            "x_be_pct": float(plan.x_break_even) * 100,
            "x_opt_pct": float(plan.x_opt) * 100,
            "cpc_red_pct": float(plan.cpc_reduction) * 100,
            "p_avg": float(prices.mean()),
        },
    }
    return dataclasses.asdict(fitted), report


def main(argv: list[str] | None = None, *,
         device: DeviceLike = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--regions", default=",".join(PAPER_TABLE2.keys()))
    ap.add_argument("--max-iter", type=int, default=120)
    args = ap.parse_args(argv)

    presets = json.loads(OUT.read_text()) if OUT.exists() else {}
    reports = []
    for region in args.regions.split(","):
        region = region.strip()
        params, report = fit_region(region, args.max_iter, device=device)
        presets[region] = params
        reports.append(report)
        print(json.dumps(report, indent=2))
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(presets, indent=2, sort_keys=True))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
