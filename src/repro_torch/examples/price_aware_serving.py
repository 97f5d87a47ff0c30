"""Variable capacity on the inference side: a batched serving engine whose
admission width follows the energy price.

Two engines serve the same request stream over the same simulated market
hours: one always-on, one price-gated (with a 2-slot SLO floor, the §V-B
"keep a subset up for availability" compromise). The comparison shows the
cost-per-token / queue-latency trade-off the paper's model predicts. The
reference's example (`examples/price_aware_serving.py`) on the port.

  PYTHONPATH=src python -m repro_torch.examples.price_aware_serving \
      [--device cpu] [--arch zamba2-1.2b]

``--arch`` picks the reduced configuration served (default the
reference's qwen1.5-0.5b).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.configs.inputs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.energy.markets import generate_market
from repro_torch.energy.presets import region_params
from repro_torch.energy.stream import PriceStream
from repro_torch.models.model import init_params
from repro_torch.runtime.scheduler import (EnergyAwareScheduler,
                                           SchedulerConfig)
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine


def run(gated: bool, prices, params, cfg, n_requests=120, ticks=400, *,
        device=None) -> dict:
    # the always-on engine still meters the same prices: psi=1e6 makes the
    # plan non-viable, so p_thresh = inf and admission is never gated.
    # Start the replay shortly before the year's worst doldrums so the
    # request stream actually spans a high-price episode.
    dev = resolve_device(device)
    start = int(np.argmax(prices)) - 20
    sched = EnergyAwareScheduler(
        PriceStream(prices.copy(), start=max(start, 0)),
        SchedulerConfig(psi=0.8 if gated else 1e6, mode="oracle"),
        device=dev)
    eng = ServingEngine(
        params, cfg,
        ServeConfig(slots=4, min_slots=1 if gated else 0, max_seq=64,
                    hours_per_tick=0.5, power_mw=0.5,
                    fixed_cost_per_hour=30.0),
        scheduler=sched, device=dev)
    rng = np.random.default_rng(7)
    arrivals = np.sort(rng.integers(0, (3 * ticks) // 4, n_requests))
    nxt = 0
    for t in range(ticks):
        while nxt < n_requests and arrivals[nxt] <= t:
            eng.submit(Request(rid=nxt,
                               prompt=rng.integers(
                                   2, cfg.vocab - 1, 8).astype(np.int32),
                               max_new=24))
            nxt += 1
        eng.tick()
    return eng.run(ticks=0)


def report(rows: list) -> None:
    """The reference's table: one line per (name, summary)."""
    print("engine        served  EUR/1k-tok  mean-queue-h  energy-cost  x")
    for name, out in rows:
        print(f"{name:12s} {out['tokens_served']:7d} "
              f"{out['eur_per_1k_tokens']:11.2f} "
              f"{out['mean_queue_h']:13.2f} "
              f"{out['energy_cost']:12.2f} {out['x_realized']:5.1%}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="the model whose reduced configuration is served")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    params = init_params(0, cfg, device=dev)
    prices = generate_market(region_params("south_australia"),
                             device=dev).prices.cpu().numpy()
    report([("price-gated" if gated else "always-on",
             run(gated, prices, params, cfg, device=dev))
            for gated in (False, True)])


if __name__ == "__main__":
    main()
