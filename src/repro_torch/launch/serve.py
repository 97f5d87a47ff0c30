"""Serving launcher: price-aware batched inference.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --requests 32 --ticks 400 --region germany

The reference's launcher (`repro.launch.serve`) with its flags and
defaults: the reduced configuration of ``--arch``, random parameters from
``--seed``, the price gate on a generated market of ``--region``. Adds
``--device`` (default cuda; ``--device cpu`` runs the plain attention).
"""

from __future__ import annotations

import argparse
import json

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--min-slots", type=int, default=0)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--region", default="germany")
    ap.add_argument("--psi", type=float, default=2.0)
    ap.add_argument("--no-price-gate", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    params = init_params(args.seed, cfg, device=dev)

    scheduler = None
    if not args.no_price_gate:
        md = generate_market(region_params(args.region, seed=args.seed),
                             device=dev)
        scheduler = EnergyAwareScheduler(
            PriceStream(md.prices.cpu().numpy()),
            SchedulerConfig(psi=args.psi, mode="oracle"), device=dev)

    eng = ServingEngine(params, cfg,
                        ServeConfig(slots=args.slots,
                                    min_slots=args.min_slots,
                                    max_seq=args.max_seq),
                        scheduler=scheduler, device=dev)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(
                               2, cfg.vocab - 1, size=8).astype(np.int32),
                           max_new=16))
    out = eng.run(ticks=args.ticks)
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in out.items()}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
