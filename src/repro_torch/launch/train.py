"""Training launcher: energy-aware training of any assigned architecture.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 200 --region germany --psi 2.0 --mode oracle

The reference's launcher (`repro.launch.train`) with its flags and
defaults: the reduced configuration of ``--arch`` (``--full-config``
trains it unreduced), parameters drawn from ``--seed``, the scheduler on a
generated market of ``--region``, the `Trainer`'s checkpoints as the
shutdown / resume mechanism. Adds ``--device`` (default cuda; ``--device
cpu`` runs the kernels' plain versions). Without ``--ckpt-dir`` the
checkpoints go to a temporary directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.configs.base import get_config
from repro_torch.configs.inputs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.energy.markets import generate_market
from repro_torch.energy.presets import region_params
from repro_torch.energy.stream import PriceStream
from repro_torch.runtime.scheduler import (EnergyAwareScheduler,
                                           SchedulerConfig)
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--region", default="germany")
    ap.add_argument("--psi", type=float, default=2.0)
    ap.add_argument("--mode", default="oracle",
                    choices=["oracle", "rolling", "always-on"])
    ap.add_argument("--full-config", action="store_true",
                    help="train the full architecture config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fault-prob", type=float, default=0.0)
    ap.add_argument("--straggler-sigma", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)

    md = generate_market(region_params(args.region, seed=args.seed),
                         device=dev)
    stream = PriceStream(md.prices.cpu().numpy())
    scheduler = None
    if args.mode != "always-on":
        scheduler = EnergyAwareScheduler(
            stream, SchedulerConfig(psi=args.psi, mode=args.mode),
            device=dev)
        print("scheduler:", scheduler.stats_snapshot())

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(
            cfg,
            TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir or tmp,
                          microbatches=args.microbatches,
                          grad_compress=args.grad_compress,
                          fault_prob_per_step=args.fault_prob,
                          straggler_sigma=args.straggler_sigma,
                          seed=args.seed),
            scheduler=scheduler, batch_size=args.batch, seq_len=args.seq,
            device=dev)
        out = trainer.run()
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in out.items()}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
