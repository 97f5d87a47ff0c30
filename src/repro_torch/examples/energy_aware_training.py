"""End to end: train a ~100M-parameter LM for a few hundred steps
under the paper's variable-capacity policy.

Every piece is real: the model (a 12-layer / d=768 dense transformer, the
qwen family scaled to ~100M parameters), AdamW, the deterministic data
pipeline, checkpointing, and the WS scheduler driving pause/resume against
a calibrated South-Australian price stream (the paper's high-volatility
market). The run reports the realised CPC reduction next to the model's
closed-form prediction, including the shutdown costs the paper's model
deliberately ignores (§V-A), so the gap is the measured bias of the
paper's upper bound. The reference's example
(`examples/energy_aware_training.py`) on the port.

  PYTHONPATH=src python -m repro_torch.examples.energy_aware_training \
      [--steps 300] [--device cpu] [--smoke]

``--smoke`` trains the reduced member of the same configuration
(`reduced_config`), small enough for a CPU check. The checkpoints go to a
temporary directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.inputs import reduced_config
from repro_torch.core.optimizer import optimal_shutdown
from repro_torch.device import resolve_device
from repro_torch.energy.markets import generate_market
from repro_torch.energy.presets import region_params
from repro_torch.energy.stream import PriceStream
from repro_torch.launch.roofline import param_counts
from repro_torch.runtime.scheduler import (EnergyAwareScheduler,
                                           SchedulerConfig)
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CFG_100M = register(ModelConfig(
    name="dense-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab=32000,
    dtype="float32", param_dtype="float32",   # CPU-friendly
    remat="none",
    attn_q_chunk=128, attn_kv_chunk=256,
))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--psi", type=float, default=0.8)
    ap.add_argument("--region", default="south_australia")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced configuration")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(CFG_100M) if args.smoke else CFG_100M
    pc = param_counts(cfg)
    n_params = pc["total"] + pc["embed"]
    print(f"model: {cfg.name} ({n_params/1e6:.0f}M params), "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    prices = generate_market(region_params(args.region),
                             device=dev).prices.cpu().numpy()
    plan = optimal_shutdown(prices, args.psi, device=dev)
    print(f"plan: x_opt={float(plan.x_opt):.2%} "
          f"threshold={float(plan.p_thresh):.1f} EUR/MWh "
          f"predicted CPC reduction={float(plan.cpc_reduction):.2%}")

    sched = EnergyAwareScheduler(
        PriceStream(prices),
        SchedulerConfig(psi=args.psi, mode="oracle"), device=dev)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg,
            TrainerConfig(steps=args.steps,
                          ckpt_dir=ckpt_dir,
                          ckpt_every=50,
                          hours_per_step=2.0,      # span several market weeks
                          power_mw=1.0,
                          fixed_cost_per_hour=args.psi * prices.mean(),
                          restart_energy_mwh=0.25, restart_time_h=0.1),
            scheduler=sched, batch_size=args.batch, seq_len=args.seq,
            device=dev)
        out = trainer.run(log_every=50)

    print("\n=== outcome ===")
    print(f"final loss            : {out['final_loss']:.4f}")
    print(f"uptime                : {out['uptime_hours']:.0f} h "
          f"of {out['hours']:.0f} h (x={out['x_realized']:.2%})")
    print(f"shutdown/resume cycles: {out['restarts']}")
    print(f"realised CPC reduction: {out['cpc_reduction']:.2%} over this "
          f"{out['hours']:.0f}h episode (full-year prediction "
          f"{float(plan.cpc_reduction):.2%}; the model's number is an "
          "upper bound w.r.t. shutdown costs — §V-A — but a short episode "
          "can realise more or less than the year-wide mean)")
    print(f"checkpoint save/restore: {out['ckpt_save_s']*1e3:.0f} ms / "
          f"{out['ckpt_restore_s']*1e3:.0f} ms")
    return out


if __name__ == "__main__":
    main()
