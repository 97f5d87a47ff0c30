"""Energy-aware trainer: the machinery the paper's decision model drives
(mirrors `repro.runtime.trainer`).

The trainer couples three clocks:

  * the *step* clock: real training steps (a forward and a backward with
    autograd, microbatch accumulation, optional int8 gradient
    compression, AdamW);
  * the *simulated wall* clock: each step (or idle tick) advances
    ``hours_per_step`` of market time against the price stream;
  * the *cost* clock: `CostMeter` integrates fixed + energy spend.

Each tick, the `EnergyAwareScheduler` decides RUN / SHUTDOWN / RESUME /
STAY_DOWN. A SHUTDOWN checkpoints (measured, not assumed: the save and
restore latencies and the restart energy feed the scheduler's
overhead-adjusted viability gate through
`measured_restart_overhead_frac`) and suspends compute; a RESUME restores
the parameters from the checkpoint, bit for bit, and training continues
at the step where it stopped (the data pipeline is stateless by step).

Fault tolerance uses the same path: an injected failure restores the last
checkpoint, and the lost steps are re-run and accounted. Stragglers: host
step times are sampled per tick, and the microbatches of hosts slower than
``straggler_deadline`` x median are dropped (the gradient renormalised
over the kept ones) instead of stalling the step.

A step is one Python call with autograd where the reference jits one
function: the parameters are leaf tensors that require grad, the loss's
gradient comes from `torch.autograd.grad`, the update runs under
``no_grad``. Everything stays on the device but the loss, which is read
once a step for the history, as the reference reads it.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import _dtype
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map)
from repro_torch.optim.compress import (dequantize, init_error_feedback,
                                        quantize_int8)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.accounting import CostMeter
from repro_torch.runtime.scheduler import Action, EnergyAwareScheduler

_METRICS = ("loss", "ce", "moe_aux", "tokens")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 200
    ckpt_dir: str = dataclasses.field(     # resolved when a config is made
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt"))
    ckpt_every: int = 50
    hours_per_step: float = 1.0        # simulated market-hours per step
    microbatches: int = 1              # gradient accumulation
    grad_compress: bool = False        # int8 error-feedback round trip
    # simulated cluster characteristics (cost model inputs)
    power_mw: float = 1.0
    fixed_cost_per_hour: float = 160.0
    idle_power_frac: float = 0.0
    restart_energy_mwh: float = 0.25   # energy to restart the fleet
    restart_time_h: float = 0.1        # wall time lost per resume
    # fault injection & stragglers (both off by default)
    fault_prob_per_step: float = 0.0
    straggler_sigma: float = 0.0       # lognormal sigma of host step time
    straggler_deadline: float = 1.5    # x median; slower microbatch dropped
    n_hosts: int = 8
    seed: int = 0


def _leaves_requiring_grad(params: dict) -> dict:
    return tree_map(lambda p: p.detach().requires_grad_(), params)


class Trainer:
    """Drives (model, optimizer, data) under an energy-aware schedule.

    Parameters are drawn from ``tcfg.seed`` (`init_params`: a CPU
    generator, then copied to ``device``, default cuda); ``params`` may
    be replaced before `run` (the tests carry the reference's across).
    ``data`` is anything with ``batch_at(step, device=)``."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 scheduler: Optional[EnergyAwareScheduler] = None,
                 opt: Optional[AdamWConfig] = None,
                 data=None, batch_size: int = 8, seq_len: int = 128, *,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.scheduler = scheduler
        self.opt = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
        self.data = data or SyntheticLM(vocab=cfg.vocab, seq_len=seq_len,
                                        global_batch=batch_size,
                                        seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.meter = CostMeter(power_mw=tcfg.power_mw,
                               fixed_cost_per_hour=tcfg.fixed_cost_per_hour,
                               idle_power_frac=tcfg.idle_power_frac)
        self.rng = np.random.default_rng(tcfg.seed)

        self.params = init_params(tcfg.seed, cfg, device=self.device)
        self.opt_state = adamw_init(self.params, self.opt)
        self.err = (init_error_feedback(self.params)
                    if tcfg.grad_compress else
                    tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                                   device=p.device),
                             self.params))
        self.step = 0
        self.running = True
        self.history: list[dict] = []
        self.lost_steps = 0
        self.dropped_microbatches = 0
        warm = max(tcfg.steps // 20, 1)
        self._lr = lambda step: float(warmup_cosine(step, self.opt.lr, warm,
                                                    tcfg.steps))

    # ------------------------------------------------------------------
    def _one_grad(self, params: dict, batch: dict) -> tuple[list, dict]:
        loss, metrics = loss_fn(params, batch, self.cfg)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return ([torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)],
                {k: metrics[k].detach() for k in _METRICS})

    def train_step(self, batch: dict, lr: float, micro_keep: np.ndarray
                   ) -> dict:
        """One optimizer step on ``batch``: ``micro_keep`` [microbatches]
        0/1, straggler-dropped microbatches contribute no gradient and the
        mean renormalises over the kept ones. Updates the parameters, the
        optimizer state and the error feedback; returns the metrics and
        the update's stats (device tensors)."""
        params = _leaves_requiring_grad(self.params)
        n_micro = self.tcfg.microbatches
        if n_micro == 1:
            grads, metrics = self._one_grad(params, batch)
        else:
            per = next(iter(batch.values())).shape[0] // n_micro
            adt = _dtype(self.cfg.grad_accum_dtype)
            grads = [torch.zeros(p.shape, dtype=adt, device=p.device)
                     for p in tree_leaves(params)]
            msum = {k: torch.zeros((), device=self.device) for k in _METRICS}
            for i in range(n_micro):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                g, m = self._one_grad(params, mb)
                keep = float(micro_keep[i])
                grads = [(a + keep * b.float()).to(adt)
                         for a, b in zip(grads, g)]
                msum = {k: msum[k] + keep * m[k] for k in _METRICS}
            denom = max(float(np.sum(micro_keep)), 1.0)
            grads = [g / denom for g in grads]
            metrics = {k: v / denom for k, v in msum.items()}
        with torch.no_grad():
            if self.tcfg.grad_compress:
                # one device: the quantisation and its error feedback are
                # real, the cross-pod gather is the identity
                errs = tree_leaves(self.err)
                out = [quantize_int8(g, e) for g, e in zip(grads, errs)]
                grads = [dequantize(q, s).to(g.dtype)
                         for (q, s, _), g in zip(out, grads)]
                new_err = iter([e for _, _, e in out])
                self.err = tree_map(lambda _: next(new_err), self.err)
            it = iter(grads)
            gtree = tree_map(lambda _: next(it), self.params)
            new_params, self.opt_state, stats = adamw_update(
                gtree, self.opt_state, params, self.opt, lr=lr)
        self.params = _leaves_requiring_grad(new_params)
        return {**metrics, **stats}

    # ------------------------------------------------------------------
    def _simulate_step_hosts(self) -> tuple[float, np.ndarray]:
        """Sample per-host step-time multipliers; return (step-time factor,
        keep mask over microbatches) under the straggler policy."""
        t = self.tcfg
        if t.straggler_sigma <= 0 or t.microbatches == 1:
            return 1.0, np.ones((t.microbatches,), np.float32)
        mult = self.rng.lognormal(0.0, t.straggler_sigma, t.n_hosts)
        med = float(np.median(mult))
        deadline = t.straggler_deadline * med
        # microbatches map round-robin onto hosts
        host_of = np.arange(t.microbatches) % t.n_hosts
        keep = (mult[host_of] <= deadline).astype(np.float32)
        if keep.sum() == 0:
            keep[:] = 1.0
        eff = min(float(np.max(np.where(mult <= deadline, mult, 0.0))),
                  deadline)
        self.dropped_microbatches += int((1 - keep).sum())
        return max(eff, med), keep

    def _checkpoint(self, blocking: bool = False):
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state,
                        "err": self.err},
                       metadata={"step": self.step}, blocking=blocking)

    def _restore(self):
        tree, meta = self.ckpt.restore(
            {"params": self.params, "opt": self.opt_state,
             "err": self.err})
        self.params = _leaves_requiring_grad(tree["params"])
        self.opt_state, self.err = tree["opt"], tree["err"]
        restored = int(meta["step"])
        self.lost_steps += max(self.step - restored, 0)
        self.step = restored

    # ------------------------------------------------------------------
    def run(self, log_every: int = 50,
            on_step: Optional[Callable[[dict], None]] = None) -> dict:
        t = self.tcfg
        self._checkpoint(blocking=True)          # step-0 baseline
        wall0 = time.perf_counter()
        while self.step < t.steps:
            price = (self.scheduler.stream.current()
                     if self.scheduler else 0.0)
            action = (self.scheduler.step(t.hours_per_step)
                      if self.scheduler else Action.RUN)

            if action is Action.SHUTDOWN:
                self._checkpoint(blocking=True)
                self.meter.shutdown_event()
                self.meter.tick(t.hours_per_step, price, running=False)
                self.running = False
                continue
            if action is Action.STAY_DOWN:
                self.meter.tick(t.hours_per_step, price, running=False)
                continue
            if action is Action.RESUME:
                self._restore()
                self.meter.restart_event(price, t.restart_energy_mwh,
                                         t.restart_time_h)
                self.running = True
                # the resume tick itself delivers compute below

            # fault injection (independent of the schedule)
            if (t.fault_prob_per_step > 0
                    and self.rng.random() < t.fault_prob_per_step):
                self._restore()
                self.meter.restart_event(price, t.restart_energy_mwh,
                                         t.restart_time_h)

            slowdown, keep = self._simulate_step_hosts()
            batch = self.data.batch_at(self.step, device=self.device)
            metrics = self.train_step(batch, self._lr(self.step), keep)
            self.meter.tick(t.hours_per_step * slowdown, price,
                            running=True)
            self.step += 1

            if self.step % t.ckpt_every == 0:
                self._checkpoint()
            rec = {"step": self.step, "loss": float(metrics["loss"]),
                   "price": price, "cpc": self.meter.cpc,
                   "running": True}
            self.history.append(rec)
            if on_step is not None:
                on_step(rec)
            if log_every and self.step % log_every == 0:
                print(f"step {self.step:5d} loss {rec['loss']:.4f} "
                      f"price {price:7.2f} cpc {self.meter.cpc:9.2f} "
                      f"x={self.meter.realized_x:.3%}")

        self.ckpt.wait()
        out = self.meter.summary()
        out.update({
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "lost_steps": self.lost_steps,
            "dropped_microbatches": self.dropped_microbatches,
            "wall_s": time.perf_counter() - wall0,
            "ckpt_save_s": self.ckpt.last_save_s,
            "ckpt_restore_s": self.ckpt.last_restore_s,
        })
        return out

    # ------------------------------------------------------------------
    def measured_restart_overhead_frac(self) -> float:
        """Measured shutdown overhead as a fraction of one suspend-hour's
        energy saving; feeds SchedulerConfig.restart_overhead_frac."""
        t = self.tcfg
        save_h = self.ckpt.last_save_s / 3600.0
        restore_h = self.ckpt.last_restore_s / 3600.0
        overhead_mwh = (t.restart_energy_mwh
                        + t.power_mw * (save_h + restore_h + t.restart_time_h))
        return overhead_mwh / max(t.power_mw * 1.0, 1e-9)
