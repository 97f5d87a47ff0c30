"""Price-aware batched serving engine (mirrors `repro.serving.engine`).

Continuous batching over a fixed pool of decode slots: arriving requests
are prefilled into free slots; every engine tick runs one batched
`decode_step` for all slots. The cache pool (KV, or SSM conv and state)
is allocated once at ``max_seq`` and slots are recycled.

Variable capacity for serving (the paper's technique on the inference
side): the *admission width* follows the energy price. At high prices the
engine stops admitting new requests (optionally keeping a ``min_slots``
floor for SLO floors, per the paper's §V-B note that operators may keep a
subset up for availability) and drains; at low prices it runs the full
width. The cost meter attributes energy to served tokens, yielding
EUR/1k-tokens — CPC with "compute" = tokens.

A tick runs in the reference's order: admission (one prefill per newly
filled slot), one batched `decode_step`, greedy argmax, the meter's tick.
The pool is updated in place (`decode_step` writes the new k/v, and a
prefilled request is copied into its slot), where the reference replaces
it; the engine runs eagerly where the reference jits the decode step.
On the card a dense model's prefill launches the flash kernel once per
layer and every tick the decode kernel once per layer; an SSM model's
prefill launches the SSD scan kernel once per layer, and its decode step
is the plain one-token recurrence; a hybrid model's (zamba2's) prefill
launches the SSD scan once per Mamba2 layer and the flash kernel once per
application of its shared attention block (n_layers // hybrid_attn_every),
and every tick the decode kernel once per application. A hybrid pool holds
both caches, and a prefilled request is copied into each. A MoE model
(mixtral, grok-1) serves as a dense one does, its expert FFN in PyTorch
operations (the reference's einsums). An int8 pool (``kv_cache_dtype=
"int8"``) carries its scales beside the K/V, and its decode steps run the
reference's own plain int8 route instead of the decode kernel.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.runtime.accounting import CostMeter


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [prompt_len] int32
    max_new: int
    arrived_h: float = 0.0
    # filled by the engine
    started_h: Optional[float] = None
    done_h: Optional[float] = None
    output: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 8                  # decode batch width
    min_slots: int = 0              # SLO floor kept during high prices
    max_seq: int = 256
    hours_per_tick: float = 0.02    # simulated market-time per decode tick
    power_mw: float = 0.5
    fixed_cost_per_hour: float = 80.0


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig,
                 scheduler=None, *, device: DeviceLike = None):
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.scheduler = scheduler   # EnergyAwareScheduler or None
        self.device = resolve_device(device)
        self.meter = CostMeter(power_mw=scfg.power_mw,
                               fixed_cost_per_hour=scfg.fixed_cost_per_hour)
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}       # slot -> request
        self.remaining: dict[int, int] = {}
        self.clock_h = 0.0
        self.tokens_served = 0
        self.completed: list[Request] = []

        b, s = scfg.slots, scfg.max_seq
        self.caches = init_cache(cfg, b, s, device=self.device)
        self.positions = np.zeros((b,), np.int32)      # host copy
        self.tokens = torch.zeros((b, 1), dtype=torch.int64,
                                  device=self.device)
        self.live = np.zeros((b,), bool)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrived_h = self.clock_h
        self.queue.append(req)

    def _admission_width(self) -> int:
        """Price-gated number of usable slots."""
        if self.scheduler is None:
            return self.scfg.slots
        price = self.scheduler.stream.current()
        if price > self.scheduler.p_thresh:
            return self.scfg.min_slots
        return self.scfg.slots

    def _fill_slots(self) -> None:
        width = self._admission_width()
        for slot in range(self.scfg.slots):
            if self.live[slot] or slot >= width or not self.queue:
                continue
            req = self.queue.popleft()
            req.started_h = self.clock_h
            plen = len(req.prompt)
            batch = {"tokens": torch.as_tensor(
                np.asarray(req.prompt, np.int64)[None], device=self.device)}
            logits, caches1 = prefill(self.params, batch, self.cfg,
                                      max_seq=self.scfg.max_seq)
            nxt = torch.argmax(logits, -1)                   # greedy
            # copy the single-sequence cache into slot `slot`
            for name, pool in self.caches.items():
                _slot_set(pool, caches1[name], slot)
            self.positions[slot] = plen
            self.tokens[slot, 0] = nxt[0]
            self.live[slot] = True
            self.active[slot] = req
            self.remaining[slot] = req.max_new - 1
            req.output = [int(nxt[0])]
            self.tokens_served += 1

    def tick(self) -> None:
        """One engine tick: admissions + one batched decode step."""
        price = (self.scheduler.stream.current()
                 if self.scheduler else 0.0)
        if self.scheduler is not None:
            self.scheduler.step(self.scfg.hours_per_tick)
        self._fill_slots()
        any_live = bool(self.live.any())
        if any_live:
            pos = torch.as_tensor(self.positions, device=self.device)
            logits, self.caches = decode_step(
                self.params, self.tokens, self.caches, pos, self.cfg)
            nxt = torch.argmax(logits, -1)                   # [B]
            self.tokens = nxt[:, None]
            self.positions = self.positions + self.live.astype(np.int32)
            nxt_host = nxt.tolist()
            for slot in list(self.active):
                if not self.live[slot]:
                    continue
                req = self.active[slot]
                req.output.append(int(nxt_host[slot]))
                self.tokens_served += 1
                self.remaining[slot] -= 1
                full = int(self.positions[slot]) >= self.scfg.max_seq - 1
                if self.remaining[slot] <= 0 or full:
                    req.done_h = self.clock_h
                    self.completed.append(req)
                    del self.active[slot], self.remaining[slot]
                    self.live[slot] = False
        self.meter.tick(self.scfg.hours_per_tick, price, running=any_live,
                        load=float(self.live.mean()) if any_live else 0.0)
        self.clock_h += self.scfg.hours_per_tick

    def summary(self) -> dict:
        done = self.completed
        waits = [r.started_h - r.arrived_h for r in done
                 if r.started_h is not None]
        out = self.meter.summary()
        out.update({
            "tokens_served": self.tokens_served,
            "completed": len(done),
            "queued": len(self.queue),
            "mean_queue_h": float(np.mean(waits)) if waits else 0.0,
            "eur_per_1k_tokens": (self.meter.tco
                                  / max(self.tokens_served, 1) * 1000.0),
        })
        return out

    def run(self, ticks: int) -> dict:
        for _ in range(ticks):
            self.tick()
        return self.summary()


def _slot_set(pool: NamedTuple, one: NamedTuple, slot: int) -> None:
    """Write a batch-1 cache (`AttnCache` or `SSMCache`) into slot ``slot``
    of the pooled cache, leaf by leaf, in place: every leaf is [L, B, ...]
    (L the layers, or the hybrid family's applications for its K/V),
    ``one``'s with B = 1 and otherwise the pool's shape (an SSM prefill's
    conv tail always holds K-1 rows, left-padded with zeros). The scales
    of a bf16 `AttnCache` are None in both, and are skipped."""
    for p, o in zip(pool, one):
        if p is not None:
            p[:, slot] = o[:, 0].to(p.dtype)
