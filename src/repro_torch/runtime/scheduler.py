"""EnergyAwareScheduler — the paper's WS policy as a control loop.

The paper derives the *planning* quantities offline: given a price series
and the system's cost-distribution coefficient Psi, `optimal_shutdown`
yields the CPC-minimising shutdown fraction x_opt and its threshold price.
This scheduler turns that into an *online* policy:

  oracle mode     the full series is known (paper's setting): the threshold
                  is fixed at p_thresh(x_opt) up front. Reproduces the
                  paper's WS policy exactly.
  rolling mode    the threshold is re-estimated every ``refit_hours`` from
                  the trailing window of observed prices (plus optional
                  day-ahead lookahead, which real spot markets publish).
                  This is what an operator could actually deploy.

Beyond the paper (§V-A closes the free-shutdown assumption):

  * viability gate uses the *overhead-adjusted* criterion
    k (1 - overhead) > Psi + 1, with the overhead measured by the trainer
    (checkpoint save + restore time and restart energy);
  * hysteresis + ``min_off_hours`` suppress shutdown churn: a suspend is
    only worth its restart cost if prices stay high long enough;
  * capacity levels for *partial* shutdown of heterogeneous partitions
    (paper §V-C: uniform clusters are all-or-nothing — the scheduler
    emits fractional capacity only when distinct partitions exist).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from repro_torch.core.optimizer import optimal_shutdown
from repro_torch.core.price_model import price_stats
from repro_torch.device import DeviceLike, resolve_device


class Action(enum.Enum):
    RUN = "run"
    SHUTDOWN = "shutdown"
    RESUME = "resume"
    STAY_DOWN = "stay_down"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    psi: float = 2.0                 # cost-distribution coefficient
    mode: str = "oracle"             # oracle | rolling
    refit_hours: int = 24            # rolling: threshold refit period
    lookahead_hours: int = 0         # rolling: day-ahead peek
    hysteresis: float = 0.9          # resume at p < hysteresis * p_thresh
    min_off_hours: float = 1.0       # don't suspend for shorter spikes
    restart_overhead_frac: float = 0.0  # measured; adjusts viability
    x_cap: float = 0.5               # never plan more than 50% downtime


class EnergyAwareScheduler:
    """Maps a PriceStream to RUN / SHUTDOWN / RESUME / STAY_DOWN actions."""

    def __init__(self, stream, config: SchedulerConfig, *,
                 device: DeviceLike = None):
        self.stream = stream
        self.cfg = config
        self.device = resolve_device(device)
        self.running = True
        self.p_thresh = np.inf
        self.planned_x = 0.0
        self.viable = False
        self._hours_since_fit = np.inf
        self._off_hours = 0.0
        if config.mode == "oracle":
            self._fit(np.asarray(stream.prices))

    # ------------------------------------------------------------------
    def _fit(self, prices: np.ndarray) -> None:
        """(Re)derive threshold from a price window via the paper model."""
        plan = optimal_shutdown(np.asarray(prices, np.float32),
                                self.cfg.psi, device=self.device)
        k_opt = float(plan.k_opt) if np.isfinite(float(plan.k_opt)) else 0.0
        # overhead-adjusted viability (beyond-paper §V-A correction)
        adj_ok = (k_opt * (1.0 - self.cfg.restart_overhead_frac)
                  > self.cfg.psi + 1.0)
        self.viable = bool(plan.viable) and adj_ok
        if self.viable:
            self.planned_x = min(float(plan.x_opt), self.cfg.x_cap)
            self.p_thresh = float(plan.p_thresh)
        else:
            self.planned_x = 0.0
            self.p_thresh = np.inf
        self._hours_since_fit = 0.0

    def _maybe_refit(self) -> None:
        if self.cfg.mode != "rolling":
            return
        if self._hours_since_fit >= self.cfg.refit_hours:
            window = self.stream.trailing()
            if self.cfg.lookahead_hours:
                window = np.concatenate(
                    [window, self.stream.peek(self.cfg.lookahead_hours)])
            self._fit(window)

    # ------------------------------------------------------------------
    def step(self, hours: float = 1.0) -> Action:
        """Advance the simulated clock and decide the next action."""
        self._hours_since_fit += hours
        self._maybe_refit()
        price = self.stream.current()
        self.stream.advance(hours)

        if self.running:
            if price > self.p_thresh and self._spike_long_enough():
                self.running = False
                self._off_hours = 0.0
                return Action.SHUTDOWN
            return Action.RUN
        # suspended: resume below the hysteresis threshold
        self._off_hours += hours
        if price <= self.cfg.hysteresis * self.p_thresh:
            self.running = True
            return Action.RESUME
        return Action.STAY_DOWN

    def _spike_long_enough(self) -> bool:
        """Day-ahead check: will the price stay above threshold for at
        least ``min_off_hours``? (Without lookahead, assume yes — the
        single-threshold paper policy.)"""
        need = int(np.ceil(self.cfg.min_off_hours))
        if need <= 1 or self.cfg.lookahead_hours < need:
            return True
        ahead = self.stream.peek(need - 1)
        return bool(np.all(ahead > self.p_thresh))

    # ------------------------------------------------------------------
    def stats_snapshot(self) -> dict:
        window = (np.asarray(self.stream.prices)
                  if self.cfg.mode == "oracle" else self.stream.trailing())
        x = max(self.planned_x, 1e-4)
        st = price_stats(np.asarray(window, np.float32), x,
                         device=self.device)
        return {
            "p_thresh": self.p_thresh,
            "planned_x": self.planned_x,
            "viable": self.viable,
            "k_at_plan": float(st.k),
            "p_avg": float(st.p_avg),
        }


@dataclasses.dataclass(frozen=True)
class Partition:
    """A heterogeneous-cluster partition (paper §V-C): its own power draw
    and fixed-cost share, hence its own Psi and its own plan."""

    name: str
    power_mw: float
    fixed_cost_per_hour: float

    def psi(self, p_avg: float) -> float:
        return self.fixed_cost_per_hour / (self.power_mw * p_avg)


def partition_plans(partitions: list[Partition], prices: np.ndarray, *,
                    device: DeviceLike = None) -> dict:
    """Per-partition shutdown plans — the model applied partition-wise.
    Less energy-efficient partitions (higher C per fixed cost => lower Psi)
    become viable first."""
    p_avg = float(np.mean(prices))
    prices32 = np.asarray(prices, np.float32)
    out = {}
    for part in partitions:
        plan = optimal_shutdown(prices32, part.psi(p_avg), device=device)
        out[part.name] = {
            "psi": part.psi(p_avg),
            "viable": bool(plan.viable),
            "x_opt": float(plan.x_opt),
            "p_thresh": float(plan.p_thresh),
            "cpc_reduction": float(plan.cpc_reduction),
        }
    return out
