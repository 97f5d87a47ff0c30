"""Declarative, seeded fault schedules and their compiled mask form.

A `FaultTrace` is a plain list of `FaultEvent` windows — *what* goes
wrong, *where*, *when*, and *how hard* — decoupled from how any engine
consumes it. `FaultTrace.compile` lowers the schedule onto a concrete
scenario shape once, as dense numpy masks (`FaultMasks`): a capacity
multiplier per site-hour, boolean feed/forecast availability per
market-hour, and a demand multiplier per hour. The masks are what flows
through the fleet backtest, the dispatch water-fill and the live
controller (`repro_torch.faults.inject`, `repro_torch.live`) as ordinary
tensor arithmetic on the device.

The all-healthy masks are exact identities — capacity ``* 1.0``, price
``where(True, p, _)``, demand ``* 1.0`` — so an empty trace gives what a
run without the fault layer gives. `random_storm` draws a reproducible
storm from a seed for chaos testing (``python -m
repro_torch.examples.chaos_fleet``). This module is numpy only, the
reference's module as it is, so the same seed compiles to the same masks
bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

FAULT_KINDS = ("site_outage", "price_gap", "forecast_blackout",
               "demand_surge")


class FaultEvent(NamedTuple):
    """One fault window.

    kind : one of `FAULT_KINDS`.
    target : site index (``site_outage``), market index (``price_gap``,
        ``forecast_blackout``) or ignored (``demand_surge``); ``-1``
        hits every site/market.
    start, duration : hour window ``[start, start + duration)``,
        clipped to the horizon at compile time.
    magnitude : fraction of capacity *lost* for ``site_outage`` (1.0 =
        full outage, 0.3 = 30% derate); demand multiplier for
        ``demand_surge`` (1.5 = +50%); ignored for the feed faults.
    """

    kind: str
    target: int
    start: int
    duration: int
    magnitude: float = 1.0


class FaultMasks(NamedTuple):
    """Dense per-hour lowering of a `FaultTrace` onto one scenario.

    cap_mult : [S, T] float64 capacity multiplier (1.0 = healthy,
        0.0 = full outage). Rows are *sites* for dispatch and live use,
        or backtest rows when compiled with ``n_sites = B``.
    price_ok : [N, T] bool — the hour's price sample arrived.
    forecast_ok : [N, T] bool — the hour's forecast was published.
    demand_mult : [T] float64 fleet-demand multiplier.
    """

    cap_mult: np.ndarray
    price_ok: np.ndarray
    forecast_ok: np.ndarray
    demand_mult: np.ndarray

    @property
    def is_trivial(self) -> bool:
        """True when every mask is the identity (no fault ever fires)."""
        return bool((self.cap_mult == 1.0).all()
                    and self.price_ok.all() and self.forecast_ok.all()
                    and (self.demand_mult == 1.0).all())

    def counts(self) -> dict:
        """Per-kind fault exposure (hours), for telemetry and digests."""
        return {
            "outage_site_hours": int((self.cap_mult < 1.0).sum()),
            "price_gap_hours": int((~self.price_ok).sum()),
            "forecast_blackout_hours": int((~self.forecast_ok).sum()),
            "demand_surge_hours": int((self.demand_mult != 1.0).sum()),
        }


def identity_masks(n_sites: int, n_markets: int, horizon: int
                   ) -> FaultMasks:
    """The all-healthy masks: compiling an empty trace returns exactly
    these, and injecting them is bitwise a no-op."""
    return FaultMasks(
        cap_mult=np.ones((n_sites, horizon), np.float64),
        price_ok=np.ones((n_markets, horizon), bool),
        forecast_ok=np.ones((n_markets, horizon), bool),
        demand_mult=np.ones((horizon,), np.float64))


@dataclass(frozen=True)
class FaultTrace:
    """A declarative fault schedule: an ordered tuple of `FaultEvent`s
    plus the seed that generated them (``None`` for hand-written
    traces). Traces are shape-free; `compile` lowers onto a scenario."""

    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if ev.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r} "
                                 f"(expected one of {FAULT_KINDS})")
            if ev.duration < 0 or ev.start < 0:
                raise ValueError(f"negative fault window: {ev}")

    def __len__(self) -> int:
        return len(self.events)

    def compile(self, n_sites: int, n_markets: int, horizon: int
                ) -> FaultMasks:
        """Lower the schedule to dense `[S,T]`/`[N,T]`/`[T]` masks.

        Overlapping outages on one site compose by taking the *worst*
        derate; overlapping surges multiply. Windows are clipped to
        ``[0, horizon)``; a target index out of range raises.
        """
        m = identity_masks(n_sites, n_markets, horizon)
        for ev in self.events:
            lo = min(ev.start, horizon)
            hi = min(ev.start + ev.duration, horizon)
            if hi <= lo:
                continue
            if ev.kind == "site_outage":
                rows = self._rows(ev, n_sites, "site")
                keep = 1.0 - float(ev.magnitude)
                if not 0.0 <= keep <= 1.0:
                    raise ValueError(f"outage magnitude not in [0,1]: {ev}")
                m.cap_mult[rows, lo:hi] = np.minimum(
                    m.cap_mult[rows, lo:hi], keep)
            elif ev.kind == "price_gap":
                m.price_ok[self._rows(ev, n_markets, "market"),
                           lo:hi] = False
            elif ev.kind == "forecast_blackout":
                m.forecast_ok[self._rows(ev, n_markets, "market"),
                              lo:hi] = False
            else:                                    # demand_surge
                if ev.magnitude < 0.0:
                    raise ValueError(f"negative surge multiplier: {ev}")
                m.demand_mult[lo:hi] *= float(ev.magnitude)
        return m

    @staticmethod
    def _rows(ev: FaultEvent, n: int, what: str):
        if ev.target == -1:
            return slice(None)
        if not 0 <= ev.target < n:
            raise ValueError(
                f"{ev.kind} target {ev.target} out of range for "
                f"{n} {what}s")
        return slice(ev.target, ev.target + 1)


def random_storm(seed: int, n_sites: int, n_markets: int, horizon: int,
                 *, n_outages: int = 3, n_price_gaps: int = 2,
                 n_blackouts: int = 2, n_surges: int = 1,
                 max_duration: int = 48,
                 surge_range: Tuple[float, float] = (1.2, 1.8)
                 ) -> FaultTrace:
    """Draw a reproducible fault storm: every window, target, and
    magnitude comes from one `np.random.default_rng(seed)` stream, so a
    storm is identified by ``(seed, shape, counts)`` alone."""
    rng = np.random.default_rng(seed)
    events = []

    def window():
        dur = int(rng.integers(1, max_duration + 1))
        start = int(rng.integers(0, max(horizon - dur, 1)))
        return start, dur

    for _ in range(n_outages):
        start, dur = window()
        # mostly full outages, occasionally a partial derate
        mag = 1.0 if rng.random() < 0.7 else float(rng.uniform(0.3, 0.9))
        events.append(FaultEvent("site_outage",
                                 int(rng.integers(0, n_sites)),
                                 start, dur, mag))
    for _ in range(n_price_gaps):
        start, dur = window()
        events.append(FaultEvent("price_gap",
                                 int(rng.integers(0, n_markets)),
                                 start, dur))
    for _ in range(n_blackouts):
        start, dur = window()
        events.append(FaultEvent("forecast_blackout",
                                 int(rng.integers(0, n_markets)),
                                 start, dur))
    for _ in range(n_surges):
        start, dur = window()
        events.append(FaultEvent("demand_surge", -1, start, dur,
                                 float(rng.uniform(*surge_range))))
    return FaultTrace(events=tuple(events), seed=seed)
