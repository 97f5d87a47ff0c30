"""Price streams: the runtime-facing interface to a market.

A ``PriceStream`` replays a (real or synthetic) hourly series at an
arbitrary simulated clock rate and exposes the trailing window the
``EnergyAwareScheduler`` needs to re-estimate the PV set online. It is
plain Python (host-side control plane) — device code never sees prices.

Lookahead follows the day-ahead market contract: the exchange clears
once per day (EPEX SPOT / Nord Pool publish around 13:00) and the
result covers all 24 hours of the *next* delivery day. Before
``publish_hour`` the stream therefore only knows prices through the end
of the current day; after it, through the end of the next day. ``peek``
truncates to that boundary instead of leaking perfect foresight.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def ffill_with_staleness(values, *, fill_value: Optional[float] = None):
    """Carry the last finite sample forward over NaN/inf gaps.

    Returns ``(filled, staleness)`` — ``filled`` is ``values`` with every
    non-finite entry replaced by the most recent finite one, and
    ``staleness[i]`` counts how many samples ago that donor was observed
    (0 where ``values[i]`` itself is finite). A leading gap (no prior
    finite sample) is filled with ``fill_value`` (default: the first
    finite sample in the series) and its staleness counts from the
    series start. Fully vectorized: gap positions index the running
    maximum of observed positions, so a year-long series fills in one
    pass with no Python loop.
    """
    v = np.asarray(values, dtype=np.float64)
    if v.ndim != 1:
        raise ValueError("ffill_with_staleness expects a 1-D series")
    ok = np.isfinite(v)
    if not ok.any():
        raise ValueError("cannot forward-fill an all-gap series")
    pos = np.arange(v.size)
    last = np.maximum.accumulate(np.where(ok, pos, -1))
    staleness = np.where(last >= 0, pos - last, pos + 1).astype(np.int64)
    if fill_value is None:
        fill_value = v[ok][0]
    filled = np.where(last >= 0, v[np.maximum(last, 0)],
                      np.float64(fill_value))
    return filled, staleness


class PriceStream:
    """Replays a price series with a trailing-window view.

    Parameters
    ----------
    prices : array [n]
        hourly price samples (EUR/MWh).
    window : int
        trailing window length used for online PV estimation.
    start : int
        starting index into the series (index 0 is hour 0 of a day).
    publish_hour : int or None
        local hour at which the day-ahead auction result for the next
        delivery day becomes visible (default 13, the EPEX/Nord Pool
        gate-closure convention). ``None`` disables the publication
        gate and restores unlimited lookahead (backtests that *want*
        perfect foresight must now ask for it explicitly).
    fill : str or None
        ``"ffill"`` carries the last finite price forward over NaN gaps
        in the feed (a dropped exchange message, a faulted scrape) and
        keeps a per-hour staleness counter; ``None`` (default) rejects
        non-finite input loudly, preserving the pre-existing contract
        that a stream never silently serves bad data.
    """

    def __init__(self, prices, window: int = 24 * 28, start: int = 0,
                 publish_hour: Optional[int] = 13,
                 fill: Optional[str] = None):
        self.prices = np.asarray(prices, dtype=np.float64)
        if self.prices.ndim != 1 or self.prices.shape[0] < 2:
            raise ValueError("prices must be a 1-D series")
        if publish_hour is not None and not 0 <= int(publish_hour) < 24:
            raise ValueError("publish_hour must be in [0, 24) or None")
        if fill not in (None, "ffill"):
            raise ValueError(f"unknown fill mode {fill!r}")
        if fill == "ffill":
            self.prices, self.staleness = \
                ffill_with_staleness(self.prices)
        else:
            if not np.isfinite(self.prices).all():
                raise ValueError(
                    "prices contain non-finite samples; pass "
                    "fill='ffill' to carry the last good price forward")
            self.staleness = np.zeros(self.prices.shape, dtype=np.int64)
        self.fill = fill
        self.window = int(window)
        self.publish_hour = (None if publish_hour is None
                             else int(publish_hour))
        self._start = int(start)
        self._hours = 0.0            # fractional hours accumulate exactly

    @property
    def pos(self) -> int:
        return self._start + int(self._hours)

    def __len__(self) -> int:
        return len(self.prices)

    def current(self) -> float:
        return float(self.prices[self.pos % len(self.prices)])

    def trailing(self) -> np.ndarray:
        """The trailing ``window`` samples ending at the current hour."""
        n = len(self.prices)
        idx = (np.arange(self.pos - self.window + 1, self.pos + 1)) % n
        return self.prices[idx]

    def advance(self, hours: float = 1.0) -> None:
        """Advance simulated time; sub-hour ticks accumulate without loss
        (a 0.02 h serving tick still crosses hour boundaries on time)."""
        self._hours += float(hours)

    def reset(self) -> None:
        """Rewind to the construction position for deterministic replay."""
        self._hours = 0.0

    def published_through(self) -> int:
        """Last absolute index whose price is published at the current
        hour under the day-ahead contract: the end of today, plus all of
        tomorrow once the auction result is out (``pos`` hour-of-day >=
        ``publish_hour``)."""
        if self.publish_hour is None:
            return self.pos + len(self.prices)   # effectively unlimited
        pos = self.pos
        day_end = (pos // 24) * 24 + 23
        if pos % 24 >= self.publish_hour:
            day_end += 24
        return day_end

    @property
    def available_lookahead(self) -> int:
        """How many future samples ``peek`` can currently return."""
        return max(0, self.published_through() - self.pos)

    def peek(self, horizon: int) -> np.ndarray:
        """Published future prices, up to ``horizon`` samples.

        Returns *at most* ``min(horizon, available_lookahead)`` samples
        — possibly zero-length early in the day. Callers needing a fixed
        length should pad with a forecast (a forecast).
        """
        n = len(self.prices)
        horizon = min(int(horizon), self.available_lookahead)
        idx = (np.arange(self.pos + 1, self.pos + 1 + horizon)) % n
        return self.prices[idx]

    def __iter__(self) -> Iterator[float]:
        """Yield one hourly sample per step from the current position,
        advancing the stream — one full pass over the series. Does not
        rewind first; call `reset` for replay from the start."""
        for _ in range(len(self.prices)):
            yield self.current()
            self.advance(1.0)
