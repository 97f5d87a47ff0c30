"""Price model — paper Section III(a), Eqs. (1)-(5) and the PV set Eq. (20).

Given a price series ``p`` over period ``T`` and a shutdown fraction ``x``,
prices split at the (1-x)-quantile into a *high* and a *low* region and

    k(x) = p_high(x) / p_avg            (Eq. 3)

With n samples sorted descending, x = m/n for m = 1..n-1 and p_high(m) is
the mean of the top-m samples, so the whole PV set (Eq. 20) is one sort
plus one cumulative sum. Float64 input stays float64; anything else
computes in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DeviceLike, as_tensor


class PriceStats(NamedTuple):
    """The (k, x) description of a price series (Table I)."""

    x: torch.Tensor         # shutdown fraction in (0, 1)
    k: torch.Tensor         # p_high / p_avg                      (Eq. 3)
    p_avg: torch.Tensor     # mean price over T
    p_high: torch.Tensor    # mean price inside the high region    (Eq. 4)
    p_low: torch.Tensor     # mean price inside the low region     (Eq. 5)
    p_thresh: torch.Tensor  # Q_{1-x}(p)                           (Eq. 1)


def _sorted_desc(prices, device: DeviceLike) -> torch.Tensor:
    return torch.sort(as_tensor(prices, device), descending=True).values


def price_variability(prices, *, device: DeviceLike = None) -> PriceStats:
    """The full empirical PV set (Eq. 20): fields of length n-1, one per
    feasible shutdown fraction x = m/n."""
    p = _sorted_desc(prices, device)
    n = p.shape[0]
    p_avg = p.mean()
    m = torch.arange(1, n, device=p.device)
    x = m / n
    cum = torch.cumsum(p, 0)[:-1]
    p_high = cum / m
    p_low = (p.sum() - cum) / (n - m)
    return PriceStats(x=x, k=p_high / p_avg, p_avg=p_avg.expand(x.shape),
                      p_high=p_high, p_low=p_low, p_thresh=p[m - 1])


def price_stats(prices, x, *, device: DeviceLike = None) -> PriceStats:
    """Model parameters (Eqs. 1-5) at shutdown fraction(s) ``x``."""
    p = _sorted_desc(prices, device)
    n = p.shape[0]
    x = torch.as_tensor(x, dtype=torch.float32, device=p.device)
    p_avg = p.mean()
    m = torch.clamp(torch.round(x * n).to(torch.int64), 1, n - 1)
    cum = torch.cat([p.new_zeros(1), torch.cumsum(p, 0)])
    x_eff = m / n
    p_high = cum[m] / m
    return PriceStats(x=x_eff, k=p_high / p_avg,
                      p_avg=p_avg.expand(x_eff.shape), p_high=p_high,
                      p_low=(cum[n] - cum[m]) / (n - m), p_thresh=p[m - 1])


def threshold_price(prices, x: float, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """p_thresh = Q_{1-x}(p_1..n)  (Eq. 1)."""
    return price_stats(prices, x, device=device).p_thresh


def region_means(p_avg, k, x):
    """Closed-form p_high, p_low from (p_avg, k, x)  (Eqs. 4-5)."""
    return p_avg * k, p_avg * (k * x - 1.0) / (x - 1.0)


def resample(prices, factor: int, *,
             device: DeviceLike = None) -> torch.Tensor:
    """Block-average ``factor`` samples (Fig. 3: 1 h -> 1 day -> 1 week);
    the trailing remainder is dropped."""
    p = as_tensor(prices, device)
    n = (p.shape[0] // factor) * factor
    return p[:n].reshape(-1, factor).mean(1)
