"""Moving-block bootstrap of price traces — empirical market ensembles.

The fleet engine and the policy tuner consume an [N, T] price matrix
(`repro_torch.fleet.grid.build_grid` accepts one directly). For
synthetic markets, `MarketParams` seeds already give a Monte-Carlo
ensemble; for a *historical* trace (e.g. a SMARD CSV year, whose loader
comes to the port with the live slice) there is only one realisation.
The moving-block bootstrap resamples it into N pseudo-series that
preserve the short-range dependence structure (diurnal cycles, spike
persistence) within each block while shuffling the block order — the
standard tool for confidence bands on statistics of dependent series
(Kunsch 1989).

Primary use: tune policies on one resample set, validate the tuned
thresholds on held-out resamples
(`repro_torch.examples.tune_policies`), so the reported CPC improvement
is not an artifact of one spike's placement.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def block_bootstrap(prices: np.ndarray, n_series: int, *,
                    series_hours: Optional[int] = None,
                    block_hours: int = 7 * 24,
                    circular: bool = True,
                    seed: int = 0) -> np.ndarray:
    """Moving-block bootstrap resamples of a price trace.

    Parameters
    ----------
    prices : [T0] source trace (hourly samples).
    n_series : number of resampled series N.
    series_hours : length T of each resample (default: len(prices)).
    block_hours : block length L. Blocks this long are copied verbatim,
        so dependence up to ~L lags survives; a week (default) spans the
        diurnal and weekday structure of day-ahead markets.
    circular : sample block starts from the whole series, wrapping
        around the end (circular block bootstrap — every sample equally
        likely); ``False`` restricts starts to [0, T0 - L] (classic MBB,
        slight under-weighting of the edges).
    seed : RNG seed; resamples are reproducible.

    Returns a float32 [N, T] matrix that
    `repro_torch.fleet.grid.build_grid` accepts directly as its
    ``markets`` argument.
    """
    p = np.asarray(prices, np.float64).ravel()
    t0 = p.shape[0]
    if t0 < 2:
        raise ValueError("need a source trace with at least 2 samples")
    t = int(series_hours) if series_hours is not None else t0
    block = int(min(block_hours, t0))
    if block < 1:
        raise ValueError("block_hours must be >= 1")
    if n_series < 1:
        raise ValueError("n_series must be >= 1")

    rng = np.random.default_rng(seed)
    n_blocks = -(-t // block)                      # ceil
    if circular:
        starts = rng.integers(0, t0, size=(n_series, n_blocks))
        idx = (starts[..., None] + np.arange(block)) % t0
    else:
        starts = rng.integers(0, t0 - block + 1, size=(n_series, n_blocks))
        idx = starts[..., None] + np.arange(block)
    out = p[idx].reshape(n_series, n_blocks * block)[:, :t]
    return np.ascontiguousarray(out, dtype=np.float32)
