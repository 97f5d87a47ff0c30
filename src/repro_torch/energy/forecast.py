"""Minimal electricity-price forecasting (EPF) baselines.

The paper defers to the EPF literature [17] for real forecasting; the
runtime only needs a *sane* expectation of near-term prices to set its
threshold before day-ahead prices publish. We implement the two standard
EPF baselines (Lago et al., 2021):

  seasonal-naive  p^(t+h) = p(t + h - 168)   (same hour last week)
  similar-day AR  seasonal-naive + AR(1)-damped recent residual

Both are **strictly causal**: a forecast for step ``h`` reads only the
last ``season`` samples of history, tiling the most recent season when
the horizon runs past it (the old ``% len(history)`` wrap reached into
samples the forecaster could never have seen in a walk-forward setting).

The ``*_batch`` variants are the tensor path ``[..., W] -> [..., H]``
the live operator loop (`repro_torch.live`) runs on the device over
thousands of controller instances — same index arithmetic, same
fallbacks, so the numpy and batched seasonal-naive forecasts agree
exactly; the batched similar-day AR computes its damping powers in
float32 (as the reference's batched form does), so it agrees with the
float64 numpy form to float32 rounding.

Accuracy metrics: ``mae`` and the scale-free ``mase`` (MAE scaled by the
in-sample seasonal-naive MAE — Hyndman & Koehler 2006), the standard EPF
skill score: mase < 1 beats the seasonal-naive yardstick.
"""

from __future__ import annotations

import numpy as np
import torch


def effective_season(n: int, season: int) -> int:
    """The season actually usable with ``n`` history samples: the
    requested one when it fits, else daily (24), else 1 (persistence).
    Single source of the fallback, shared by the numpy and batched
    paths (and by the live loop's window sizing)."""
    if n >= season:
        return season
    return 24 if n >= 24 else 1


def seasonal_naive(history: np.ndarray, horizon: int,
                   season: int = 168) -> np.ndarray:
    """Repeat the same hour from ``season`` samples ago, tiling the
    *last* season of history when ``horizon > season`` (strictly
    causal — never wraps into samples older than one season, and never
    into the unknown future)."""
    history = np.asarray(history)
    n = history.shape[-1] if history.ndim else history.shape[0]
    season = effective_season(int(n), season)
    idx = n - season + (np.arange(horizon) % season)
    return history[..., idx] if history.ndim > 1 else history[idx]


def similar_day_ar(history: np.ndarray, horizon: int,
                   season: int = 168, damp: float = 0.9) -> np.ndarray:
    """Seasonal-naive plus exponentially damped last residual (the
    residual needs one extra sample: season + 1 history)."""
    history = np.asarray(history, dtype=np.float64)
    base = seasonal_naive(history, horizon, season)
    s = effective_season(history.shape[-1] - 1, season)
    resid = np.asarray(history[..., -1] - history[..., -1 - s])
    correction = resid[..., None] * damp ** np.arange(1, horizon + 1)
    return base + correction


def seasonal_naive_batch(history, horizon: int, season: int = 168):
    """Batched seasonal-naive on a tensor: ``history [..., W] ->
    [..., H]``, on ``history``'s device.

    Same strictly causal tiling as `seasonal_naive`. The live loop calls
    this on the per-market trailing window every simulated hour."""
    history = torch.as_tensor(history)
    w = int(history.shape[-1])
    season = effective_season(w, season)
    idx = w - season + (torch.arange(horizon, device=history.device)
                        % season)
    return history[..., idx]


def similar_day_ar_batch(history, horizon: int, season: int = 168,
                         damp: float = 0.9):
    """Batched similar-day AR on a tensor: ``history [..., W] ->
    [..., H]`` — `seasonal_naive_batch` plus the damped last-residual
    correction, its powers ``damp ** k`` taken in ``history``'s dtype
    (float32 for the live loop, as in the reference's batched form)."""
    history = torch.as_tensor(history)
    base = seasonal_naive_batch(history, horizon, season)
    s = effective_season(int(history.shape[-1]) - 1, season)
    resid = history[..., -1] - history[..., -1 - s]
    k = torch.arange(1, horizon + 1, dtype=base.dtype,
                     device=history.device)
    correction = resid[..., None] * torch.pow(damp, k)
    return base + correction


def mae(pred: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(pred) - np.asarray(truth))))


def mase(pred: np.ndarray, truth: np.ndarray, history: np.ndarray,
         season: int = 168) -> float:
    """Mean absolute *scaled* error: MAE over the forecast divided by
    the in-sample MAE of the seasonal-naive forecaster on ``history``
    (Hyndman & Koehler 2006). Scale-free across markets with different
    price levels; < 1 means the forecaster beats seasonal-naive."""
    history = np.asarray(history, np.float64)
    s = effective_season(history.shape[0] - 1, season)
    scale = float(np.mean(np.abs(history[s:] - history[:-s])))
    return mae(pred, truth) / max(scale, 1e-12)
