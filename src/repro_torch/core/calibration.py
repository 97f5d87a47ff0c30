"""Calibrate synthetic market generators against published statistics.

The paper's case studies derive from 2024 price series we cannot access
offline. Each region in Table II, however, pins down points on the k-x
curve:

  * at the break-even fraction  x_BE:  k(x_BE) = Psi + 1      (Eq. 19)
  * at the optimum x_opt, the CPC reduction `red` gives (Eq. 28)
        k_opt = (Psi+1) * (1 - (1-red)(1-x_opt)) / x_opt

We fit the spike/volatility parameters of `repro_torch.energy.markets` so
the synthetic series reproduces those (x, k) targets (p_avg is matched
exactly by scaling — k is scale-invariant). The optimizer is the
reference's self-contained Nelder-Mead (no scipy): its simplex stays in
numpy on the host. The objective generates every seed's market in one
`generate_markets` call on ``device`` and reads k through
`price_variability` there; the log-x interpolation at the target
fractions runs on the host, as in the reference (`repro.core.calibration`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.price_model import price_variability
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.energy.markets import (MarketDraws, MarketParams,
                                        generate_markets)


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

def k_opt_from_table(psi: float, x_opt: float, red: float) -> float:
    """Invert Eq. (28) at the optimum: the k that yields `red` at x_opt."""
    return (psi + 1.0) * (1.0 - (1.0 - red) * (1.0 - x_opt)) / x_opt


@dataclasses.dataclass(frozen=True)
class KTargets:
    """Target points (x_i, k_i) on the empirical k-x curve, with weights."""

    xs: tuple
    ks: tuple
    weights: tuple | None = None


def _device_of(prices, device: DeviceLike) -> torch.device:
    if device is None and isinstance(prices, torch.Tensor):
        return prices.device
    return resolve_device(device)


def interp_k(prices, xs: Sequence[float], *,
             device: DeviceLike = None) -> np.ndarray:
    """k(x) read off the empirical PV set by log-x interpolation. The PV
    set is computed on ``device`` (default: a tensor's own device, else
    cuda); the interpolation runs in float64 numpy on the host."""
    pv = price_variability(prices, device=_device_of(prices, device))
    x_grid = pv.x.cpu().numpy()
    k_grid = pv.k.cpu().numpy()
    return np.exp(np.interp(np.log(np.asarray(xs)),
                            np.log(x_grid), np.log(k_grid)))


def target_loss(prices, targets: KTargets, *,
                device: DeviceLike = None) -> float:
    k_hat = interp_k(prices, targets.xs, device=device)
    w = np.asarray(targets.weights) if targets.weights else \
        np.ones(len(targets.xs))
    err = np.log(k_hat) - np.log(np.asarray(targets.ks))
    return float(np.sum(w * err ** 2))


# ---------------------------------------------------------------------------
# Nelder-Mead (self-contained; no scipy available offline)
# ---------------------------------------------------------------------------

def nelder_mead(f: Callable[[np.ndarray], float], x0: np.ndarray,
                steps: np.ndarray, max_iter: int = 200,
                xtol: float = 1e-3) -> tuple[np.ndarray, float]:
    n = len(x0)
    simplex = [np.asarray(x0, dtype=np.float64)]
    for i in range(n):
        v = np.array(x0, dtype=np.float64)
        v[i] += steps[i]
        simplex.append(v)
    vals = [f(v) for v in simplex]

    for _ in range(max_iter):
        order = np.argsort(vals)
        simplex = [simplex[i] for i in order]
        vals = [vals[i] for i in order]
        if np.max([np.linalg.norm(s - simplex[0]) for s in simplex[1:]]) < xtol:
            break
        centroid = np.mean(simplex[:-1], axis=0)
        worst = simplex[-1]
        refl = centroid + (centroid - worst)
        f_refl = f(refl)
        if f_refl < vals[0]:
            expd = centroid + 2.0 * (centroid - worst)
            f_expd = f(expd)
            if f_expd < f_refl:
                simplex[-1], vals[-1] = expd, f_expd
            else:
                simplex[-1], vals[-1] = refl, f_refl
        elif f_refl < vals[-2]:
            simplex[-1], vals[-1] = refl, f_refl
        else:
            contr = centroid + 0.5 * (worst - centroid)
            f_contr = f(contr)
            if f_contr < vals[-1]:
                simplex[-1], vals[-1] = contr, f_contr
            else:  # shrink
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                    vals[i] = f(simplex[i])
    best = int(np.argmin(vals))
    return simplex[best], vals[best]


# ---------------------------------------------------------------------------
# market calibration
# ---------------------------------------------------------------------------

# Parameters exposed to the fit, with (log-space) bounds.
_FIT_FIELDS = ("spike_enter", "spike_stay", "spike_mu", "spike_sigma",
               "price_sens", "wind_sigma")
_LO = np.array([1e-5, 0.05, -1.5, 0.05, 0.2, 0.005])
_HI = np.array([0.20, 0.97, 3.50, 2.50, 6.0, 0.40])


def _theta_to_params(base: MarketParams, theta: np.ndarray) -> MarketParams:
    vals = _LO + (_HI - _LO) / (1.0 + np.exp(-theta))   # sigmoid box
    kw = {k: float(v) for k, v in zip(_FIT_FIELDS, vals)}
    kw["spike_mu"] = float(vals[2])                     # may be negative
    return base.replace(**kw)


def _params_to_theta(params: MarketParams) -> np.ndarray:
    vals = np.array([getattr(params, k) for k in _FIT_FIELDS])
    frac = np.clip((vals - _LO) / (_HI - _LO), 1e-4, 1 - 1e-4)
    return np.log(frac / (1 - frac))


def calibration_objective(base: MarketParams, targets: KTargets,
                          seeds: Sequence[int] = (0,), *,
                          draws: Optional[MarketDraws] = None,
                          device: DeviceLike = None
                          ) -> Callable[[np.ndarray], float]:
    """`calibrate_market`'s objective: theta -> the loss averaged over
    ``seeds``, or 1e6 where a seed's market has a mean price <= 0 (the
    reference's guard). Every seed's market is generated in one
    `generate_markets` call on ``device``; ``draws`` ([len(seeds),
    n_hours] each) replaces the seeds' own `market_draws` (the parity
    tests inject the reference's)."""
    dev = resolve_device(device)
    seeds = [int(s) for s in seeds]

    def objective(theta: np.ndarray) -> float:
        params = _theta_to_params(base, theta)
        prices = generate_markets([params.replace(seed=s) for s in seeds],
                                  draws=draws, device=dev).prices
        if bool((prices.mean(dim=1) <= 0).any()):
            return 1e6
        tot = 0.0
        for row in prices:
            tot += target_loss(row, targets)
        return tot / len(seeds)
    return objective


def calibrate_market(base: MarketParams, targets: KTargets,
                     max_iter: int = 120,
                     seeds: Sequence[int] = (0,), *,
                     device: DeviceLike = None
                     ) -> tuple[MarketParams, float]:
    """Fit spike/volatility parameters so the generated series hits the
    (x, k) targets. Averages the loss over ``seeds`` for robustness; the
    markets are generated on ``device`` (default cuda)."""
    objective = calibration_objective(base, targets, seeds, device=device)
    theta0 = _params_to_theta(base)
    theta, loss = nelder_mead(objective, theta0,
                              steps=0.7 * np.ones(len(theta0)),
                              max_iter=max_iter)
    return _theta_to_params(base, theta), loss
