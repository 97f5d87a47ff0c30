"""Shutdown-plan optimisation — paper Eqs. (21)-(29) and the Psi sweep of
Fig. 5.

Given the empirical PV set of a price series and a system's Psi:

  x_BE   — break-even fraction: largest x with k(x) > Psi + 1 (Fig. 3)
  x_opt  — argmin_x CPC_WS(x) over the PV set          (Eqs. 21-25)
  CPC reduction at x_opt                               (Eqs. 26-29)

Every search runs over the full empirical PV set, one entry per sample.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.price_model import price_variability
from repro_torch.core.tco import cpc_ratio, cpc_reduction
from repro_torch.device import DeviceLike, as_tensor


class ShutdownPlan(NamedTuple):
    """The model's full recommendation for (prices, Psi)."""

    viable: torch.Tensor         # any x with k(x) > Psi+1 ?
    x_break_even: torch.Tensor   # largest beneficial x (0 if none)
    x_opt: torch.Tensor          # CPC-minimising shutdown fraction
    k_opt: torch.Tensor          # k at x_opt
    p_thresh: torch.Tensor       # threshold price at x_opt
    cpc_reduction: torch.Tensor  # 1 - CPC_WS/CPC_AO at x_opt (>=0)
    p_avg: torch.Tensor


def _psi(psi_val, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(psi_val, dtype=torch.float32, device=like.device)


def _break_even(pv, psi_val: torch.Tensor) -> torch.Tensor:
    # k is non-increasing in x, so `good` is a prefix and its length is
    # the index of the break-even fraction
    m_be = (pv.k > psi_val + 1.0).sum()
    x_be = pv.x[torch.clamp(m_be - 1, min=0)]
    return torch.where(m_be > 0, x_be, torch.zeros_like(x_be))


def break_even_fraction(prices, psi_val, *,
                        device: DeviceLike = None) -> torch.Tensor:
    """Largest x with k(x) > Psi + 1; 0.0 when no x qualifies."""
    pv = price_variability(prices, device=device)
    return _break_even(pv, _psi(psi_val, pv.k))


def optimal_shutdown(prices, psi_val, *,
                     device: DeviceLike = None) -> ShutdownPlan:
    """x_BE, x_opt = argmin CPC_WS over the PV set, and the CPC reduction
    at the optimum (x_opt = 0 with reduction 0 when no x improves CPC)."""
    p = as_tensor(prices, device)
    pv = price_variability(p, device=p.device)
    psi_t = _psi(psi_val, p)
    ratio = cpc_ratio(psi_t, pv.k, pv.x)        # CPC_WS/CPC_AO per x (Eq.28)
    i_opt = torch.argmin(ratio)
    best = ratio[i_opt]
    improves = best < 1.0
    zero = torch.zeros_like(pv.x[i_opt])
    return ShutdownPlan(
        viable=improves,
        x_break_even=_break_even(pv, psi_t),
        x_opt=torch.where(improves, pv.x[i_opt], zero),
        k_opt=torch.where(improves, pv.k[i_opt],
                          torch.full_like(pv.k[i_opt], float("nan"))),
        p_thresh=torch.where(improves, pv.p_thresh[i_opt],
                             torch.full_like(pv.p_thresh[i_opt],
                                             float("inf"))),
        cpc_reduction=torch.where(improves, 1.0 - best,
                                  torch.zeros_like(best)),
        p_avg=pv.p_avg[0],
    )


def psi_sweep(prices, psi_values, *, device: DeviceLike = None
              ) -> torch.Tensor:
    """Maximum theoretical CPC reduction per Psi value (Fig. 5); the
    Psi values form a batch dimension."""
    pv = price_variability(prices, device=device)
    psis = torch.as_tensor(psi_values, dtype=torch.float32,
                           device=pv.k.device).reshape(-1, 1)
    red = cpc_reduction(psis, pv.k[None, :], pv.x[None, :]).amax(1)
    return torch.clamp(red, min=0.0)
