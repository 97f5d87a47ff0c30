"""Scenario transforms — paper Section IV-C/IV-D.

`amplify_volatility` is Eq. (30): scale each non-negative price by the
instantaneous fossil share beta of generation,

    p~_i = p_i                                  if p_i <= 0
           p_i (1-beta_i)/2 + p_i beta_i 2      otherwise.

`scale_fixed_costs` models hardware-price shifts (Psi is linear in F).
"""

from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, as_tensor


def fossil_share(fossil, renewable, *,
                 device: DeviceLike = None) -> torch.Tensor:
    """beta_i = fossil_i / (fossil_i + renewable_i), 0.5 at zero output."""
    fossil = as_tensor(fossil, device)
    renewable = as_tensor(renewable, fossil.device)
    total = fossil + renewable
    return torch.where(total > 0, fossil / torch.clamp(total, min=1e-9),
                       torch.full_like(total, 0.5))


def amplify_volatility(prices, beta, *,
                       device: DeviceLike = None) -> torch.Tensor:
    """Eq. (30): fossil-share-driven price stretching."""
    p = as_tensor(prices, device)
    beta = torch.as_tensor(beta, dtype=p.dtype,
                           device=p.device).expand(p.shape)
    stretched = p * (1.0 - beta) / 2.0 + p * beta * 2.0
    return torch.where(p <= 0.0, p, stretched)


def scale_fixed_costs(psi_val, factor):
    """New Psi after scaling fixed costs by ``factor``: Psi' = factor*Psi."""
    return psi_val * factor
