"""Differentiable (temperature-relaxed) fleet scan.

`repro_torch.kernels.fleet_scan` prices a policy, but its thresholds enter
through comparisons, so they cannot be tuned by gradient descent. This
module relaxes the two-threshold hysteresis state machine with sigmoid
event gates at temperature ``tau``:

    a_t = sigmoid((p_on  - p_t) / tau)        turn-on strength
    b_t = sigmoid((p_t - p_off) / tau)        turn-off strength
    s_t = a_t + (1 - a_t)(1 - b_t) s_{t-1}    soft on-state in [0, 1]

As tau -> 0 the gates harden and s_t converges to `fleet_scan_ref`'s state
at every sample not exactly on a threshold. The recurrence is affine in
s_{t-1}; ``fused=False`` evaluates it as a log-depth doubling scan over
the composition of the affine maps, plain tensor code that autograd
differentiates (the native baseline), and ``fused=True`` (what
`repro_torch.tune` runs) uses the hand-written forward and backward of
`repro_torch.kernels.soft_scan_vjp`. Computation runs in the price dtype,
so float64 prices give float64 gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import FleetScanOut, soft_gates


def _prefix_affine(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Prefix of s_t = alpha_t s_{t-1} + beta_t along dim 1 (s_{-1} folded
    into beta_0) by log-depth doubling: zeros shifted in past the first
    hour terminate both the value and the running product."""
    s, prod = beta, alpha
    d, n = 1, alpha.shape[1]
    while d < n:
        s = s + prod * F.pad(s[:, :-d], (d, 0))
        prod = prod * F.pad(prod[:, :-d], (d, 0))
        d *= 2
    return s


def soft_state(prices: torch.Tensor, p_on, p_off, *, tau,
               fused: bool = False, block_t: int = 256) -> torch.Tensor:
    """Soft on-state trajectory s in [0, 1]^{B x T}.

    prices: [B, T]; p_on/p_off: [B] or scalars. The initial state is 1
    (running), as in `fleet_scan_ref`. ``fused=True`` routes through
    `repro_torch.kernels.soft_scan_vjp.soft_state_fused` (the kernels on
    the card); the default here is the native form, the autograd ground
    truth the fused path is tested against.
    """
    if fused:
        from repro_torch.kernels.soft_scan_vjp import soft_state_fused
        return soft_state_fused(prices, p_on, p_off, tau=tau,
                                block_t=block_t)
    dtype = torch.float64 if prices.dtype == torch.float64 \
        else torch.float32
    p = prices.to(dtype)
    b = p.shape[0]
    p_on, p_off = (torch.as_tensor(v, device=p.device).to(dtype).expand(b)
                   for v in (p_on, p_off))
    inv_tau = 1.0 / torch.as_tensor(tau, device=p.device).to(dtype)
    _, _, alpha, beta = soft_gates(p, p_on[:, None], p_off[:, None],
                                   inv_tau)                     # [B, T]
    beta = torch.cat([beta[:, :1] + alpha[:, :1], beta[:, 1:]], dim=1)
    return _prefix_affine(alpha, beta)                          # s0 = 1


def soft_scan_parts(prices: torch.Tensor, p_on, p_off, off_level, idle_frac,
                    *, tau, fused: bool = False, block_t: int = 256
                    ) -> tuple[FleetScanOut, torch.Tensor, torch.Tensor]:
    """(FleetScanOut, per-sample draw [B, T], capacity [B, T]) of the
    relaxed scan. The draw trajectory is what the fleet power-cap penalty
    integrates; `soft_fleet_scan` discards both trajectories."""
    dtype = torch.float64 if prices.dtype == torch.float64 \
        else torch.float32
    p = prices.to(dtype)
    b = p.shape[0]
    off_level, idle_frac = (torch.as_tensor(v, device=p.device).to(dtype)
                            .expand(b) for v in (off_level, idle_frac))
    s = soft_state(p, p_on, p_off, tau=tau, fused=fused,
                   block_t=block_t)                             # [B, T]
    s_prev = torch.cat([torch.ones((b, 1), dtype=dtype, device=p.device),
                        s[:, :-1]], dim=1)
    starts = s * (1.0 - s_prev)           # smooth 0->1 transition mass
    cap = off_level[:, None] + (1.0 - off_level[:, None]) * s
    draw = cap + idle_frac[:, None] * (1.0 - cap)
    return FleetScanOut(
        draw_price_sum=torch.sum(draw * p, dim=1),
        up_units=torch.sum(cap, dim=1),
        n_starts=torch.sum(starts, dim=1),
        restart_price_sum=torch.sum(starts * p, dim=1)), draw, cap


def soft_fleet_scan(prices: torch.Tensor, p_on, p_off, off_level, idle_frac,
                    *, tau, fused: bool = False, block_t: int = 256
                    ) -> FleetScanOut:
    """Differentiable counterpart of `repro_torch.kernels.fleet_scan`:
    the same `FleetScanOut` sums, smooth in every input at temperature
    ``tau``, converging to the hard scan as tau -> 0."""
    return soft_scan_parts(prices, p_on, p_off, off_level, idle_frac,
                           tau=tau, fused=fused, block_t=block_t)[0]
