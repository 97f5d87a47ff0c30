"""The tuner's relaxed objective and its first Adam steps, plainly.

Each row tunes three unconstrained variables, mapped onto the feasible
set as the port documents it (`repro_torch.tune.objective`):

    p_off = raw_off,  p_on = p_off - softplus(raw_gap),
    off_level = (1 - 1e-6) sigmoid(raw_lvl)

The hard state machine is relaxed at temperature tau:

    a_t = sigmoid((p_on - p_t) / tau),  f_t = sigmoid((p_t - p_off) / tau)
    s_t = a_t + (1 - a_t)(1 - f_t) s_{t-1},  s_{-1} = 1

starts count as s_t (1 - s_{t-1}), and the costs are the hard backtest's
over the relaxed sums. The loss sums every row's CPC / CPC_AO (plus the
fleet's dispatched term where coupled, `reference.dispatch`), and each
row descends it by Adam (lr 0.5, betas 0.9 / 0.999, eps 1e-8) while tau
anneals geometrically from ``tau_start`` to ``tau_end``. Here the
recurrence runs as a log-depth doubling scan that autograd
differentiates, in the dtype asked for.
"""

from __future__ import annotations

import torch

LVL_SCALE = 1.0 - 1e-6


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def transform(raw: dict) -> dict:
    """Raw variables -> (p_on, p_off, off_level), in the raw dtype."""
    p_off = raw["off"]
    return {"p_on": p_off - softplus(raw["gap"]), "p_off": p_off,
            "off_level": LVL_SCALE * (1.0 / (1.0 + torch.exp(-raw["lvl"])))}


def initial_raw(p_on, p_off, off_level, p_max, *, gap_min: float = 1e-3,
                lvl_eps: float = 1e-4) -> dict:
    """Raw variables of swept policies ([B] each, float64 maths rounded
    once to float32): an always-on row (p_off = inf) starts at its
    market's highest price, a zero gap at ``gap_min`` and an off level
    of 0 at ``lvl_eps``."""
    p_off = p_off.double()
    inf = ~torch.isfinite(p_off)
    p_off = torch.where(inf, p_max.double(), p_off)
    p_on = torch.where(inf, p_max.double(), p_on.double())
    gap = torch.clamp(p_off - p_on, min=gap_min)
    raw_gap = torch.where(gap > 20.0, gap + torch.log1p(-torch.exp(-gap)),
                          torch.log(torch.expm1(gap)))
    lvl = torch.clamp(off_level.double(), lvl_eps, 1.0 - lvl_eps)
    return {"off": p_off.float(), "gap": raw_gap.float(),
            "lvl": torch.log(lvl / (1.0 - lvl)).float()}


def tau_schedule(steps: int, tau_start: float, tau_end: float,
                 device) -> torch.Tensor:
    """[steps] float32 geometric anneal (the schedule is an input of the
    tuner, stated in float32)."""
    if steps == 1:
        return torch.tensor([tau_start], dtype=torch.float32, device=device)
    i = torch.arange(steps, dtype=torch.float32, device=device) / (steps - 1)
    return tau_start * (tau_end / tau_start) ** i


def _affine_prefix(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """s_t = alpha_t s_{t-1} + beta_t along dim 1 with s_{-1} folded into
    beta_0, by doubling: each level composes a map with the one ``d``
    hours before it; zeros shifted in end the composition."""
    s, prod = beta, alpha
    d, n = 1, alpha.shape[1]
    while d < n:
        s = s + prod * torch.nn.functional.pad(s[:, :-d], (d, 0))
        prod = prod * torch.nn.functional.pad(prod[:, :-d], (d, 0))
        d *= 2
    return s


def soft_sums(p: torch.Tensor, p_on, p_off, off_level, idle_frac, tau):
    """Relaxed sums over p [R, T] (all in p's dtype): ``draw_price``,
    ``up_units``, ``starts``, ``restart_price`` [R] and the capacity
    trajectory [R, T]."""
    inv_tau = 1.0 / tau
    a = torch.sigmoid((p_on[:, None] - p) * inv_tau)
    f = torch.sigmoid((p - p_off[:, None]) * inv_tau)
    alpha, beta = (1.0 - a) * (1.0 - f), a
    beta = torch.cat([beta[:, :1] + alpha[:, :1], beta[:, 1:]], dim=1)
    s = _affine_prefix(alpha, beta)
    s_prev = torch.cat([torch.ones_like(s[:, :1]), s[:, :-1]], dim=1)
    starts = s * (1.0 - s_prev)
    lvl, idle = off_level[:, None], idle_frac[:, None]
    cap = lvl + (1.0 - lvl) * s
    draw = cap + idle * (1.0 - cap)
    return {"draw_price": (draw * p).sum(1), "up_units": cap.sum(1),
            "starts": starts.sum(1), "restart_price": (starts * p).sum(1)}, cap


def row_ratio(raw: dict, rows: dict, p: torch.Tensor, tau):
    """Per-row CPC / CPC_AO of the relaxed scan and the capacity
    trajectory; ``rows`` holds the [R] hardware and cost fields."""
    ph = transform(raw)
    sums, cap = soft_sums(p, ph["p_on"], ph["p_off"], ph["off_level"],
                          rows["idle_frac"], tau)
    dt = rows["period"] / p.shape[1]
    e_run = dt * rows["power"] * sums["draw_price"]
    e_restart = rows["restart_energy_mwh"] * sums["restart_price"]
    up = dt * sums["up_units"] - rows["restart_time_h"] * sums["starts"]
    cpc = (rows["fixed"] + e_run + e_restart) / torch.clamp(up, min=1e-9)
    cpc_ao = (rows["fixed"] + dt * rows["power"] * rows["price_sum"]) \
        / rows["period"]
    return cpc / cpc_ao, cap


class Adam:
    """Per-row Adam with the step count shared, in the parameters'
    dtype."""

    def __init__(self, raw: dict, lr: float = 0.5, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in raw.items()}
        self.v = {k: torch.zeros_like(v) for k, v in raw.items()}
        self.k = 0

    def step(self, raw: dict, grads: dict) -> dict:
        self.k += 1
        c1, c2 = 1.0 - self.b1 ** self.k, 1.0 - self.b2 ** self.k
        out = {}
        for key, g in grads.items():
            self.m[key] = self.b1 * self.m[key] + (1 - self.b1) * g
            self.v[key] = self.b2 * self.v[key] + (1 - self.b2) * g * g
            out[key] = raw[key] - self.lr * (self.m[key] / c1) / (
                torch.sqrt(self.v[key] / c2) + self.eps)
        return out
