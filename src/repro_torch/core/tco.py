"""TCO / CPC accounting — paper Section III(b), Eqs. (6)-(19).

Two fundamental policies over a period T with full-power draw C:

  Always-On        E_AO = T * C * p_avg                       (Eq. 6)
  With-Shutdowns   E_WS = T * C * p_avg * (1 - k*x)           (Eq. 9)

  CPC_AO = (F + E_AO) / T                                     (Eq. 11)
  CPC_WS = (F + E_WS) / ((1-x) * T)                           (Eq. 13)

and shutdowns are beneficial iff k > Psi + 1, Psi = F / E_AO (Eq. 19),
independent of x. The formulas are plain arithmetic: they take tensors or
Python numbers and broadcast.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device


class SystemCosts(NamedTuple):
    """Static description of a compute system's cost structure (Table I)."""

    fixed: torch.Tensor   # F  [currency] over the period T
    power: torch.Tensor   # C  [MW] draw under full operation
    period: torch.Tensor  # T  [hours]

    @property
    def F(self):  # noqa: N802 - paper notation
        return self.fixed

    @property
    def C(self):  # noqa: N802
        return self.power

    @property
    def T(self):  # noqa: N802
        return self.period


def make_system(fixed: float, power: float, period: float, *,
                device: DeviceLike = None) -> SystemCosts:
    dev = resolve_device(device)
    return SystemCosts(*(torch.tensor(float(v), dtype=torch.float32,
                                      device=dev)
                         for v in (fixed, power, period)))


def energy_cost_always_on(sys: SystemCosts, p_avg):
    """E_AO = T * C * p_avg  (Eq. 6)."""
    return sys.T * sys.C * p_avg


def energy_cost_with_shutdowns(sys: SystemCosts, p_avg, k, x):
    """E_WS = T * C * p_avg * (1 - k x)  (Eq. 9)."""
    return sys.T * sys.C * p_avg * (1.0 - k * x)


def cpc_always_on(sys: SystemCosts, p_avg):
    """CPC_AO = (F + E_AO) / T  (Eq. 11)."""
    return (sys.F + energy_cost_always_on(sys, p_avg)) / sys.T


def cpc_with_shutdowns(sys: SystemCosts, p_avg, k, x):
    """CPC_WS = (F + E_WS) / ((1-x) T)  (Eq. 13)."""
    return (sys.F + energy_cost_with_shutdowns(sys, p_avg, k, x)) \
        / ((1.0 - x) * sys.T)


def psi(sys: SystemCosts, p_avg):
    """Cost-distribution coefficient Psi = F / E_AO  (Eq. 18)."""
    return sys.F / energy_cost_always_on(sys, p_avg)


def cpc_ratio(psi_val, k, x):
    """CPC_WS / CPC_AO in the dimensionless form of Eq. (28):

        ratio = (Psi + 1 - k x) / ((Psi + 1) (1 - x))
    """
    return (psi_val + 1.0 - k * x) / ((psi_val + 1.0) * (1.0 - x))


def cpc_reduction(psi_val, k, x):
    """Relative CPC reduction of WS over AO, 1 - CPC_WS/CPC_AO (Eq. 26)."""
    return 1.0 - cpc_ratio(psi_val, k, x)


def shutdowns_viable(psi_val, k):
    """The paper's headline criterion: k > Psi + 1  (Eq. 19)."""
    return k > psi_val + 1.0
