"""Online TCO / CPC accounting — the paper's model, measured instead of
assumed.

``CostMeter`` integrates, hour by simulated hour, exactly the quantities the
closed-form model predicts in aggregate:

    fixed cost  F/T per hour, accrued whether or not the system runs
    energy cost C * price while running (+ idle draw while suspended,
                + restart energy per resume — the §V-A costs the paper
                deliberately excludes, so predicted vs realised CPC
                quantifies that bias)
    uptime      compute-hours actually delivered

so realised CPC = (F_accrued + E_accrued) / uptime is directly comparable
with ``repro_torch.core.tco.cpc_with_shutdowns`` and the predicted
reduction of ``optimal_shutdown``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CostMeter:
    """Integrates costs over simulated hours."""

    power_mw: float                 # C: full-operation draw [MW]
    fixed_cost_per_hour: float      # F / T [EUR/h]
    idle_power_frac: float = 0.0    # residual draw while suspended

    hours: float = 0.0
    uptime_hours: float = 0.0
    fixed_cost: float = 0.0
    energy_cost: float = 0.0
    energy_mwh: float = 0.0
    restart_energy_cost: float = 0.0
    restarts: int = 0
    shutdowns: int = 0
    # the always-on counterfactual, integrated on the same prices
    ao_energy_cost: float = 0.0

    def tick(self, hours: float, price: float, *, running: bool,
             load: float = 1.0) -> None:
        """Account ``hours`` of operation (or suspension) at ``price``.
        ``load``: fraction of full power drawn while running (partial
        capacity, e.g. a serving engine with some slots gated off)."""
        self.hours += hours
        self.fixed_cost += self.fixed_cost_per_hour * hours
        draw = self.power_mw * (load if running else self.idle_power_frac)
        mwh = draw * hours
        self.energy_mwh += mwh
        self.energy_cost += mwh * price
        self.ao_energy_cost += self.power_mw * hours * price
        if running:
            self.uptime_hours += hours

    def restart_event(self, price: float, energy_mwh: float,
                      lost_hours: float) -> None:
        """A resume: restart energy billed at the current price; the restart
        time is wall-clock during which fixed costs accrue but no compute is
        delivered (uptime not credited)."""
        self.restarts += 1
        cost = energy_mwh * price
        self.restart_energy_cost += cost
        self.energy_cost += cost
        self.energy_mwh += energy_mwh
        self.hours += lost_hours
        self.fixed_cost += self.fixed_cost_per_hour * lost_hours
        self.ao_energy_cost += self.power_mw * lost_hours * price

    def shutdown_event(self) -> None:
        self.shutdowns += 1

    # ------------------------------------------------------------------
    @property
    def tco(self) -> float:
        return self.fixed_cost + self.energy_cost

    @property
    def cpc(self) -> float:
        return self.tco / max(self.uptime_hours, 1e-9)

    @property
    def cpc_always_on(self) -> float:
        """Counterfactual CPC had the system never shut down (same
        prices, full uptime)."""
        return (self.fixed_cost + self.ao_energy_cost) / max(self.hours,
                                                             1e-9)

    @property
    def cpc_reduction(self) -> float:
        """Realised 1 - CPC/CPC_AO (the paper's Eq. 26, measured)."""
        ao = self.cpc_always_on
        return 1.0 - self.cpc / ao if ao > 0 else 0.0

    @property
    def realized_x(self) -> float:
        return 1.0 - self.uptime_hours / max(self.hours, 1e-9)

    def summary(self) -> dict:
        return {
            "hours": self.hours,
            "uptime_hours": self.uptime_hours,
            "x_realized": self.realized_x,
            "fixed_cost": self.fixed_cost,
            "energy_cost": self.energy_cost,
            "energy_mwh": self.energy_mwh,
            "restarts": self.restarts,
            "tco": self.tco,
            "cpc": self.cpc,
            "cpc_always_on": self.cpc_always_on,
            "cpc_reduction": self.cpc_reduction,
        }
