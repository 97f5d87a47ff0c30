"""Runtime support: online cost accounting (`CostMeter`), the
energy-aware scheduler that re-estimates the paper's shutdown plan from
a live price window (`EnergyAwareScheduler`, `SchedulerConfig`), and the
elastic-capacity arithmetic behind `repro_torch.fleet.grid.elastic_policy`
(`repro_torch.runtime.elastic`). The trainer comes with the training
slice."""

from repro_torch.runtime.accounting import CostMeter
from repro_torch.runtime.scheduler import (EnergyAwareScheduler,
                                           SchedulerConfig)

__all__ = ["CostMeter", "EnergyAwareScheduler", "SchedulerConfig"]
