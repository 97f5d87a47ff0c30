"""Feasible cross-site dispatch: allocate a fleet-wide compute demand
across sites hour by hour under *hard* constraints.

  schedule — materialised per-site shutdown schedules (the fleet state
             machine, hour by hour instead of summed)
  allocate — greedy water-fill over price-sorted capacity segments with
             migration costs and minimum-dwell locks; loud
             `DispatchInfeasible` on unmeetable constraints

The hot loop is `repro_torch.kernels.dispatch_scan` (a hand-written CUDA
kernel on the card, one block looping over the hours), bit for bit equal
to the plain `repro_torch.kernels.ref.dispatch_ref`.
`repro_torch.fleet.summarize` exposes the result as
`FleetSummary.dispatch`; `repro_torch.tune.optimize` re-scores tuned
policies on feasible dispatch under ``Coupling(reeval=...)``.
"""

from repro_torch.dispatch.allocate import (DispatchConfig,
                                           DispatchInfeasible,
                                           DispatchProblem, DispatchResult,
                                           Relief, build_problem,
                                           diurnal_demand, dispatch,
                                           resolve_demand, segment_keys,
                                           segment_rank, summarize_alloc)
from repro_torch.dispatch.schedule import capacity_series, on_state_series

__all__ = ["DispatchConfig", "DispatchInfeasible", "DispatchProblem",
           "DispatchResult", "Relief", "build_problem", "diurnal_demand",
           "dispatch", "resolve_demand", "segment_keys", "segment_rank",
           "summarize_alloc", "capacity_series", "on_state_series"]
