"""Fault injection and graceful degradation for the fleet stack.

  trace  — declarative, seeded `FaultTrace` schedules (site outages,
           price-feed gaps, forecast blackouts, demand surges) compiled
           to dense per-hour `FaultMasks` (numpy, the reference's module
           as it is)
  inject — the masks flowing through the fleet backtest
           (`faulted_backtest`, tensor passes on the grid's device) and
           onto dispatch instances (`faulted_problem`)

The contract throughout: the healthy masks are exact arithmetic
identities, so a zero-fault run gives the un-faulted engines' results
bit for bit; storms are reproducible from a seed (`random_storm`); and
every injected fault leaves a ``fault.injected`` telemetry event behind
(`repro_torch.obs`). Graceful handling of the injected faults lives with
the engines themselves: `repro_torch.dispatch.Relief` prices shed,
`repro_torch.live` degrades its forecasts down a fallback ladder, and
`repro_torch.tune`'s guarded Adam rejects non-finite steps.
"""

from repro_torch.faults.inject import (emit_fault_events, faulted_backtest,
                                       faulted_problem, resolve_masks)
from repro_torch.faults.trace import (FAULT_KINDS, FaultEvent, FaultMasks,
                                      FaultTrace, identity_masks,
                                      random_storm)

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultMasks", "FaultTrace",
           "identity_masks", "random_storm", "emit_fault_events",
           "faulted_backtest", "faulted_problem", "resolve_masks"]
