"""Live fleet operator: batched rolling-horizon control under forecast
uncertainty.

Every offline result in this repo tunes and dispatches against a fully
known price year — perfect-foresight numbers the paper never qualifies.
This subsystem is the missing control plane: a receding-horizon
controller that each simulated hour (1) forecasts the next H hours from
the trailing published window (`repro_torch.energy.forecast`, batched),
(2) re-solves shutdown thresholds — and, via `repro_torch.live.fleet`,
cross-site dispatch — against the forecast at a configurable cadence,
and (3) realizes costs on the *true* trace, carrying on/off state,
dwell locks and restart overheads across the horizon boundary. The
outer loop runs over hours on the device, vectorized over thousands of
controller instances (forecaster x horizon x cadence x policy-family x
market grid rows), so a full controller-design sweep is one loop with
nothing read back to the host until it ends.

Two re-solve paths exist on purpose:

  * the in-loop **families** (`LiveGrid.family_id`): quantile
    re-resolution and a short warm-started Adam descent whose moments
    are carried from hour to hour — fully batched;
  * the host-level path `repro_torch.tune.optimize(warm_start=...)`, the
    full annealed tuner re-entered from the previous tick's solution —
    demonstrated by ``python -m repro_torch.examples.live_operator
    --retune``, for when one fleet's re-tune is worth a host round-trip
    per cadence tick.

Scoring (`summarize_live`) reports realized CPC, regret vs the
clairvoyant hindsight oracle and vs the offline-tuned policy, forecast
MAE/MASE attribution, and decision churn; every hourly decision lands
in the `repro_torch.obs` trace as ``live.step`` / ``live.result`` events.

  quickstart:  PYTHONPATH=src python -m repro_torch.examples.live_operator \
                   --smoke [--device cpu]
"""

from repro_torch.live.controller import (LiveConfig, LiveResult,
                                         live_backtest)
from repro_torch.live.fleet import LiveFleetResult, live_fleet_dispatch
from repro_torch.live.grid import (FAMILIES, FORECASTERS, LiveGrid,
                                   build_live_grid)
from repro_torch.live.report import (LiveSummary, hindsight_cpc,
                                     offline_cpc, summarize_live)

__all__ = ["FAMILIES", "FORECASTERS", "LiveConfig", "LiveFleetResult",
           "LiveGrid", "LiveResult", "LiveSummary", "build_live_grid",
           "hindsight_cpc", "live_backtest", "live_fleet_dispatch",
           "offline_cpc", "summarize_live"]
