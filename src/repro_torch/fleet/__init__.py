"""Fleet-scale backtesting: thousands of (market x system x policy)
scenario simulations in one pass.

  grid    — ScenarioGrid builder: N markets x M systems x K policies
            stacked into B = N*M*K scenario rows
  engine  — `backtest(grid) -> FleetReport`: batched hysteresis scan over
            rows and hours (the CUDA fleet_scan kernel on the card)
  report  — per-row CPC/TCO plus fleet summaries: best policy per market,
            regret vs the closed-form oracle, fleet totals
"""

from repro_torch.fleet.engine import backtest
from repro_torch.fleet.grid import (PolicySpec, ScenarioGrid, build_grid,
                                    elastic_policy, grid_from_numpy)
from repro_torch.fleet.report import FleetReport, FleetSummary, summarize

__all__ = ["PolicySpec", "ScenarioGrid", "build_grid", "elastic_policy",
           "grid_from_numpy", "backtest", "FleetReport", "FleetSummary",
           "summarize"]
