"""Differentiable policy tuning: gradient-optimize shutdown policies over
the whole fleet grid.

The two-threshold hysteresis state machine is relaxed with
temperature-``tau`` sigmoid gates (`repro_torch.kernels.soft_scan`, with
hand-written CUDA kernels for its forward and backward on the card),
per-row policy variables are reparameterized onto the feasible set
(`objective`), and an Adam loop over all B rows (`optimizer`, on
`repro_torch.optim.adamw`) descends each row's CPC/CPC_AO ratio while
annealing tau toward the hard scan. The result is re-evaluated hard and
is never worse than the best swept policy of the row's (market, system)
cell when the hardware parameters are uniform within the cell. With
``Coupling(dispatch=...)`` the objective also differentiates through the
relaxed cross-site water-fill (`repro_torch.kernels.soft_dispatch`), so
sites learn their fleet role; ``ExecutionPlan(mode="sharded")`` tunes
such a coupled fleet with its rows split over the ranks of a
`torch.distributed` process group.

  quickstart:  PYTHONPATH=src python -m repro_torch.examples.tune_policies
"""

from repro_torch.execution import Coupling, ExecutionPlan
from repro_torch.tune.objective import (DispatchCoupling, PhysicalPolicy,
                                        PolicyParams, TuneProblem,
                                        cell_index,
                                        dispatch_coupling_from_grid,
                                        dispatch_coupling_from_numpy,
                                        init_from_grid, inverse_transform,
                                        problem_from_grid, soft_costs,
                                        soft_dispatch_ratio, soft_objective,
                                        transform)
from repro_torch.tune.optimizer import (TuneConfig, TuneResult,
                                        cell_best_rows, hard_cpc, optimize,
                                        sharded_soft_objective, tune_loop,
                                        tune_loop_checkpointed)

__all__ = ["Coupling", "DispatchCoupling", "ExecutionPlan",
           "PhysicalPolicy", "PolicyParams", "TuneProblem", "TuneConfig",
           "TuneResult", "cell_best_rows", "cell_index",
           "dispatch_coupling_from_grid", "dispatch_coupling_from_numpy",
           "hard_cpc", "init_from_grid",
           "inverse_transform", "problem_from_grid", "soft_costs",
           "sharded_soft_objective", "soft_dispatch_ratio",
           "soft_objective", "transform", "optimize", "tune_loop",
           "tune_loop_checkpointed"]
