"""The paper's contribution: a TCO model for variable-capacity computing.

Closed-form (the paper's Eqs. 1-29) functions on torch tensors; the fleet
engine in `repro_torch.fleet` acts on its decisions.
"""

from repro_torch.core.price_model import (
    PriceStats,
    price_stats,
    price_variability,
    threshold_price,
    region_means,
    resample,
)
from repro_torch.core.tco import (
    SystemCosts,
    make_system,
    energy_cost_always_on,
    energy_cost_with_shutdowns,
    cpc_always_on,
    cpc_with_shutdowns,
    cpc_ratio,
    cpc_reduction,
    psi,
    shutdowns_viable,
)
from repro_torch.core.optimizer import (
    ShutdownPlan,
    break_even_fraction,
    optimal_shutdown,
    psi_sweep,
)
from repro_torch.core.scenarios import (
    amplify_volatility,
    scale_fixed_costs,
)
from repro_torch.core.policy import (
    threshold_policy,
    hysteresis_policy,
    policy_energy_cost,
    policy_cpc,
    shutdown_cost_adjusted_viability,
)

__all__ = [
    "PriceStats",
    "price_stats",
    "price_variability",
    "threshold_price",
    "region_means",
    "resample",
    "SystemCosts",
    "make_system",
    "energy_cost_always_on",
    "energy_cost_with_shutdowns",
    "cpc_always_on",
    "cpc_with_shutdowns",
    "cpc_ratio",
    "cpc_reduction",
    "psi",
    "shutdowns_viable",
    "ShutdownPlan",
    "break_even_fraction",
    "optimal_shutdown",
    "psi_sweep",
    "amplify_volatility",
    "scale_fixed_costs",
    "threshold_policy",
    "hysteresis_policy",
    "policy_energy_cost",
    "policy_cpc",
    "shutdown_cost_adjusted_viability",
]
