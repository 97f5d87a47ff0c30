"""The scenario rows, plainly: N markets x M systems x K policies, row
b = (n M + m) K + k, each row's hardware and policy fields."""

from __future__ import annotations

import torch

from reference.fleet import policy_thresholds


def rows(prices: torch.Tensor, systems: list[dict], policies: list[dict],
         dtype: torch.dtype) -> dict:
    """[B] fields of every row in ``dtype`` (``market``, ``system`` and
    ``policy`` indices int64), the float32 thresholds ``p_on`` /
    ``p_off`` [B] and each market's ``price_sum`` and ``p_max`` [N]."""
    n, m, k = prices.shape[0], len(systems), len(policies)
    dev = prices.device
    b = torch.arange(n * m * k, device=dev)
    market, system, policy = b // (m * k), (b // k) % m, b % k

    def field(items, key, idx, default=0.0):
        return torch.tensor([float(it.get(key, default)) for it in items],
                            dtype=dtype, device=dev)[idx]

    on_nk, off_nk = policy_thresholds(prices, policies, dtype)
    p64 = prices.to(dtype)
    return {
        "market": market, "system": system, "policy": policy,
        "fixed": field(systems, "fixed", system),
        "power": field(systems, "power", system),
        "period": field(systems, "period", system),
        "off_level": field(policies, "off_level", policy),
        "idle_frac": field(policies, "idle_frac", policy),
        "restart_energy_mwh": field(policies, "restart_energy_mwh", policy),
        "restart_time_h": field(policies, "restart_time_h", policy),
        "p_on": on_nk[market, policy], "p_off": off_nk[market, policy],
        "market_price_sum": p64.sum(1), "market_p_max": prices.max(1).values,
    }
