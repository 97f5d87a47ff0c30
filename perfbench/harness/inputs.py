"""The inputs both sides get: prices from the seed, the systems and the
policies, from a configuration and a mix."""

from __future__ import annotations

import numpy as np
import torch

from harness import markets

POLICY_FIELDS = ("x", "p_off", "hysteresis", "off_level", "idle_frac",
                 "restart_energy_mwh", "restart_time_h")


def market_names(config: dict, mix: dict) -> list[str]:
    """Row n of the price block: market ``n // years``, year ``n %
    years``."""
    years = int(mix["years_per_market"])
    return [f"{m['name']}-{y}" for m in config["markets"]
            for y in range(years)]


def prices(config: dict, mix: dict, seed: int, device,
           hours: int | None = None) -> torch.Tensor:
    years = int(mix["years_per_market"])
    params = [m for m in config["markets"] for _ in range(years)]
    return markets.generate_prices(params, int(hours or config["hours"]),
                                   seed, device)


def systems(config: dict, hours: int | None = None) -> list[dict]:
    """Each system's fixed cost over the period (F = Psi T C p_avg,
    Eq. 18), rating and period in hours."""
    s = config["systems"]
    t = float(hours or config["hours"]) * float(config.get("dt_h", 1.0))
    return [{"name": n, "fixed": psi * t * s["power_mw"] * s["psi_p_avg"],
             "power": float(s["power_mw"]), "period": t}
            for n, psi in zip(s["names"], s["psi"])]


def port_systems(config: dict, hours: int | None = None) -> list:
    from repro_torch.core.tco import make_system
    return [make_system(s["fixed"], s["power"], s["period"], device="cpu")
            for s in systems(config, hours)]


def port_policies(specs: list[dict]) -> list:
    from repro_torch.fleet import PolicySpec
    return [PolicySpec(name=p["name"],
                       **{k: p[k] for k in POLICY_FIELDS if k in p})
            for p in specs]


def draw_policies(spec: dict, rng: np.random.Generator,
                  request: int) -> list[dict]:
    """One sweep request's policies: always-on first, then ``n_drawn``
    with x log-uniform in ``x_log_uniform``, a hysteresis setting and an
    idle fraction each drawn from the mix's lists, and one of them (drawn)
    at ``off_level_one``."""
    lo, hi = spec["x_log_uniform"]
    n = int(spec["n_drawn"])
    xs = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    hyst = rng.integers(len(spec["hysteresis"]), size=n)
    idle = rng.integers(len(spec["idle_frac"]), size=n)
    partial = int(rng.integers(n))
    out = [{"name": f"r{request}-always_on"}] if spec.get("always_on") \
        else []
    for i in range(n):
        p = {"name": f"r{request}-p{i}", "x": float(xs[i]),
             "idle_frac": float(spec["idle_frac"][idle[i]]),
             **spec["hysteresis"][hyst[i]]}
        if i == partial:
            p["off_level"] = float(spec["off_level_one"])
        out.append(p)
    return out
