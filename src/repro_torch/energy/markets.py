"""Structural synthetic electricity-market generator.

Price formation follows the merit-order intuition the paper leans on
(Fig. 1): price ~ f(net load) where net load = demand - renewables.
Components:

  demand      diurnal double-peak + seasonal + weekday/weekend profile
  solar       clear-sky diurnal bell * seasonal * cloud AR process
  wind        slow AR(1) process (multi-day autocorrelation)
  residual    fast AR(1) price noise
  spikes      two-state Markov regime ("doldrums": low wind + peak demand)
              with lognormal multiplicative magnitude
  negatives   renewable-surplus hours can push prices below zero

The generator is split in two. `market_draws` makes the five standard
random tensors (`MarketDraws`) from a CPU `torch.Generator` seeded with
``params.seed`` and copies them to the target device; everything else is
deterministic shaping of those draws, so a caller can pass its own
``draws=`` (the parity tests pass the JAX reference's). The same seed
gives other draws than `jax.random`, but the same draws on the CPU and on
the card.

The three AR(1) recurrences and the spike chain are sequential in time:
`generate_markets` runs one loop over T for all N markets at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MarketParams:
    """Parameters of one synthetic regional market (hourly resolution)."""

    n_hours: int = 8760
    p_avg: float = 80.0          # target mean price [EUR/MWh]; series is
                                 # rescaled to hit this exactly
    # demand shape (relative units; mean 1.0)
    diurnal_amp: float = 0.10    # morning/evening double peak
    seasonal_amp: float = 0.08   # winter > summer
    weekend_drop: float = 0.10
    # supply
    solar_share: float = 0.25    # midday solar depth relative to demand
    solar_seasonal: float = 0.5  # summer/winter solar asymmetry
    cloud_sigma: float = 0.25    # day-scale cloud AR innovations
    wind_share: float = 0.30
    wind_rho: float = 0.995      # ~multi-day autocorrelation at 1 h
    wind_sigma: float = 0.06
    # price formation
    price_sens: float = 1.4      # price response to net-load deviation
    noise_rho: float = 0.7
    noise_sigma: float = 0.05
    # spike regime (energy doldrums)
    spike_enter: float = 0.004   # P(calm -> spike) per hour
    spike_stay: float = 0.55     # P(spike persists) per hour
    spike_mu: float = 0.9        # lognormal magnitude of multiplier - 1
    spike_sigma: float = 0.7
    spike_cap: float = 40.0      # cap on the spike multiplier (market cap)
    # negative prices
    neg_sens: float = 1.2        # how hard renewable surplus pushes down
    seed: int = 0

    def replace(self, **kw) -> "MarketParams":
        return dataclasses.replace(self, **kw)


class MarketData(NamedTuple):
    prices: torch.Tensor     # [..., n_hours] EUR/MWh
    demand: torch.Tensor     # relative units (mean ~1)
    fossil: torch.Tensor     # generation volume (relative)
    renewable: torch.Tensor  # generation volume (relative)


class MarketDraws(NamedTuple):
    """The generator's random inputs, each [..., n_hours] float32."""

    cloud: torch.Tensor      # standard normal: cloud AR innovations
    wind: torch.Tensor       # standard normal: wind AR innovations
    noise: torch.Tensor      # standard normal: price-noise AR innovations
    spike_u: torch.Tensor    # uniform [0, 1): spike entry / persistence
    spike_mag: torch.Tensor  # standard normal: log spike magnitude


_THETA_FIELDS = ("p_avg", "diurnal_amp", "seasonal_amp", "weekend_drop",
                 "solar_share", "solar_seasonal", "cloud_sigma",
                 "wind_share", "wind_rho", "wind_sigma", "price_sens",
                 "noise_rho", "noise_sigma", "spike_enter", "spike_stay",
                 "spike_mu", "spike_sigma", "spike_cap", "neg_sens")
_CLOUD_RHO = 0.97


def market_draws(seed: int, n_hours: int, *,
                 device: DeviceLike = None) -> MarketDraws:
    """Draws of one market from a CPU `torch.Generator` seeded with
    ``seed``, copied to ``device``: one seed gives the same draws on every
    device (CUDA's Philox stream is not the CPU's), as the reference's
    draws are the same on every backend."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))

    def normal():
        return torch.randn(n_hours, generator=g)

    cloud, wind, noise = normal(), normal(), normal()
    spike_u = torch.rand(n_hours, generator=g)
    return MarketDraws(*(d.to(dev) for d in (cloud, wind, noise, spike_u,
                                             normal())))


def _ar1(innov: torch.Tensor, rho: torch.Tensor,
         scale: torch.Tensor) -> torch.Tensor:
    """Batched AR(1) s_t = rho s_{t-1} + scale * innov_t from s_{-1} = 0,
    one step per hour for every row. innov [R, T]; rho, scale [R]."""
    ce = (scale[:, None] * innov).T.contiguous()     # [T, R]
    out = torch.empty_like(ce)
    state = torch.zeros_like(rho)
    for t in range(ce.shape[0]):
        state = torch.addcmul(ce[t], rho, state, out=out[t])
    return out.T


def _spike_chain(enter: torch.Tensor, stay: torch.Tensor) -> torch.Tensor:
    """Two-state Markov regime from a calm start: spiking at t iff
    (spiking at t-1 and ``stay[t]``) or (calm at t-1 and ``enter[t]``).
    enter, stay: [N, T] bool -> [N, T] float32."""
    enter, stay = enter.T.contiguous(), stay.T.contiguous()
    out = torch.empty_like(enter)
    state = torch.zeros_like(enter[0])
    for t in range(enter.shape[0]):
        state = torch.where(state, stay[t], enter[t], out=out[t])
    return out.T.to(torch.float32)


def generate_market(params: MarketParams, *,
                    draws: Optional[MarketDraws] = None,
                    device: DeviceLike = None) -> MarketData:
    """One year (or ``n_hours``) of hourly market data, fields [n_hours]."""
    if draws is not None:
        draws = MarketDraws(*(d[None] for d in draws))
    data = generate_markets([params], draws=draws, device=device)
    return MarketData(*(v[0] for v in data))


def generate_markets(params: Sequence[MarketParams], *,
                     draws: Optional[MarketDraws] = None,
                     device: DeviceLike = None) -> MarketData:
    """N markets of equal length at once, fields [N, n_hours]. ``draws``
    ([N, n_hours] each) defaults to each market's own `market_draws`."""
    if len(params) == 0:
        raise ValueError("need at least one market")
    n_hours = params[0].n_hours
    if any(mp.n_hours != n_hours for mp in params):
        raise ValueError("all markets of one batch must share n_hours")
    dev = resolve_device(device)
    if draws is None:
        per = [market_draws(mp.seed, n_hours, device=dev) for mp in params]
        draws = MarketDraws(*(torch.stack(d) for d in zip(*per)))
    draws = MarketDraws(*(
        torch.as_tensor(d if isinstance(d, torch.Tensor) else np.array(d),
                        dtype=torch.float32, device=dev) for d in draws))
    if any(tuple(d.shape) != (len(params), n_hours) for d in draws):
        raise ValueError(f"draws must be [{len(params)}, {n_hours}] each")

    def theta(field):                                # [N, 1] float32
        return torch.tensor([float(getattr(mp, field)) for mp in params],
                            dtype=torch.float32, device=dev)[:, None]

    p = {f: theta(f) for f in _THETA_FIELDS}
    t = torch.arange(n_hours, device=dev)
    hour = t % 24
    day = t // 24
    doy = day % 365

    # --- demand ---------------------------------------------------------
    diurnal = (torch.exp(-0.5 * ((hour - 8.5) / 2.2) ** 2)
               + 1.15 * torch.exp(-0.5 * ((hour - 19.0) / 2.6) ** 2))
    diurnal = diurnal / diurnal.mean() - 1.0
    seasonal = torch.cos(2 * math.pi * (doy - 15) / 365.0)
    weekday = day % 7
    weekend = ((weekday == 5) | (weekday == 6)).to(torch.float32)
    demand = (1.0 + p["diurnal_amp"] * diurnal
              + p["seasonal_amp"] * seasonal
              - p["weekend_drop"] * weekend)

    # --- the three AR(1) processes, one loop over T for all of them -----
    n = len(params)
    rho = torch.cat([torch.full((n,), _CLOUD_RHO, dtype=torch.float32,
                                device=dev),
                     p["wind_rho"][:, 0], p["noise_rho"][:, 0]])
    one_minus_rho2 = torch.cat([
        torch.full((n,), 1 - _CLOUD_RHO ** 2, dtype=torch.float32,
                   device=dev),
        1 - p["wind_rho"][:, 0] ** 2, 1 - p["noise_rho"][:, 0] ** 2])
    sigma = torch.cat([p["cloud_sigma"], torch.ones_like(p["wind_rho"]),
                       p["noise_sigma"]])
    innov = sigma * torch.cat([draws.cloud, draws.wind, draws.noise])
    ar = _ar1(innov, rho, torch.sqrt(one_minus_rho2))
    cloud_ar, wind_lvl, noise = ar[:n], ar[n:2 * n], ar[2 * n:]

    # --- renewables ------------------------------------------------------
    sun = torch.clamp(torch.cos((hour - 13.0) / 24.0 * 2 * math.pi),
                      min=0.0) ** 1.5
    sun_season = 1.0 - p["solar_seasonal"] * torch.cos(
        2 * math.pi * (doy - 172) / 365.0)
    cloud = torch.clamp(1.0 + cloud_ar, 0.1, 1.6)
    solar = p["solar_share"] * 2.8 * sun * sun_season * cloud
    wind = p["wind_share"] * torch.clamp(
        1.0 + (1.4 / 0.06) * p["wind_sigma"] * wind_lvl, 0.02, 3.0)
    biomass = 0.08 * torch.ones_like(solar)
    renewable_raw = solar + wind + biomass

    # --- price formation --------------------------------------------------
    net_load = demand - renewable_raw
    net_dev = net_load - net_load.mean(1, keepdim=True)
    rel = 1.0 + p["price_sens"] * net_dev + noise

    # negative prices: when renewables exceed demand, push harder down
    surplus = torch.clamp(renewable_raw - demand, min=0.0)
    rel = rel - p["neg_sens"] * surplus

    # spike regime: two-state Markov chain with lognormal magnitude
    mag = torch.exp(p["spike_mu"] + p["spike_sigma"] * draws.spike_mag)
    mag = torch.minimum(mag, p["spike_cap"])
    spiking = _spike_chain(draws.spike_u < p["spike_enter"],
                           draws.spike_u < p["spike_stay"])
    spike_mult = spiking * mag
    # spikes multiply only positive prices (scarcity pricing)
    rel = torch.where(rel > 0, rel * (1.0 + spike_mult), rel)

    # scale to the exact target mean (k(x) is scale-invariant)
    mean_rel = rel.mean(1, keepdim=True)
    prices = rel * (p["p_avg"] / torch.clamp(mean_rel, min=1e-6))

    # generation volumes for Eq. (30): fossil fills residual net load
    fossil = torch.maximum(demand - renewable_raw, 0.03 * demand)
    return MarketData(prices=prices, demand=demand,
                      fossil=fossil, renewable=renewable_raw)


def diurnal_profile(data: MarketData) -> torch.Tensor:
    """Average price per hour-of-day (Fig. 1)."""
    p = data.prices
    n = (p.shape[-1] // 24) * 24
    return p[..., :n].reshape(*p.shape[:-1], -1, 24).mean(-2)
