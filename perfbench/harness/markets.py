"""Hourly electricity prices from the seed: a frozen copy of the port's
structural market equations (`repro_torch.energy.markets` as of the
benchmark's first version), with the random draws made on the device.

Demand (diurnal, seasonal, weekly), solar with an AR(1) cloud process,
wind as a slow AR(1), a fast AR(1) price noise, a two-state spike regime
with lognormal magnitudes and negative prices under renewable surplus;
each row is rescaled to its exact mean price ``p_avg``. The draws come
from one `torch.Generator` on the device seeded with the run's seed, in
five calls of [N, T] each, so the same seed gives the same prices on the
same device and no draw is made on the host.
"""

from __future__ import annotations

import math

import torch

THETA_FIELDS = ("p_avg", "diurnal_amp", "seasonal_amp", "weekend_drop",
                "solar_share", "solar_seasonal", "cloud_sigma",
                "wind_share", "wind_rho", "wind_sigma", "price_sens",
                "noise_rho", "noise_sigma", "spike_enter", "spike_stay",
                "spike_mu", "spike_sigma", "spike_cap", "neg_sens")
CLOUD_RHO = 0.97


def _ar1(innov: torch.Tensor, rho: torch.Tensor,
         scale: torch.Tensor) -> torch.Tensor:
    """s_t = rho s_{t-1} + scale innov_t from s_{-1} = 0, every row at
    once (innov [R, T]; rho, scale [R])."""
    ce = (scale[:, None] * innov).T.contiguous()
    out = torch.empty_like(ce)
    state = torch.zeros_like(rho)
    for t in range(ce.shape[0]):
        state = torch.addcmul(ce[t], rho, state, out=out[t])
    return out.T


def _spike_chain(enter: torch.Tensor, stay: torch.Tensor) -> torch.Tensor:
    """Spiking at t iff (spiking at t-1 and stay_t) or (calm and
    enter_t), from a calm start; [N, T] bool -> float32."""
    enter, stay = enter.T.contiguous(), stay.T.contiguous()
    out = torch.empty_like(enter)
    state = torch.zeros_like(enter[0])
    for t in range(enter.shape[0]):
        state = torch.where(state, stay[t], enter[t], out=out[t])
    return out.T.to(torch.float32)


def generate_prices(params: list[dict], n_hours: int, seed: int,
                    device: torch.device) -> torch.Tensor:
    """[N, n_hours] float32 prices, one row per entry of ``params`` (each
    a dict of the `THETA_FIELDS`), drawn from ``seed`` on ``device``."""
    n = len(params)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    shape = (n, n_hours)
    cloud = torch.randn(shape, generator=gen, device=dev)
    wind = torch.randn(shape, generator=gen, device=dev)
    noise = torch.randn(shape, generator=gen, device=dev)
    spike_u = torch.rand(shape, generator=gen, device=dev)
    spike_mag = torch.randn(shape, generator=gen, device=dev)

    def theta(field):
        return torch.tensor([float(p[field]) for p in params],
                            dtype=torch.float32, device=dev)[:, None]

    p = {f: theta(f) for f in THETA_FIELDS}
    t = torch.arange(n_hours, device=dev)
    hour, day = t % 24, t // 24
    doy = day % 365
    diurnal = (torch.exp(-0.5 * ((hour - 8.5) / 2.2) ** 2)
               + 1.15 * torch.exp(-0.5 * ((hour - 19.0) / 2.6) ** 2))
    diurnal = diurnal / diurnal.mean() - 1.0
    seasonal = torch.cos(2 * math.pi * (doy - 15) / 365.0)
    weekday = day % 7
    weekend = ((weekday == 5) | (weekday == 6)).to(torch.float32)
    demand = (1.0 + p["diurnal_amp"] * diurnal
              + p["seasonal_amp"] * seasonal - p["weekend_drop"] * weekend)

    rho = torch.cat([torch.full((n,), CLOUD_RHO, device=dev),
                     p["wind_rho"][:, 0], p["noise_rho"][:, 0]])
    one_minus_rho2 = torch.cat([
        torch.full((n,), 1 - CLOUD_RHO ** 2, device=dev),
        1 - p["wind_rho"][:, 0] ** 2, 1 - p["noise_rho"][:, 0] ** 2])
    sigma = torch.cat([p["cloud_sigma"], torch.ones_like(p["wind_rho"]),
                       p["noise_sigma"]])
    ar = _ar1(sigma * torch.cat([cloud, wind, noise]), rho,
              torch.sqrt(one_minus_rho2))
    cloud_ar, wind_lvl, noise_ar = ar[:n], ar[n:2 * n], ar[2 * n:]

    sun = torch.clamp(torch.cos((hour - 13.0) / 24.0 * 2 * math.pi),
                      min=0.0) ** 1.5
    sun_season = 1.0 - p["solar_seasonal"] * torch.cos(
        2 * math.pi * (doy - 172) / 365.0)
    solar = (p["solar_share"] * 2.8 * sun * sun_season
             * torch.clamp(1.0 + cloud_ar, 0.1, 1.6))
    wind_gen = p["wind_share"] * torch.clamp(
        1.0 + (1.4 / 0.06) * p["wind_sigma"] * wind_lvl, 0.02, 3.0)
    renewable = solar + wind_gen + 0.08

    net_load = demand - renewable
    rel = (1.0 + p["price_sens"] * (net_load - net_load.mean(1, keepdim=True))
           + noise_ar)
    rel = rel - p["neg_sens"] * torch.clamp(renewable - demand, min=0.0)
    mag = torch.minimum(torch.exp(p["spike_mu"] + p["spike_sigma"]
                                  * spike_mag), p["spike_cap"])
    spiking = _spike_chain(spike_u < p["spike_enter"],
                           spike_u < p["spike_stay"])
    rel = torch.where(rel > 0, rel * (1.0 + spiking * mag), rel)
    mean_rel = rel.mean(1, keepdim=True)
    return (rel * (p["p_avg"] / torch.clamp(mean_rel, min=1e-6))).contiguous()
