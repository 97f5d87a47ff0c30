"""Seeded request-arrival traces and their conversion to MW of demand.

The arrival process is doubly-stochastic Poisson: a deterministic
diurnal base rate (cosine day shape peaking at ``peak_hour``) scaled by
one Gamma-distributed mixing draw per demand scenario (mean 1, variance
``overdispersion`` — the burstiness knob), then Poisson-sampled per
hour. ``sample_requests`` returns ``[n_draws, T]`` hourly request
volumes; every draw is an equally-likely realisation of the same
million-user service, and the fleet engines score each scenario row
against *all* draws so CPC becomes a distribution, not a point.

Requests become MW through the serving stack's own throughput
accounting: one engine serves ``tokens_per_engine_hour`` tokens per
hour (``ServeConfig.slots / hours_per_tick`` — the tick accounting of
`repro_torch.serving.engine` — via `Workload.from_serving`, or the
roofline decode rate of a real model config via `Workload.from_roofline`) and
draws ``engine_power_mw`` while doing it, so

    MW_t = requests_t * tokens_per_request
           / tokens_per_engine_hour * engine_power_mw.

A `Workload` is a frozen, hashable spec — valid inside
`repro_torch.tune.TuneConfig` — and the single object `ScenarioGrid` /
`DispatchConfig` / `TuneConfig` / `live_fleet_dispatch` accept. Deferral
and drop pricing (`deadline_h`, `queue_bound_mwh`, ``slo_penalty_eur_mwh``,
`repro_torch.dispatch.Relief` VoLL) parameterise the work ledger in
`repro_torch.workload.queue` / `repro_torch.kernels.queue_scan`.

The arrival draws are numpy's generator, as the reference's are, so one
seed gives the same requests bit for bit in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.dispatch.allocate import Relief

_HOURS_PER_DAY = 24.0


@dataclasses.dataclass(frozen=True)
class Workload:
    """Spec of a stochastic request workload and its SLO economics.

    Defaults describe a small interactive-inference service whose mean
    demand (~0.9 MW) is on the scale of one fleet row's rating: 2 req/s
    of 256-token requests against engines serving 1M tokens/hour at
    0.5 MW. All fields are scalars, so the spec is hashable
    (`TuneConfig`-compatible).
    """

    # arrival process
    base_rps: float = 2.0          # mean arrival rate, requests/second
    diurnal_amp: float = 0.6       # relative amplitude of the day cycle
    peak_hour: float = 17.0        # local hour of peak demand
    overdispersion: float = 0.25   # variance of the per-draw Gamma mixer
    n_draws: int = 32              # demand scenarios sampled per run
    seed: int = 0
    # request -> MW conversion (serving-stack throughput accounting)
    tokens_per_request: float = 256.0
    tokens_per_engine_hour: float = 1.0e6
    engine_power_mw: float = 0.5
    # queue / SLO economics
    deadline_h: int = 4            # extra hours work may wait, then drops
    queue_bound_mwh: float = 4.0   # backlog cap; overflow drops youngest
    slo_penalty_eur_mwh: float = 40.0   # per MWh-hour of deferred backlog
    relief: Relief = Relief()      # VoLL pricing of dropped work

    def __post_init__(self):
        if self.base_rps < 0 or self.overdispersion < 0:
            raise ValueError("Workload: base_rps and overdispersion "
                             "must be non-negative")
        if self.n_draws < 1:
            raise ValueError("Workload: n_draws must be >= 1")
        if self.deadline_h < 0 or self.queue_bound_mwh < 0:
            raise ValueError("Workload: deadline_h and queue_bound_mwh "
                             "must be non-negative")
        if self.tokens_per_engine_hour <= 0 or self.tokens_per_request < 0:
            raise ValueError("Workload: token throughput/size must be "
                             "positive")

    # -- conversion ---------------------------------------------------

    @property
    def mw_per_request_hour(self) -> float:
        """MW of engines needed to serve one request per hour."""
        return (self.tokens_per_request / self.tokens_per_engine_hour
                * self.engine_power_mw)

    def requests_to_mw(self, requests_per_hour):
        """Hourly request volumes -> MW of compute demand."""
        return np.asarray(requests_per_hour, np.float64) \
            * self.mw_per_request_hour

    # -- arrival process ----------------------------------------------

    def arrival_rate(self, t: int, demand_mult=None) -> np.ndarray:
        """Expected requests per hour, [T] — the diurnal intensity.

        ``demand_mult`` ([T], e.g. `repro_torch.faults.FaultMasks.demand_mult`
        from a ``demand_surge`` schedule) scales the intensity itself,
        so surges perturb the *arrival process*, not a finished profile.
        """
        h = np.arange(int(t), dtype=np.float64) % _HOURS_PER_DAY
        shape = 1.0 + self.diurnal_amp * np.cos(
            2.0 * np.pi * (h - self.peak_hour) / _HOURS_PER_DAY)
        lam = self.base_rps * 3600.0 * np.maximum(shape, 0.0)
        if demand_mult is not None:
            lam = lam * np.asarray(demand_mult, np.float64)
        return lam

    def sample_requests(self, t: int, demand_mult=None) -> np.ndarray:
        """``[n_draws, T]`` hourly request counts, seeded.

        Doubly-stochastic: one Gamma(1/od, od) mixing draw per scenario
        (mean 1, variance ``overdispersion``) multiplies the whole
        diurnal intensity, then each hour is Poisson — bursty days, not
        just bursty hours.
        """
        rng = np.random.default_rng(self.seed)
        lam = self.arrival_rate(t, demand_mult)
        if self.overdispersion > 0:
            k = 1.0 / self.overdispersion
            mix = rng.gamma(k, 1.0 / k, size=(self.n_draws, 1))
        else:
            mix = np.ones((self.n_draws, 1))
        return rng.poisson(mix * lam[None, :]).astype(np.float64)

    def mean_demand_mw(self, t: int, demand_mult=None) -> np.ndarray:
        """Deterministic expected demand profile, [T] MW.

        The duck-typed hook `repro_torch.dispatch.resolve_demand`,
        `soft_objective` and `live_fleet_dispatch` consume: E[mix] = 1,
        so this is the arrival intensity through the MW conversion.
        """
        return self.requests_to_mw(self.arrival_rate(t, demand_mult))

    def sample_demand_mw(self, t: int, demand_mult=None) -> np.ndarray:
        """``[n_draws, T]`` MW demand draws (requests through the
        serving-throughput conversion)."""
        return self.requests_to_mw(self.sample_requests(t, demand_mult))

    # -- constructors from the serving/launch stacks ------------------

    @classmethod
    def from_serving(cls, serve_cfg, **overrides) -> "Workload":
        """Derive the MW conversion from a `repro_torch.serving.ServeConfig`:
        one engine decodes ``slots`` tokens per ``hours_per_tick`` at
        ``power_mw`` — the exact tick accounting `ServingEngine.run`
        meters."""
        overrides.setdefault(
            "tokens_per_engine_hour",
            float(serve_cfg.slots) / float(serve_cfg.hours_per_tick))
        overrides.setdefault("engine_power_mw", float(serve_cfg.power_mw))
        return cls(**overrides)

    @classmethod
    def from_roofline(cls, model_cfg, *, batch: int = 128,
                      seq_len: int = 32_768, mfu: float = 0.4,
                      **overrides) -> "Workload":
        """Derive the MW conversion from a model's analytic decode rate:
        ``batch`` sequences decoding against a ``seq_len`` cache at
        ``mfu`` of one H100 SXM's dense bf16 peak
        (`repro_torch.launch.roofline.H100_SXM_BF16_FLOPS`; the reference
        takes its TPU's peak here)."""
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import roofline

        shape = ShapeSpec("workload_decode", seq_len, batch, "decode")
        # FLOPs of one decode step: ``batch`` tokens
        flops_per_step = roofline.model_flops(model_cfg, shape)
        tokens_per_s = (batch * roofline.H100_SXM_BF16_FLOPS * mfu
                        / flops_per_step)
        overrides.setdefault("tokens_per_engine_hour",
                             tokens_per_s * 3600.0)
        return cls(**overrides)
