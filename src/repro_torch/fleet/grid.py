"""ScenarioGrid — materialise a B = N x M x K backtesting fleet.

N markets (synthetic `MarketParams` ensembles or raw price matrices),
M `SystemCosts` variants and K policy configurations are stacked into B
scenario rows that `repro_torch.fleet.engine.backtest` consumes in one
pass. Prices stay [N, T] (shared across systems and policies); every
per-row quantity is a [B] tensor.

Policies are operational: a two-threshold hysteresis state machine with
restart overheads, residual idle draw and a partial-shutdown capacity
level (paper §V-C via `repro_torch.runtime.elastic`). A policy given as a
shutdown fraction ``x`` is resolved against each market's own empirical
PV set (Eq. 1), so one spec yields a different threshold price per
market.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import execution
from repro_torch.core.tco import SystemCosts
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.energy.markets import MarketParams, generate_markets
from repro_torch.runtime.elastic import capacity_plan


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """One operational shutdown policy, shared across markets/systems.

    Exactly one of ``x`` (shutdown fraction, resolved per market) or
    ``p_off`` (absolute threshold price) may be set; ``x <= 0`` or
    ``p_off=None`` with ``x=None`` means always-on. ``hysteresis`` < 1
    resumes only once the price falls below ``hysteresis * p_off``
    (sign-safe for negative thresholds). ``off_level`` is the capacity
    fraction kept online while "off" (partial shutdown, §V-C);
    ``idle_frac`` the residual draw of the shut-down remainder.
    """

    name: str
    x: Optional[float] = None
    p_off: Optional[float] = None
    hysteresis: float = 1.0
    off_level: float = 0.0
    idle_frac: float = 0.0
    restart_energy_mwh: float = 0.0
    restart_time_h: float = 0.0

    def __post_init__(self):
        if self.x is not None and self.p_off is not None:
            raise ValueError(f"policy {self.name!r}: give x or p_off, "
                             "not both")
        if not 0.0 <= self.off_level < 1.0:
            raise ValueError(f"policy {self.name!r}: off_level must be "
                             "in [0, 1)")
        if self.x is not None and not 0.0 <= self.x < 1.0:
            raise ValueError(f"policy {self.name!r}: x is a shutdown "
                             "fraction and must be in [0, 1)")
        if not 0.0 < self.hysteresis <= 1.0:
            raise ValueError(f"policy {self.name!r}: hysteresis must be "
                             "in (0, 1] (p_on may not exceed p_off)")


def elastic_policy(name: str, *, level: float, dp_total: int,
                   **spec_kwargs) -> PolicySpec:
    """A partial-shutdown policy whose off-capacity is snapped to a
    realisable data-parallel fraction: keeping ``level`` of a
    ``dp_total``-replica job keeps ``capacity_plan(level, dp_total).level``
    of its power."""
    plan = capacity_plan(level, dp_total)
    return PolicySpec(name=name, off_level=plan.level, **spec_kwargs)


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """Stacked scenario rows, ordered b = (n*M + m)*K + k."""

    prices: torch.Tensor        # [N, T] float32 hourly prices, shared
    market_idx: torch.Tensor    # [B] int64 row -> market n
    system_idx: torch.Tensor    # [B] int64 row -> system m
    policy_idx: torch.Tensor    # [B] int64 row -> policy k
    fixed: torch.Tensor         # [B] F   (SystemCosts per row)
    power: torch.Tensor         # [B] C
    period: torch.Tensor        # [B] T hours
    p_on: torch.Tensor          # [B] resume-below price
    p_off: torch.Tensor         # [B] shutdown-above price
    off_level: torch.Tensor     # [B] capacity retained while off
    idle_frac: torch.Tensor     # [B] residual draw of the off part
    restart_energy_mwh: torch.Tensor  # [B]
    restart_time_h: torch.Tensor      # [B]
    market_names: tuple = ()
    system_names: tuple = ()
    policy_names: tuple = ()
    # optional `repro_torch.workload.Workload` spec (duck-typed): None
    # keeps every engine on the exogenous-demand path; set,
    # `workload_backtest` / `summarize` / `optimize` couple the rows to
    # sampled request traces
    workload: Optional[object] = None

    @property
    def n_rows(self) -> int:
        return int(self.market_idx.shape[0])

    @property
    def n_markets(self) -> int:
        return int(self.prices.shape[0])

    @property
    def n_systems(self) -> int:
        return len(self.system_names)

    @property
    def n_policies(self) -> int:
        return len(self.policy_names)

    @property
    def n_hours(self) -> int:
        return int(self.prices.shape[1])

    # fields shared across rows, NOT permuted by take_rows; everything
    # else must be a [B]-leading tensor or take_rows refuses to guess
    SHARED_FIELDS = ("prices", "market_names", "system_names",
                     "policy_names", "workload")

    def take_rows(self, order: np.ndarray) -> "ScenarioGrid":
        """Row-permuted view (shared fields stay); row order is an
        implementation detail the report layer must not depend on."""
        return execution.take_rows(self, order, shared=self.SHARED_FIELDS,
                                   n_rows=self.n_rows)

    def to(self, device: DeviceLike) -> "ScenarioGrid":
        """The same grid with every tensor on ``device``."""
        dev = torch.device(device)
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(dev) for name in TENSOR_FIELDS})


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(ScenarioGrid)
                      if f.type == "torch.Tensor")


def row_chunks(n_rows: int, chunk: int) -> list[np.ndarray]:
    """Equal-size row-index slices covering ``n_rows``, the last padded
    by repeating row 0 (dropped again by `concat_rows`). Every per-row
    computation is independent of its batch, so padding rows cannot
    perturb the real ones."""
    n_chunks = -(-n_rows // chunk)
    idx = np.concatenate([np.arange(n_rows),
                          np.zeros(n_chunks * chunk - n_rows, np.int64)])
    return [idx[j * chunk:(j + 1) * chunk] for j in range(n_chunks)]


def concat_rows(parts: list, n_rows: int):
    """Concatenate per-chunk tensors, or NamedTuples of [chunk]-leading
    tensors, along the row axis and trim the `row_chunks` padding."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)[:n_rows]
    return type(first)(*(torch.cat(xs)[:n_rows] for xs in zip(*parts)))


def _thresholds(prices: torch.Tensor, policies: Sequence[PolicySpec]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, K] float32 (p_on, p_off): Eq. (1)'s quantile of each market for
    fraction specs, the given price for absolute specs, +inf for
    always-on. Resume thresholds are computed in float64 from the
    unrounded shutdown threshold, then rounded once to float32."""
    n, t = prices.shape
    sorted_desc = torch.sort(prices, dim=1, descending=True).values
    cols = []
    for spec in policies:
        if spec.x is not None and spec.x > 0.0:
            m = int(np.clip(round(spec.x * t), 1, t - 1))
            cols.append(sorted_desc[:, m - 1].to(torch.float64))
        else:
            off = np.inf if spec.p_off is None else float(spec.p_off)
            cols.append(torch.full((n,), off, dtype=torch.float64,
                                   device=prices.device))
    off = torch.stack(cols, 1)                                  # [N, K]
    backoff = torch.tensor([1.0 - s.hysteresis for s in policies],
                           dtype=torch.float64, device=prices.device)
    on = torch.where(torch.isfinite(off), off - backoff * off.abs(), off)
    return on.to(torch.float32), off.to(torch.float32)


def _row_indices(n: int, m: int, k: int, device: torch.device):
    b = torch.arange(n * m * k, device=device)
    return b // (m * k), (b // k) % m, b % k


def build_grid(markets: Union[Sequence[MarketParams], np.ndarray,
                              torch.Tensor],
               systems: Sequence[SystemCosts],
               policies: Sequence[PolicySpec],
               market_names: Optional[Sequence[str]] = None,
               system_names: Optional[Sequence[str]] = None,
               workload=None, *,
               device: DeviceLike = None) -> ScenarioGrid:
    """Materialise the B = N*M*K scenario grid on ``device``.

    ``markets``: either MarketParams (generated together by
    `repro_torch.energy.markets.generate_markets`) or an [N, T] price
    matrix. All markets share T; all systems are backtested over the same
    period. ``workload`` (a `repro_torch.workload.Workload`) couples the
    grid to sampled request traces wherever the grid flows; None keeps the
    exogenous-demand paths untouched.
    """
    if len(systems) == 0 or len(policies) == 0:
        raise ValueError("need at least one system and one policy")
    dev = resolve_device(device)
    if isinstance(markets, (np.ndarray, torch.Tensor)):
        prices = torch.as_tensor(markets, dtype=torch.float32, device=dev)
        if prices.ndim != 2:
            raise ValueError("price matrix must be [n_markets, n_hours]")
    else:
        if len(markets) == 0:
            raise ValueError("need at least one market")
        prices = generate_markets(list(markets), device=dev).prices
    n = prices.shape[0]
    m_sys, k_pol = len(systems), len(policies)
    p_on_nk, p_off_nk = _thresholds(prices, policies)
    mi, si, pi = _row_indices(n, m_sys, k_pol, dev)

    def sys_field(fn):
        return torch.tensor([float(fn(s)) for s in systems],
                            dtype=torch.float32, device=dev)[si]

    def pol_field(fn):
        return torch.tensor([float(fn(p)) for p in policies],
                            dtype=torch.float32, device=dev)[pi]

    if market_names is None:
        market_names = tuple(f"market{i}" for i in range(n))
    if system_names is None:
        system_names = tuple(f"system{i}" for i in range(m_sys))

    return ScenarioGrid(
        prices=prices, market_idx=mi, system_idx=si, policy_idx=pi,
        fixed=sys_field(lambda s: s.F),
        power=sys_field(lambda s: s.C),
        period=sys_field(lambda s: s.T),
        p_on=p_on_nk[mi, pi], p_off=p_off_nk[mi, pi],
        off_level=pol_field(lambda p: p.off_level),
        idle_frac=pol_field(lambda p: p.idle_frac),
        restart_energy_mwh=pol_field(lambda p: p.restart_energy_mwh),
        restart_time_h=pol_field(lambda p: p.restart_time_h),
        market_names=tuple(market_names),
        system_names=tuple(system_names),
        policy_names=tuple(p.name for p in policies),
        workload=workload,
    )


_INDEX_FIELDS = ("market_idx", "system_idx", "policy_idx")


def grid_from_numpy(fields: Mapping[str, np.ndarray], *,
                    market_names: Sequence[str],
                    system_names: Sequence[str],
                    policy_names: Sequence[str],
                    device: DeviceLike = None) -> ScenarioGrid:
    """A grid from numpy arrays, one per tensor field of `ScenarioGrid`
    (for example ``{f: np.asarray(getattr(g, f))}`` of the JAX reference's
    grid ``g``), so both packages backtest the same scenario rows."""
    dev = resolve_device(device)
    missing = [f for f in TENSOR_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"grid_from_numpy: missing fields {missing}")
    tensors = {f: torch.as_tensor(
        np.array(fields[f]),
        dtype=torch.int64 if f in _INDEX_FIELDS else torch.float32,
        device=dev) for f in TENSOR_FIELDS}
    return ScenarioGrid(**tensors, market_names=tuple(market_names),
                        system_names=tuple(system_names),
                        policy_names=tuple(policy_names))
