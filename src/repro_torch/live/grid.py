"""LiveGrid — materialise a batched controller-design sweep.

A live controller instance is one scenario row of the offline
`ScenarioGrid` *plus* a controller design: which forecaster it trusts,
how far ahead it plans (horizon), how often it re-solves (cadence), and
which re-solve family it runs (quantile re-resolution of the policy's
shutdown fraction, or a short warm-started gradient re-tune). The cross
product — forecaster x horizon x cadence x family x base row — is
flattened into one row-expanded `ScenarioGrid` (via `take_rows`, so
every engine-facing field is already per-live-row) with the controller
design carried as parallel [B] tensors on the grid's device, and the
whole sweep runs as one hour loop in `repro_torch.live.controller`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import execution
from repro_torch.fleet.grid import PolicySpec, ScenarioGrid

# forecaster id -> name; ids index the controller's stacked forecast
# tensor, so the order here is contractual. "persistence" repeats the
# last published price; "perfect" reads the true future trace (the
# zero-forecast-error control arm of the regret sandwich).
FORECASTERS = ("seasonal_naive", "similar_day_ar", "persistence",
               "perfect")

# family id -> name. "quantile" re-resolves the policy's shutdown
# fraction x against the forecast window's own PV set (the live analog
# of `repro_torch.fleet.grid._resolve_threshold`); "tuned" descends the
# relaxed CPC objective on the forecast window with a few warm-started
# Adam steps per cadence tick (the in-loop analog of
# `repro_torch.tune.optimize(warm_start=...)`).
FAMILIES = ("quantile", "tuned")


@dataclasses.dataclass(frozen=True)
class LiveGrid:
    """Row-expanded controller sweep, ordered
    b = (((base*F + f)*H + h)*C + c)*FAM + fam."""

    grid: ScenarioGrid            # one row per controller instance
    base_row: np.ndarray          # [B] int64 row in the source grid
    forecaster_id: torch.Tensor   # [B] int64 index into FORECASTERS
    horizon: torch.Tensor         # [B] int64 planning horizon (hours)
    cadence: torch.Tensor         # [B] int64 re-solve period (hours)
    family_id: torch.Tensor       # [B] int64 index into FAMILIES
    x: torch.Tensor               # [B] shutdown fraction; <= 0: the row
                                  #     keeps its offline threshold
    hysteresis: torch.Tensor      # [B] resume back-off (PolicySpec)
    forecaster_names: tuple = FORECASTERS
    family_names: tuple = ()
    horizons: tuple = ()
    cadences: tuple = ()

    @property
    def n_rows(self) -> int:
        return int(self.base_row.shape[0])

    @property
    def h_max(self) -> int:
        return int(self.horizon.max())

    # fields shared across rows, NOT permuted by take_rows (the design
    # axes' name tables); everything else must be [B]-leading or the
    # generic take_rows refuses to guess
    SHARED_FIELDS = ("forecaster_names", "family_names", "horizons",
                     "cadences")

    def take_rows(self, order: np.ndarray) -> "LiveGrid":
        """Row-permuted view over controller instances — the one
        shape-driven `repro_torch.execution.take_rows` shared with
        `ScenarioGrid.take_rows` (the nested grid recurses through its
        own ``take_rows``, keeping its price block shared)."""
        return execution.take_rows(self, order, shared=self.SHARED_FIELDS,
                                   n_rows=self.n_rows)

    def to(self, device) -> "LiveGrid":
        """The same sweep with every tensor on ``device``."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, grid=self.grid.to(dev),
            **{f: getattr(self, f).to(dev) for f in (
                "forecaster_id", "horizon", "cadence", "family_id", "x",
                "hysteresis")})


def build_live_grid(grid: ScenarioGrid, policies: Sequence[PolicySpec],
                    *, forecasters: Sequence[str] = FORECASTERS,
                    horizons: Sequence[int] = (24,),
                    cadences: Sequence[int] = (1,),
                    families: Sequence[str] = ("quantile",)) -> LiveGrid:
    """Cross an offline `ScenarioGrid` with a controller-design sweep, on
    the grid's device.

    ``policies`` must be the same specs the grid was built from (the
    grid itself stores only resolved thresholds; the live quantile
    family needs each row's shutdown *fraction* back). Fixed-threshold
    and always-on specs get ``x = 0`` — those rows never re-solve and
    ride along as offline-policy control arms.
    """
    if len(policies) != grid.n_policies:
        raise ValueError(f"grid has {grid.n_policies} policies but "
                         f"{len(policies)} specs were given")
    for f in forecasters:
        if f not in FORECASTERS:
            raise ValueError(f"unknown forecaster {f!r} "
                             f"(have {FORECASTERS})")
    for fam in families:
        if fam not in FAMILIES:
            raise ValueError(f"unknown family {fam!r} (have {FAMILIES})")
    horizons = tuple(int(h) for h in horizons)
    cadences = tuple(int(c) for c in cadences)
    if any(h < 2 for h in horizons):
        raise ValueError("horizons must be >= 2 (a 1-hour window has no "
                         "interior quantile)")
    if any(c < 1 for c in cadences):
        raise ValueError("cadences must be >= 1")

    b0 = grid.n_rows
    f_ids = np.asarray([FORECASTERS.index(f) for f in forecasters],
                       np.int64)
    fam_ids = np.asarray([FAMILIES.index(f) for f in families], np.int64)
    base, fi, hi, ci, gi = np.meshgrid(
        np.arange(b0), f_ids, np.asarray(horizons, np.int64),
        np.asarray(cadences, np.int64), fam_ids, indexing="ij")
    base = base.reshape(-1)
    pol = grid.policy_idx.cpu().numpy()[base]
    x = np.asarray([0.0 if p.x is None else max(float(p.x), 0.0)
                    for p in policies], np.float32)[pol]
    hyst = np.asarray([float(p.hysteresis) for p in policies],
                      np.float32)[pol]
    dev = grid.prices.device

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return LiveGrid(
        grid=grid.take_rows(base),
        base_row=base,
        forecaster_id=on_dev(fi.reshape(-1)),
        horizon=on_dev(hi.reshape(-1)),
        cadence=on_dev(ci.reshape(-1)),
        family_id=on_dev(gi.reshape(-1)),
        x=on_dev(x), hysteresis=on_dev(hyst),
        forecaster_names=tuple(forecasters),
        family_names=tuple(families),
        horizons=horizons, cadences=cadences)
