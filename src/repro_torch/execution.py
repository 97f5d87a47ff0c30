"""Execution plans and fleet-coupling specs — the config surface shared
by the fleet backtest, the tuner and the dispatcher.

  * **What couples the fleet?** — `Coupling`: which fleet-level terms bind
    an objective (total-power cap, aggregate-compute floor, the
    dispatch-aware water-fill term) plus the hard-dispatch re-scoring
    config. A default `Coupling()` binds nothing.
  * **How does the batch execute?** — `ExecutionPlan`: one program, row
    chunks of a fixed size, or sharded over the ranks of a
    `torch.distributed` process group, and which
    reproducibility contract the caller expects (bitwise for chunking,
    ULP for sharding).

Both are frozen (hashable) dataclasses. The legality rule — a *chunked*
program cannot evaluate a coupled objective, because coupled terms see
every row at once — is checked when the pair is assembled
(`validate_plan_coupling`). This module imports nothing from the engine
layers (the dispatch config it carries is duck-typed).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

_MODES = ("auto", "single", "chunked", "sharded")
_CONTRACTS = ("auto", "bitwise", "ulp")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """How a [B]-row batch executes (hashable).

    ``mode``:
      * ``"auto"`` — chunk if ``chunk_rows`` is set and the batch
        exceeds it, else shard over available devices when profitable,
        else one program (the pre-redesign default behaviour);
      * ``"single"`` — always one program (the old ``shard=False``);
      * ``"chunked"`` — fixed row slices of ``chunk_rows`` (the old
        ``chunk_rows=``), bit-identical per row to the single program;
      * ``"sharded"`` — split over a 1-D row mesh of ranks
        (`repro_torch.parallel.row_mesh`), padding the batch to equal
        shard widths when needed; ULP-equal per row.

    ``devices`` caps the shard count (0: every rank of the default process
    group; without one, a single program). ``contract``
    documents (and validates) the reproducibility expectation: chunked
    execution is bitwise, sharding is ULP-level — asking for
    ``"bitwise"`` together with ``mode="sharded"`` is a contradiction
    and raises here rather than surprising a downstream assert.
    """

    mode: str = "auto"
    chunk_rows: int = 0
    devices: int = 0
    contract: str = "auto"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"ExecutionPlan.mode must be one of "
                             f"{_MODES}, got {self.mode!r}")
        if self.contract not in _CONTRACTS:
            raise ValueError(f"ExecutionPlan.contract must be one of "
                             f"{_CONTRACTS}, got {self.contract!r}")
        if self.chunk_rows == 1:
            raise ValueError(
                "ExecutionPlan.chunk_rows must be >= 2: width-1 "
                "programs may take other code paths and drift off the "
                "bit-identical contract (same reason shards keep >= 2 "
                "rows)")
        if self.chunk_rows < 0:
            raise ValueError("ExecutionPlan.chunk_rows must be >= 0")
        if self.devices < 0:
            raise ValueError("ExecutionPlan.devices must be >= 0")
        if self.mode == "chunked" and not self.chunk_rows:
            raise ValueError("ExecutionPlan(mode='chunked') needs "
                             "chunk_rows >= 2")
        if self.mode == "sharded" and self.chunk_rows:
            raise ValueError("ExecutionPlan(mode='sharded') does not "
                             "chunk — drop chunk_rows or use "
                             "mode='chunked'")
        if self.mode == "sharded" and self.contract == "bitwise":
            raise ValueError(
                "ExecutionPlan: sharded execution is ULP-equal, not "
                "bitwise (kernel choice depends on the shard width) — "
                "use mode='chunked' for the bitwise contract")


@dataclasses.dataclass(frozen=True)
class Coupling:
    """What fleet-level terms bind a tuning objective (hashable).

    ``dispatch`` is the *soft*, dispatch-aware coupling (the old
    ``TuneConfig.dispatch_soft``): differentiate through the relaxed
    water-fill so sites learn their fleet role. ``reeval`` is the
    hard-dispatch re-scoring config only (the old
    ``TuneConfig.dispatch``): it scores the final policy sets under
    feasible `repro.dispatch.dispatch` but adds nothing to the
    gradient, so it does **not** couple rows. Both are duck-typed
    `repro.dispatch.DispatchConfig` instances (kept loose so this
    module stays import-cycle-free). ``relief`` (a duck-typed
    `repro.dispatch.Relief`) prices infeasible dispatch hours as shed
    instead of raising, in *both* the soft water-fill term and the hard
    re-scoring; None defers to whatever the dispatch configs carry.
    """

    power_cap_mw: Optional[float] = None
    min_up_hours: Optional[float] = None
    penalty_weight: float = 10.0
    dispatch: Optional[Any] = None       # soft / dispatch-aware
    dispatch_blend: float = 0.5
    dispatch_mw_scale: float = 0.05
    reeval: Optional[Any] = None         # hard re-scoring only
    relief: Optional[Any] = None         # shed pricing for infeasibility

    @property
    def binds(self) -> bool:
        """True when any term couples rows through a fleet aggregate
        (``reeval`` alone does not — it is post-hoc scoring)."""
        return (self.power_cap_mw is not None
                or self.min_up_hours is not None
                or self.dispatch is not None)

    @property
    def reeval_config(self):
        """The hard-dispatch config the final re-scoring runs under:
        ``reeval`` when given, else the soft ``dispatch`` config."""
        return self.reeval if self.reeval is not None else self.dispatch

    @property
    def relief_config(self):
        """The shed-pricing spec in force: ``relief`` when given, else
        whatever the soft dispatch config itself carries (duck-typed
        `repro.dispatch.Relief`; None means infeasibility stays hard)."""
        if self.relief is not None:
            return self.relief
        d = self.dispatch
        return getattr(d, "relief", None) if d is not None else None


def validate_plan_coupling(plan: ExecutionPlan,
                           coupling: Optional[Coupling], *,
                           context: str = "ExecutionPlan") -> None:
    """The one legality rule the pair carries: a chunked program cannot
    evaluate a coupled objective. Coupled terms (power_cap_mw /
    min_up_hours / the dispatch_soft water-fill) see every row at once,
    so a row chunk would optimize against a fleet that does not exist —
    and quietly dropping the chunking instead would drop the memory
    bound the user asked for. Sharding is the supported scale-out for
    coupled objectives (psum-reduced aggregates)."""
    if coupling is None or not coupling.binds:
        return
    if plan.chunk_rows:
        raise ValueError(
            f"{context}: chunk_rows cannot be combined with fleet "
            "coupling (power_cap_mw / min_up_hours / dispatch_soft): "
            "coupled terms see every row at once, so a row chunk would "
            "optimize against a fleet that does not exist — use "
            "ExecutionPlan(mode='sharded') (coupled aggregates are "
            "psum-reduced across shards), tune unchunked, or drop the "
            "coupling")


# the reference's pre-redesign spellings and what replaced them
RENAMED = {
    "chunk_rows": "plan=ExecutionPlan(mode='chunked', chunk_rows=...)",
    "shard": "plan=ExecutionPlan(mode='single') (shard=False) or "
             "ExecutionPlan() (shard=True)",
    "power_cap_mw": "coupling=Coupling(power_cap_mw=...)",
    "min_up_hours": "coupling=Coupling(min_up_hours=...)",
    "penalty_weight": "coupling=Coupling(penalty_weight=...)",
    "dispatch": "coupling=Coupling(reeval=...)",
    "dispatch_soft": "coupling=Coupling(dispatch=...)",
    "dispatch_blend": "coupling=Coupling(dispatch_blend=...)",
    "dispatch_mw_scale": "coupling=Coupling(dispatch_mw_scale=...)",
}


def refuse_renamed(kw: dict, context: str, names=tuple(RENAMED)) -> None:
    """Raise `TypeError` naming the replacement of the first keyword in
    ``kw`` that is one of the reference's pre-redesign spellings
    ``names`` (the reference still takes them, with a deprecation
    warning; the port takes only ``plan=`` / ``coupling=``)."""
    for k in kw:
        if k in names:
            raise TypeError(f"{context}({k}=) is the reference's deprecated "
                            f"spelling; pass {RENAMED[k]}")


def take_rows(record, order, *, shared=(), n_rows: Optional[int] = None):
    """Shape-driven row slice of a record of [B]-leading tensors.

    The one implementation behind `ScenarioGrid.take_rows` — every
    chunked path slices rows the same way. ``record`` is a frozen
    dataclass or NamedTuple; fields named in ``shared`` are carried
    through untouched, fields that themselves expose a ``take_rows``
    method recurse, and everything else must be a [B]-leading tensor — a
    field that is neither raises instead of being silently dropped, so a
    future field cannot fall through the permutation.
    """
    order = np.asarray(order, np.int64)
    if dataclasses.is_dataclass(record):
        names = [f.name for f in dataclasses.fields(record)]

        def rebuild(rep):
            return dataclasses.replace(record, **rep)
    elif hasattr(record, "_fields") and hasattr(record, "_replace"):
        names = list(record._fields)
        rebuild = lambda rep: record._replace(**rep)  # noqa: E731
    else:
        raise TypeError(f"take_rows needs a dataclass or NamedTuple, "
                        f"got {type(record).__name__}")
    if n_rows is None:
        n_rows = next(
            (int(v.shape[0]) for v in (getattr(record, n) for n in names
                                       if n not in shared)
             if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1),
            0)
    rep = {}
    for name in names:
        if name in shared:
            continue
        v = getattr(record, name)
        if callable(getattr(v, "take_rows", None)):
            rep[name] = v.take_rows(order)
            continue
        if not hasattr(v, "shape") or v.ndim < 1 or v.shape[0] != n_rows:
            raise TypeError(
                f"{type(record).__name__}.take_rows: field {name!r} is "
                "neither a shared field nor a [B]-leading per-row array "
                "— add it to SHARED_FIELDS or make it per-row")
        rep[name] = v[order] if isinstance(v, np.ndarray) \
            else v[torch.as_tensor(order, device=v.device)]
    return rebuild(rep)
