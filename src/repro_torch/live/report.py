"""Live-run scoring: regret vs the hindsight oracle and vs the
offline-tuned policy, grouped over the controller-design sweep.

The *hindsight oracle* is the clairvoyant two-level relaxation: with
the whole live window known, an operator free to pick any set of
full-capacity hours (no hysteresis, no dwell, no restart overheads)
runs at capacity in exactly the k cheapest hours for some k — so the
optimum is an exact 1-D scan over k on each market's sorted window.
This lower-bounds every realizable threshold policy *when restart
costs are non-negative* (a restart priced at a negative-price hour
could otherwise earn money the oracle ignores); the acceptance grid
therefore uses restart-free policies, and the bound is asserted row by
row in the tests.

The *offline-tuned* comparison simply re-runs the offline backtest on
the live window with the grid's own (full-trace-resolved) thresholds —
what the operator would have realized by never reacting to the stream.
It runs on the grid's device, so on the card through the `fleet_scan`
kernel (the reference runs its plain scan here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.fleet.engine import backtest
from repro_torch.live.controller import LiveConfig, LiveResult
from repro_torch.live.grid import FAMILIES, FORECASTERS, LiveGrid


def _window_index(cfg: LiveConfig, t_total: int) -> np.ndarray:
    return (cfg.start + np.arange(cfg.hours)) % t_total


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def hindsight_cpc(lgrid: LiveGrid, cfg: LiveConfig,
                  chunk_rows: int = 4096) -> np.ndarray:
    """[B] clairvoyant lower-bound CPC per controller row (see module
    docstring; requires non-negative restart costs to be a bound)."""
    grid = lgrid.grid
    t = cfg.hours
    idx = _window_index(cfg, grid.n_hours)
    prices_w = _np(grid.prices, np.float64)[:, idx]          # [N, T]
    cheap = np.concatenate(
        [np.zeros((prices_w.shape[0], 1)),
         np.cumsum(np.sort(prices_w, axis=1), axis=1)], axis=1)  # [N,T+1]
    total = prices_w.sum(axis=1)                             # [N]

    frac = t / grid.n_hours
    mi = _np(grid.market_idx, np.int64)
    fixed = _np(grid.fixed, np.float64) * frac
    power = _np(grid.power, np.float64)
    dt = _np(grid.period, np.float64) / grid.n_hours
    lvl = _np(grid.off_level, np.float64)
    idle = _np(grid.idle_frac, np.float64)

    out = np.empty(lgrid.n_rows, np.float64)
    k = np.arange(t + 1, dtype=np.float64)                   # [T+1]
    for lo in range(0, lgrid.n_rows, chunk_rows):
        sl = slice(lo, lo + chunk_rows)
        draw_off = (lvl[sl] + idle[sl] * (1.0 - lvl[sl]))[:, None]
        # energy when ON occupies the k cheapest hours, OFF the rest
        energy = draw_off * total[mi[sl], None] \
            + (1.0 - draw_off) * cheap[mi[sl]]               # [b, T+1]
        up = lvl[sl][:, None] * t + (1.0 - lvl[sl])[:, None] * k[None]
        cpc_k = (fixed[sl][:, None]
                 + dt[sl][:, None] * power[sl][:, None] * energy) \
            / np.maximum(dt[sl][:, None] * up, 1e-9)
        out[sl] = cpc_k.min(axis=1)
    return out


def offline_cpc(lgrid: LiveGrid, cfg: LiveConfig) -> np.ndarray:
    """[B] CPC the grid's offline (full-trace) thresholds realize on the
    live window — the never-react baseline, via the offline engine on a
    window-sliced grid with the same ``hours / T`` cost scaling as
    `repro_torch.live.controller.live_backtest`, on the grid's device."""
    grid = lgrid.grid
    dev = grid.prices.device
    idx = torch.as_tensor(_window_index(cfg, grid.n_hours), device=dev)
    frac = cfg.hours / grid.n_hours
    grid_w = dataclasses.replace(
        grid, prices=grid.prices[:, idx].contiguous(),
        fixed=grid.fixed * frac, period=grid.period * frac)
    return _np(backtest(grid_w, device=dev).cpc, np.float64)


@dataclasses.dataclass(frozen=True)
class LiveSummary:
    """Scored live run: per-row arrays plus the grouped design table."""

    cpc_live: np.ndarray       # [B]
    cpc_oracle: np.ndarray     # [B] hindsight lower bound
    cpc_offline: np.ndarray    # [B] never-react baseline
    regret_oracle: np.ndarray  # [B] cpc_live / cpc_oracle - 1
    regret_offline: np.ndarray  # [B] cpc_live / cpc_offline - 1
    table: tuple               # grouped by (forecaster, horizon,
                               # cadence, family), mean stats per group

    def render_table(self) -> str:
        head = (f"{'forecaster':>16} {'H':>4} {'cad':>4} {'family':>9} "
                f"{'cpc':>9} {'vs oracle':>10} {'vs offline':>11} "
                f"{'mae1':>8} {'churn':>7}")
        lines = [head, "-" * len(head)]
        for r in self.table:
            lines.append(
                f"{r['forecaster']:>16} {r['horizon']:>4d} "
                f"{r['cadence']:>4d} {r['family']:>9} "
                f"{r['cpc']:>9.3f} {r['regret_oracle']:>9.1%} "
                f"{r['regret_offline']:>10.1%} {r['mae1']:>8.2f} "
                f"{r['churn']:>7.1f}")
        return "\n".join(lines)


def summarize_live(lgrid: LiveGrid, result: LiveResult,
                   cfg: LiveConfig) -> LiveSummary:
    """Score a `LiveResult` against both reference points and group the
    sweep by controller design. Emits the ``live.result`` trace event."""
    cpc_live = _np(result.cpc, np.float64)
    cpc_o = hindsight_cpc(lgrid, cfg)
    cpc_f = offline_cpc(lgrid, cfg)
    reg_o = cpc_live / np.maximum(cpc_o, 1e-12) - 1.0
    reg_f = cpc_live / np.maximum(cpc_f, 1e-12) - 1.0

    fid = _np(lgrid.forecaster_id, np.int64)
    hor = _np(lgrid.horizon, np.int64)
    cad = _np(lgrid.cadence, np.int64)
    fam = _np(lgrid.family_id, np.int64)
    mae1 = _np(result.mae1, np.float64)
    churn = _np(result.threshold_updates, np.float64)
    rows = []
    for f, h, c, g in sorted({(int(a), int(b), int(d), int(e))
                              for a, b, d, e in zip(fid, hor, cad, fam)}):
        sel = (fid == f) & (hor == h) & (cad == c) & (fam == g)
        rows.append({
            "forecaster": FORECASTERS[f],
            "horizon": h, "cadence": c,
            "family": FAMILIES[g],
            "cpc": float(cpc_live[sel].mean()),
            "regret_oracle": float(reg_o[sel].mean()),
            "regret_offline": float(reg_f[sel].mean()),
            "mae1": float(mae1[sel].mean()),
            "churn": float(churn[sel].mean()),
            "rows": int(sel.sum())})
    rows.sort(key=lambda r: r["cpc"])

    summary = LiveSummary(cpc_live=cpc_live, cpc_oracle=cpc_o,
                          cpc_offline=cpc_f, regret_oracle=reg_o,
                          regret_offline=reg_f, table=tuple(rows))
    if obs.enabled():
        obs.trace_event("live.result", {
            "rows": int(lgrid.n_rows), "hours": int(cfg.hours),
            "cpc_mean": float(cpc_live.mean()),
            "regret_oracle_mean": float(reg_o.mean()),
            "regret_offline_mean": float(reg_f.mean()),
            "mae1_mean": float(mae1.mean()),
            "churn_total": float(churn.sum()),
            "best": rows[0] if rows else None})
        obs.gauge("live.regret_oracle_mean").set(float(reg_o.mean()))
        obs.counter("live.runs").inc()
    return summary
