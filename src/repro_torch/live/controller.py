"""The receding-horizon live controller: one loop over hours on the
device, vectorized over every controller instance of a `LiveGrid`.

Each simulated hour ``t`` (decision first, realization second — the
day-ahead market has published prices through the current hour, so the
trailing window ends *at* ``t`` and the forecast covers ``t+1..t+H``):

  1. **Forecast.** The [N, season+1] trailing window of every market is
     sliced (mod-``T``, circular trace semantics) and all four
     forecasters run batched (`repro_torch.energy.forecast` ``*_batch``
     paths); each row then selects its own forecaster's view of its own
     market with one advanced-indexing gather.
  2. **Re-solve.** On the row's cadence tick, the committed thresholds
     are re-solved against the forecast window: the *quantile* family
     re-resolves the policy's shutdown fraction on the window's PV set
     (a masked descending sort, mirroring
     `repro_torch.fleet.grid._resolve_threshold` at n = horizon), the
     *tuned* family runs ``inner_steps`` warm-started Adam steps on the
     relaxed per-window CPC (Adam moments and step counts carried from
     tick to tick, so every cadence tick continues the previous descent
     instead of cold-starting). Rows with ``x <= 0`` never commit
     (offline control arms).
  3. **Realize.** The committed thresholds drive one `hard_hour_step`
     at the *true* price; on/off state, restart events and the four
     `FleetScanOut` sums carry across the horizon boundary, so costs are
     realized exactly like the offline backtest.

The reference runs the hours as one jitted `lax.scan`; here they are a
Python loop of tensor operations on the device, every per-row condition
(``cadence``, ``family_id``, ``x``) a [B] tensor, nothing read back to
the host inside the loop. The market windows come from one gathered
[N, hours + season + H] block, sliced per hour without a copy.

Cost assembly reuses `repro_torch.fleet.engine.fleet_costs` with every
period-extensive quantity scaled by ``hours / T`` — a live window that
covers the full trace with a perfect forecaster reproduces the offline
`backtest` numbers (float32 sums hour by hour, as the plain backtest
adds them).

Telemetry follows the `repro_torch.obs` contract: per-hour fleet
aggregates are computed *only* while a run is active, stacked on the
device and drained once as one ``live.step`` event after the loop, and
feed nothing back, so results are bit-identical on vs off.

Faults (`repro_torch.faults`) degrade the controller instead of crashing
it. With non-trivial masks the same loop gains three channels (trivial
masks run the healthy loop itself, so a zero-fault run is the unfaulted
one bit for bit):

  * price-feed gaps — decisions read the forward-filled *observed* price
    series (a cummax of the last arrival, staleness tracked per market)
    while costs settle at the true price, as
    `repro_torch.faults.faulted_backtest` does;
  * forecast blackouts — a fallback ladder replaces the fresh forecast:
    (0) fresh, (1) the last-published window age-shifted with persistence
    tail-padding while it still covers the horizon, (2) seasonal-naive
    recomputed from the observed history once the published window has
    fully aged out, (3) raw persistence when the price feed itself is
    older than a season. Rung occupancy is accumulated on the device and
    emitted as one ``live.fallback`` event;
  * site outages — a zero capacity multiplier forces the row off (so
    recovery re-enters through the normal start path and bills the
    restart overhead); partial multipliers derate capacity and draw.
    Demand surges have no live analog (the controller rows are
    uncoupled) and are ignored here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.energy.forecast import (seasonal_naive_batch,
                                         similar_day_ar_batch)
from repro_torch.fleet.engine import fleet_costs
from repro_torch.kernels.ref import (FleetScanOut, hard_hour_step,
                                     observed_prices)
from repro_torch.live.grid import LiveGrid


class LiveConfig(NamedTuple):
    """Static controller configuration (hashable, like
    `repro_torch.tune.TuneConfig`).

    ``start``/``hours`` select the live window of the trace;
    ``season`` the forecasters' seasonal period (168 = weekly);
    ``inner_*`` the tuned family's per-cadence-tick Adam budget;
    ``churn_tol`` the threshold change (EUR/MWh) that counts as a
    decision churn event."""

    start: int = 0
    hours: int = 336
    season: int = 168
    inner_steps: int = 4
    inner_lr: float = 2.0
    inner_tau: float = 5.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    churn_tol: float = 1e-3


class LiveResult(NamedTuple):
    """Per-controller-row outcome of a live run (all [B] tensors)."""

    cpc: torch.Tensor            # realized cost-per-compute on the window
    cpc_ao: torch.Tensor         # always-on baseline on the same window
    tco: torch.Tensor
    energy_cost: torch.Tensor
    restart_cost: torch.Tensor
    up_hours: torch.Tensor
    n_starts: torch.Tensor
    n_stops: torch.Tensor
    x_realized: torch.Tensor     # realized shutdown fraction
    p_off_final: torch.Tensor    # last committed threshold
    threshold_updates: torch.Tensor  # commits that moved p_off > churn_tol
    mae1: torch.Tensor           # one-step-ahead forecast MAE
    mae_h: torch.Tensor          # mean MAE over the full horizon
    mase1: torch.Tensor          # mae1 / seasonal-naive one-step MAE


def _window_cpc_grad(p_off, fc, hmask, off_level, idle_frac, power,
                     fixed_h, dt, inv_tau):
    """Per-row gradient of the relaxed CPC on the forecast window.

    The window objective is per-hour independent (no hysteresis memory
    — the reference's deliberate simplification of the offline soft scan
    that keeps the in-loop re-tune one sigmoid deep):

        s = sigmoid((p_off - fc) / tau),  cap = lvl + (1 - lvl) s,
        draw = cap + idle (1 - cap),
        num = fixed_h + dt power sum_h draw fc,  den = max(dt sum_h cap, 1e-9)

    and each row's gradient of num / den is written out (the reference
    takes `jax.grad` of the sum over rows of the same expression; the two
    agree to float32 rounding)."""
    s = torch.sigmoid((p_off[:, None] - fc) * inv_tau)
    lvl, idle = off_level[:, None], idle_frac[:, None]
    cap = lvl + (1.0 - lvl) * s
    draw = cap + idle * (1.0 - cap)
    dcap = (1.0 - lvl) * (s * (1.0 - s) * inv_tau)
    ddraw = dcap * (1.0 - idle)
    zero = torch.zeros((), dtype=fc.dtype, device=fc.device)
    num = fixed_h + dt * power * torch.sum(
        torch.where(hmask, draw * fc, zero), 1)
    den_raw = dt * torch.sum(torch.where(hmask, cap, zero), 1)
    den = torch.clamp(den_raw, min=1e-9)
    dnum = dt * power * torch.sum(torch.where(hmask, ddraw * fc, zero), 1)
    dden = torch.where(den_raw > 1e-9,
                       dt * torch.sum(torch.where(hmask, dcap, zero), 1),
                       zero)
    return dnum / den - num * dden / (den * den)


def _live_scan(prices, market_idx, fixed, power, period, p_on0, p_off0,
               off_level, idle_frac, forecaster_id, horizon, cadence,
               family_id, x, hysteresis, *, cfg: LiveConfig, h_max: int,
               tuned: bool = True, telemetry: bool = False,
               keep_thresholds: bool = False, masks=None):
    """The hour loop. ``tuned`` False (a sweep without the tuned family)
    skips the Adam steps, whose result no row would apply. ``masks``
    (non-trivial `repro_torch.faults.FaultMasks` over B rows x N markets
    x T hours) switches on the fault channels. Returns ``(scan_out,
    extras, p_off_final, committed, fstats)``: ``committed`` is None, or
    with ``keep_thresholds`` the [hours, B] thresholds each hour realized
    with and the true prices they met (``(p_on, p_off, p_t)``, for
    `near_threshold_hours`); ``fstats`` is None, or under faults the [6]
    counts of row-hours on each fallback rung (fresh, stale-shift,
    seasonal-naive, persistence), forced off, and on a stale price."""
    dev = prices.device
    f32 = torch.float32
    t_total = prices.shape[1]
    b = market_idx.shape[0]
    w = cfg.season + 1                      # window: one season + "now"
    h = h_max
    dt = period / t_total                   # hours per sample, per row
    hf = horizon.to(f32)
    fixed_h = fixed * (hf / t_total)
    inv_tau = torch.tensor(1.0, dtype=f32, device=dev) \
        / torch.tensor(cfg.inner_tau, dtype=f32, device=dev)
    p_max_rows = torch.amax(prices, 1)[market_idx]
    resolvable = x > 0.0
    tuned_row = resolvable & (family_id == 1)
    quantile_row = family_id != 1
    hmask = torch.arange(h, device=dev)[None, :] < horizon[:, None]   # [B, H]
    # quantile index, mirroring _resolve_threshold at n = horizon
    m_q = torch.clamp(torch.round(x * hf), min=1.0).minimum(hf - 1.0) \
        .long()
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    # every hour's trailing window and forecast truth, gathered once:
    # hour i reads columns i .. i + w + h - 1 of this block
    cols = torch.arange(cfg.start - w + 1, cfg.start + cfg.hours + h,
                        device=dev) % t_total
    block = prices[:, cols]                 # [N, hours + w + h - 1]
    faulted = masks is not None
    if faulted:
        # decisions and forecasts read the observed (gap-filled) series,
        # truth and settlement the true one; every hour's mask column is
        # gathered once, like the prices
        p_obs, stale = observed_prices(
            prices, torch.as_tensor(masks.price_ok, device=dev))
        obs_block = p_obs[:, cols]
        hcols = cols[w - 1:w - 1 + cfg.hours]              # [hours]
        stale_h = stale[:, hcols]                          # [N, hours]
        ok_h = torch.as_tensor(masks.price_ok, device=dev)[:, hcols]
        fok_h = torch.as_tensor(masks.forecast_ok, device=dev)[:, hcols]
        mult_h = torch.as_tensor(masks.cap_mult, dtype=f32,
                                 device=dev)[:, hcols]     # [B, hours]
        # the last-published window starts fully aged, so a blackout in
        # the first hour already lands on the seasonal-naive rung
        fc_prev = torch.zeros((b, h), dtype=f32, device=dev)
        fc_age = torch.full((b,), h, dtype=torch.long, device=dev)
        fstats = torch.zeros(6, dtype=f32, device=dev)
        shift0 = torch.arange(h, device=dev)[None, :]
    else:
        obs_block = block

    on = torch.ones(b, dtype=f32, device=dev)
    p_on_c, p_off_c = p_on0, p_off0
    po_t = torch.where(torch.isfinite(p_off0), p_off0, p_max_rows)
    m_t = torch.zeros(b, dtype=f32, device=dev)
    v_t = torch.zeros_like(m_t)
    tc = torch.zeros_like(m_t)
    acc = torch.zeros((9, b), dtype=f32, device=dev)
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    ys, kept = [], []
    for i in range(cfg.hours):
        # --- 1. forecast: every forecaster, every market, batched -----
        hist = obs_block[:, i:i + w]                        # [N, W]
        truth = block[:, i + w:i + w + h]                   # [N, H]
        f_sn = seasonal_naive_batch(hist, h, cfg.season)
        f_ar = similar_day_ar_batch(hist, h, cfg.season)
        f_p = hist[:, -1:].expand_as(f_sn)
        f_all = torch.stack([f_sn, f_ar, f_p, truth])      # [4, N, H]
        fc = f_all[forecaster_id, market_idx]              # [B, H]
        truth_rows = truth[market_idx]                     # [B, H]
        if faulted:
            # the degradation ladder: fresh -> age-shifted last-published
            # (persistence-padded tail) -> seasonal-naive on the observed
            # history -> raw persistence once the feed itself is stale
            f_ok = fok_h[:, i][market_idx]                     # [B]
            age = torch.where(f_ok, 0, fc_age + 1)
            shift = torch.clamp(shift0 + age[:, None], 0, h - 1)
            fc_shift = fc_prev.gather(1, shift)
            r1 = ~f_ok & (age < h)
            r23 = ~f_ok & (age >= h)
            r3 = r23 & (stale_h[:, i][market_idx] > cfg.season)
            r2 = r23 & ~r3
            fc = torch.where(f_ok[:, None], fc,
                             torch.where(r1[:, None], fc_shift,
                                         torch.where(r2[:, None],
                                                     f_sn[market_idx],
                                                     f_p[market_idx])))
            fc_prev = torch.where(f_ok[:, None], fc, fc_prev)
            fc_age = age

        # --- 2. re-solve on the cadence tick --------------------------
        do_commit = ((i % cadence) == 0) & resolvable

        # quantile family: descending masked sort; -inf padding sinks
        # beyond-horizon samples to the tail, so index m-1 < horizon
        # always hits a real forecast sample
        desc = torch.sort(torch.where(hmask, fc, neg_inf), dim=1,
                          descending=True).values
        q_thr = desc.gather(1, (m_q - 1)[:, None])[:, 0]

        # tuned family: inner_steps warm-started Adam steps on the
        # relaxed window CPC (moments and counters carried)
        po, m, v = po_t, m_t, v_t
        for k in range(cfg.inner_steps if tuned else 0):
            g = _window_cpc_grad(po, fc, hmask, off_level, idle_frac, power,
                                 fixed_h, dt, inv_tau)
            g = torch.where(tuned_row, g, zero)
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            tck = tc + (k + 1.0)
            mhat = m / (1.0 - torch.pow(b1, tck))
            vhat = v / (1.0 - torch.pow(b2, tck))
            po = po - cfg.inner_lr * mhat / (torch.sqrt(vhat)
                                             + cfg.adam_eps)
        apply_t = do_commit & tuned_row
        po_t = torch.where(apply_t, po, po_t)
        m_t = torch.where(apply_t, m, m_t)
        v_t = torch.where(apply_t, v, v_t)
        tc = torch.where(apply_t, tc + cfg.inner_steps, tc)

        cand = torch.where(quantile_row, q_thr, po_t)
        p_off_new = torch.where(do_commit, cand, p_off_c)
        p_on_new = torch.where(
            do_commit,
            p_off_new - (1.0 - hysteresis) * torch.abs(p_off_new), p_on_c)
        churn = do_commit & (torch.abs(p_off_new - p_off_c) > cfg.churn_tol)

        # --- 3. realize on the true trace -----------------------------
        p_t = block[:, i + w - 1][market_idx]
        if faulted:
            # decide on the observed (gap-filled) price, settle at the
            # true price; a zero capacity multiplier forces the row off
            # and recovery re-enters through the normal start account
            m_row = mult_h[:, i]
            on_new = hard_hour_step(on, hist[:, -1][market_idx], p_on_new,
                                    p_off_new, off_level, idle_frac)[0]
            on_new = torch.where(m_row > 0.0, on_new, zero)
            st = torch.clamp(on_new - on, min=0.0)
            cap = off_level + (1.0 - off_level) * on_new
            draw = cap + idle_frac * (1.0 - cap)
            cap = cap * m_row                                  # derate
            draw = draw * m_row
            fstats = fstats + torch.stack([
                torch.sum(f_ok.to(f32)), torch.sum(r1.to(f32)),
                torch.sum(r2.to(f32)), torch.sum(r3.to(f32)),
                torch.sum((m_row <= 0.0).to(f32)),
                torch.sum((~ok_h[:, i][market_idx]).to(f32))])
        else:
            on_new, st, cap, draw = hard_hour_step(on, p_t, p_on_new,
                                                   p_off_new, off_level,
                                                   idle_frac)
        stop = torch.clamp(on - on_new, min=0.0)
        err1 = torch.abs(fc[:, 0] - truth_rows[:, 0])
        err_h = torch.sum(torch.where(hmask, torch.abs(fc - truth_rows),
                                      zero), 1) / hf
        naive1 = torch.abs(f_sn[:, 0] - truth[:, 0])[market_idx]
        acc = acc + torch.stack([draw * p_t, cap, st, st * p_t, stop,
                                 churn.to(f32), err1, err_h, naive1])
        if telemetry:
            ys.append(torch.stack([
                torch.sum(power * cap), torch.sum(power * draw * p_t),
                torch.sum(st) + torch.sum(stop), torch.mean(err1),
                torch.sum(do_commit.to(f32))]))
        if keep_thresholds:
            kept.append(torch.stack([p_on_new, p_off_new, p_t]))
        on, p_on_c, p_off_c = on_new, p_on_new, p_off_new

    if telemetry:
        y = torch.stack(ys, 1)                              # [5, hours]
        obs.drain("live.step", on_mw=y[0], cost_rate=y[1],
                  transitions=y[2], abs_err1=y[3], commits=y[4])
    scan_out = FleetScanOut(draw_price_sum=acc[0], up_units=acc[1],
                            n_starts=acc[2], restart_price_sum=acc[3])
    committed = tuple(torch.stack(kept, 1)) if keep_thresholds else None
    return scan_out, acc[4:], p_off_c, committed, \
        (fstats if faulted else None)


def _scan_args(lgrid: LiveGrid) -> tuple:
    g = lgrid.grid
    return (g.prices, g.market_idx, g.fixed, g.power, g.period, g.p_on,
            g.p_off, g.off_level, g.idle_frac, lgrid.forecaster_id,
            lgrid.horizon, lgrid.cadence, lgrid.family_id, lgrid.x,
            lgrid.hysteresis)


def _scan_kw(lgrid: LiveGrid, cfg: LiveConfig) -> dict:
    return dict(cfg=cfg, h_max=lgrid.h_max,
                tuned="tuned" in lgrid.family_names)


def near_threshold_hours(lgrid: LiveGrid, cfg: LiveConfig, rtol: float, *,
                         device: DeviceLike = None) -> torch.Tensor:
    """[B] count of the live window's hours in which a row's true price
    lies within ``rtol`` (relative) of a threshold it realized with — the
    hours in which two runs that agree on the thresholds only to
    ``rtol`` may take different on/off decisions. Reruns the hour loop on
    ``device``; used to hold the port against the reference and the card
    against the CPU."""
    lgrid = lgrid.to(resolve_device(device))
    _, _, _, (p_on, p_off, p_t), _ = _live_scan(
        *_scan_args(lgrid), **_scan_kw(lgrid, cfg), keep_thresholds=True)
    near = torch.zeros_like(p_t, dtype=torch.bool)
    for thr in (p_on, p_off):
        fin = torch.isfinite(thr)
        near |= fin & (torch.abs(p_t - thr) <= rtol * torch.abs(thr))
    return near.sum(0)


def live_backtest(lgrid: LiveGrid, cfg: LiveConfig = LiveConfig(), *,
                  faults=None, device: DeviceLike = None) -> LiveResult:
    """Run every controller instance of ``lgrid`` over the live window on
    ``device`` (default ``cuda``; raises without it) and assemble
    realized costs.

    Window accounting: every period-extensive quantity (fixed cost, the
    accounting period itself) is scaled by ``hours / T``, so per-sample
    hours ``dt = period / T`` match the offline backtest and a window
    covering the whole trace reproduces `repro_torch.fleet.engine.
    backtest`. Indices wrap mod ``T`` (circular trace): the trailing
    window before hour ``season`` reads the end of the trace, the
    periodic-boundary convention of the synthetic markets.

    ``faults`` is an optional `repro_torch.faults.FaultTrace` (compiled
    here onto B rows x N markets x T trace hours — outage targets index
    controller *rows*, fault hours are absolute trace hours) or
    pre-compiled `repro_torch.faults.FaultMasks`. None or a trivial
    schedule runs the healthy loop, bit for bit the run without it;
    otherwise the degradation ladder engages (module docstring) and a
    ``live.fallback`` event reports rung occupancy.
    """
    if cfg.hours < 1:
        raise ValueError("LiveConfig.hours must be >= 1")
    lgrid = lgrid.to(resolve_device(device))
    grid = lgrid.grid
    telemetry = obs.enabled()
    masks = None
    if faults is not None and getattr(faults, "events", True):
        from repro_torch.faults.inject import emit_fault_events, resolve_masks
        masks = resolve_masks(faults, grid.n_rows, grid.n_markets,
                              grid.n_hours)
        if masks.is_trivial:
            masks = None
        else:
            emit_fault_events(faults, masks, scope="live")
    scan_out, extras, p_off_f, _, fstats = _live_scan(
        *_scan_args(lgrid), **_scan_kw(lgrid, cfg), telemetry=telemetry,
        masks=masks)
    n_stops, churn, err1, err_h, naive1 = extras
    if fstats is not None and telemetry:
        n = [int(v) for v in fstats.tolist()]
        obs.trace_event("live.fallback", {
            "fresh": n[0], "stale_shift": n[1], "seasonal_naive": n[2],
            "persistence": n[3], "forced_off_row_hours": n[4],
            "stale_price_row_hours": n[5], "rows": grid.n_rows,
            "hours": cfg.hours})
        obs.counter("live.fallback_hours").inc(n[1] + n[2] + n[3])

    t_total = grid.n_hours
    frac = cfg.hours / t_total
    window = (cfg.start + torch.arange(cfg.hours, device=grid.prices.device)
              ) % t_total
    price_sum = torch.sum(grid.prices[:, window], 1)[grid.market_idx]
    costs = fleet_costs(
        scan_out, price_sum=price_sum, fixed=grid.fixed * frac,
        power=grid.power, period=grid.period * frac,
        restart_energy_mwh=grid.restart_energy_mwh,
        restart_time_h=grid.restart_time_h, n_samples=cfg.hours)
    mae1 = err1 / cfg.hours
    return LiveResult(
        cpc=costs.cpc, cpc_ao=costs.cpc_ao, tco=costs.tco,
        energy_cost=costs.energy_cost, restart_cost=costs.restart_cost,
        up_hours=costs.up_hours, n_starts=scan_out.n_starts,
        n_stops=n_stops,
        x_realized=1.0 - scan_out.up_units / cfg.hours,
        p_off_final=p_off_f, threshold_updates=churn,
        mae1=mae1, mae_h=err_h / cfg.hours,
        mase1=mae1 / torch.clamp(naive1 / cfg.hours, min=1e-9))
