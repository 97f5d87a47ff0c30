"""Horizon-windowed variants of the fleet/dispatch inner steps.

The offline engines scan a *known* [T]-hour trace once. The live
operator (`repro_torch.live`) instead re-plans every simulated hour over
an H-hour *forecast* window, then commits only the first hour — so it
needs the same per-hour math (`hard_hour_step`, `dispatch_alloc_hour`,
shared with the offline paths) run as short window loops that start from
a carried state and run entirely on forecast data.

The reference's module of the same name (`repro.kernels.live_window`) is
plain JAX, not Pallas: no TPU kernel, and so no hand-written kernel here
either. These are tensor operations on the caller's device, under the
reference's names so that a reader finds the counterpart. The segment
sort runs on the device (`segment_keys_jnp` / `segment_rank_jnp`)
because forecast prices exist only there; ordering is invariant to the
span constant as long as it exceeds the price span plus the fee, so a
host-side ``span`` upper bound over the full trace keeps the device
order identical to the host `repro_torch.dispatch.segment_rank` order
(computed in the keys' dtype: float64 keys give the host's keys
exactly).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import dispatch_alloc_hour, hard_hour_step


def segment_keys_jnp(p_t, migrate_cost, span):
    """Device mirror of `repro_torch.dispatch.segment_keys` for one hour:
    ``p_t [..., S] -> keys [..., 3S]`` (locked below everything by
    ``span``, retained at ``p - migrate_cost``, fresh at ``p``), in
    ``p_t``'s dtype. ``span`` must exceed the *global* price span plus
    ``|migrate_cost|``; the key ordering — the only thing the fill
    consumes — is then independent of its value."""
    return torch.cat([p_t - span, p_t - migrate_cost, p_t], dim=-1)


def segment_rank_jnp(keys):
    """Ascending sort permutation and its inverse (int64) of one hour's
    segment keys, on their device. The sort is stable, so ties resolve by
    segment position exactly like the host `segment_rank`."""
    order = torch.argsort(keys, dim=-1, stable=True)
    return order, torch.argsort(order, dim=-1)


def plan_on_window(on0, prices_w, p_on, p_off, off_level, idle_frac):
    """Roll the hard shutdown state machine over an H-hour (forecast)
    window from the carried state ``on0`` — the windowed variant of the
    `fleet_scan_ref` inner step, elementwise over any leading batch.

    prices_w: [..., H]; on0 and the policy fields broadcast against its
    leading shape. Returns ``(on_last, cap_w, draw_w)`` with cap/draw
    shaped like ``prices_w`` — the planned capacity trajectory a
    dispatch plan prices against.
    """
    on, caps, draws = on0, [], []
    for h in range(prices_w.shape[-1]):
        on, _, cap, draw = hard_hour_step(on, prices_w[..., h], p_on, p_off,
                                          off_level, idle_frac)
        caps.append(cap)
        draws.append(draw)
    return on, torch.stack(caps, -1), torch.stack(draws, -1)


def dispatch_window(prev, dwell, avail_w, keys_w, demand_w, *,
                    min_dwell: int):
    """Greedy water-fill over an H-hour window from a carried dispatch
    state — the windowed variant of the `dispatch_ref` loop, built on the
    same `dispatch_alloc_hour` (so an H=1 window with a fresh carry is
    exactly one offline fill hour).

    prev/dwell: [S] carried allocation and dwell locks entering the
    window; avail_w: [S, H]; keys_w: [H, 3S] (from `segment_keys_jnp`
    on forecast prices); demand_w: [H]. Returns ``(alloc_w [S, H],
    prev', dwell')`` — the planned allocation and the state the *next*
    window would start from if the whole plan were executed.
    """
    allocs = []
    for h in range(keys_w.shape[0]):
        _, rank = segment_rank_jnp(keys_w[h])
        prev, dwell = dispatch_alloc_hour(prev, dwell, avail_w[:, h], rank,
                                          demand_w[h], min_dwell=min_dwell)
        allocs.append(prev)
    return torch.stack(allocs, -1), prev, dwell
