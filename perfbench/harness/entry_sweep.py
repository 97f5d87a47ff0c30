"""The ``sweep`` entry: a closed loop of one caller sending policy
sweeps over fixed prices.

Set-up draws the price block (the configuration's markets x the mix's
price years) and warms up with two requests. Each request draws its
policies from the seed (before its clock starts), then builds the grid
(`build_grid`: each market's price sort for the thresholds) and
backtests it (`backtest`); it ends when every row's CPC reduction and
start count are on the host (copied into reused host buffers, pinned on
a card). Its latency runs from its start to then. With ``--trace 1`` the
mix's ``trace_requests`` requests run under the profiler first, outside
the window.

Check: a sample of the window's requests, drawn from the seed, is
judged by the reference: each row's thresholds (exactly), CPC, start
count (exactly) and reduction.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import inputs
from harness.entries import Outcome, Run, memory_peak
from harness.trace import Tracer
from reference import fleet as ref_fleet
from reference import grid as ref_grid

POLICY_STREAM, WARM_STREAM, SAMPLE_STREAM = 1, 2, 3
MIX_KEYS = {"entry", "why", "years_per_market", "policies",
            "check_requests", "trace_requests"}


def request(r: Run, prices, systems, policies: list[dict], host: dict,
            events: bool = False) -> dict:
    """One request; its results land in ``host``'s reused (pinned, on a
    card) buffers, which the caller copies out if it keeps them."""
    from repro_torch.fleet import backtest, build_grid
    specs = inputs.port_policies(policies)
    t0 = time.perf_counter()
    if events:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    grid = build_grid(prices, systems, specs, device=r.device)
    if events:
        ev[1].record()
    rep = backtest(grid, device=r.device)
    host["reduction"].copy_(rep.cpc_reduction)
    host["starts"].copy_(rep.n_starts)
    out = {"latency_s": time.perf_counter() - t0, "policies": policies,
           "p_on": grid.p_on, "p_off": grid.p_off, "cpc": rep.cpc}
    if events:
        out["grid_build_ms"] = ev[0].elapsed_time(ev[1])
    return out


def host_buffers(r: Run, n_rows: int) -> dict:
    pin = r.device.type == "cuda"
    return {k: torch.empty(n_rows, dtype=torch.float32, pin_memory=pin)
            for k in ("reduction", "starts")}


def run(r: Run) -> Outcome:
    cfg, mix = r.cell.config, r.cell.mix
    prices = inputs.prices(cfg, mix, r.seed, r.device)
    systems = inputs.port_systems(cfg)
    warm = r.rng(WARM_STREAM)
    n_pol = int(mix["policies"]["n_drawn"]) + bool(
        mix["policies"].get("always_on"))
    host = host_buffers(r, prices.shape[0] * len(systems) * n_pol)
    for i in range(2):
        request(r, prices, systems,
                inputs.draw_policies(mix["policies"], warm, -1 - i), host)
    r.sync()
    setup_s = time.perf_counter() - r.t0

    draws, pick = r.rng(POLICY_STREAM), r.rng(SAMPLE_STREAM)
    k_sample = int(mix["check_requests"])
    n_traced = int(mix.get("trace_requests", 50)) if r.trace else 0
    sample, lat, build_ms = [], [], []
    failed = n = 0

    def one() -> bool:
        nonlocal failed, n
        pols = inputs.draw_policies(mix["policies"], draws, n)
        try:
            out = request(r, prices, systems, pols, host,
                          events=r.trace and r.device.type == "cuda")
        except RuntimeError as e:     # a request the port failed
            print(f"perfbench: request {n} failed: {e}", file=sys.stderr)
            failed += 1
            return False
        lat.append(out["latency_s"])
        if "grid_build_ms" in out:
            build_ms.append(out["grid_build_ms"])
        # reservoir sample of the requests, seeded
        j = n if n < k_sample else int(pick.integers(n + 1))
        if j < k_sample:
            out.update({k: v.numpy().copy() for k, v in host.items()})
            if j == len(sample):
                sample.append(out)
            else:
                sample[j] = out
        n += 1
        return True

    # the traced requests run before the window: stopping the profiler
    # takes seconds that no request of the window should wait on
    with Tracer(n_traced > 0, r.sync) as tracer:
        ok = all(one() for _ in range(n_traced))
    n_traced = n
    t_start = time.perf_counter()
    while ok and one() and time.perf_counter() - t_start < r.seconds:
        pass
    window_s = time.perf_counter() - t_start
    peak = memory_peak(r.device)
    tr = tracer.result()
    b = prices.shape[0] * len(systems) * (len(sample[0]["policies"])
                                          if sample else 0)
    years = prices.shape[1] * float(cfg.get("dt_h", 1.0)) / 8760.0
    in_window = lat[n_traced:]
    e2e = {"scenario_years_per_s": b * years * len(in_window) / window_s,
           "sweep_p95_ms": 1e3 * float(np.percentile(in_window, 95))
           if in_window else float("nan")}
    shape = {"rows": b, "hours": prices.shape[1], "markets": prices.shape[0],
             "traced_requests": n_traced}
    spans = {"grid_build_ms": build_ms}
    t_check = time.perf_counter()
    checks = check(r, prices, sample) if sample else {}
    check_s = time.perf_counter() - t_check
    return Outcome(setup_s=setup_s, window_s=window_s, attempted=n + failed,
                   failed=failed, e2e=e2e, checks=checks,
                   memory_peak_bytes=peak, shape=shape, spans=spans,
                   trace=tr, check_s=check_s)


def reference_request(r: Run, prices: torch.Tensor, policies: list[dict],
                      dtype) -> dict:
    """The reference's thresholds [B] and CPC, reduction and starts [B]
    of one request's rows. The state machine runs once per (market,
    policy): systems differ only in the costs."""
    systems = inputs.systems(r.cell.config, prices.shape[1])
    rows = ref_grid.rows(prices, systems, policies, dtype)
    n, m, k = prices.shape[0], len(systems), len(policies)
    pair = torch.arange(n * k, device=prices.device)     # (market, policy)
    first = (pair // k) * m * k + pair % k               # its system-0 row
    sums = ref_fleet.hard_sums(
        prices, rows["market"][first], rows["p_on"][first],
        rows["p_off"][first], rows["off_level"][first],
        rows["idle_frac"][first], dtype)
    to_row = rows["market"] * k + rows["policy"]
    sums = {key: v[to_row] for key, v in sums.items()}
    out = ref_fleet.costs(sums, rows["market_price_sum"][rows["market"]],
                          rows["fixed"], rows["power"], rows["period"],
                          rows["restart_energy_mwh"], rows["restart_time_h"],
                          prices.shape[1])
    out["p_on"], out["p_off"] = rows["p_on"], rows["p_off"]
    return out


def _mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def check(r: Run, prices: torch.Tensor, sample: list,
          dtype=torch.float64) -> dict:
    lim = r.cell.limits
    thr, starts, cpc, red = 0, 0, 0.0, 0.0
    for req in sample:
        want = reference_request(r, prices, req["policies"], dtype)
        thr += _mismatches(req["p_on"], want["p_on"]) \
            + _mismatches(req["p_off"], want["p_off"])
        starts += int(np.sum(req["starts"] != want["starts"].cpu().numpy()))
        g = (req["cpc"].double() - want["cpc"].double()).abs() \
            / want["cpc"].double().abs()
        cpc = max(cpc, float(torch.nan_to_num(g, nan=np.inf).max()))
        red = max(red, float(np.nanmax(np.abs(
            req["reduction"].astype(np.float64)
            - want["reduction"].double().cpu().numpy()))))
    return {"threshold_mismatches": (thr, lim["threshold_mismatches"]),
            "start_mismatches": (starts, lim["start_mismatches"]),
            "cpc_gap": (cpc, lim["cpc_gap"]),
            "reduction_gap": (red, lim["reduction_gap"])}
