"""Gradient-tune shutdown policies over a fleet grid, then validate the
tuned thresholds on held-out bootstrap resamples of each market.

The swept policies of `repro_torch.examples.fleet_backtest` only find the
best point *on the grid*; `repro_torch.tune.optimize` relaxes the
hysteresis state machine with annealed sigmoid gates and descends each
row's CPC by Adam — all rows in one loop, the soft scan's forward and
backward in hand-written CUDA kernels on the card — then re-evaluates
hard (tau -> 0). Validation: `repro_torch.energy.block_bootstrap`
resamples each market's trace into held-out pseudo-years; a tuned policy
that only exploited one spike's placement loses its edge there.

With ``--dispatch-soft`` the demo instead contrasts dispatch-aware tuning
(gradients through the relaxed water-fill dispatcher,
``coupling=Coupling(dispatch=...)``, its forward and backward in
hand-written CUDA kernels on the card) against the re-score-only path
(``coupling=Coupling(reeval=...)``): both are hard-scored on feasible
`repro_torch.dispatch.dispatch`, and the per-site threshold table shows the
swing-site effect.

  PYTHONPATH=src python -m repro_torch.examples.tune_policies   # the card
  PYTHONPATH=src python -m repro_torch.examples.tune_policies \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.examples.tune_policies --dispatch-soft

The exit code is the guarantee: 0 when the tuned CPC is no worse than the
best swept policy of its cell on every row (with ``--dispatch-soft``: when
the dispatch-aware fleet CPC is no worse than the re-score-only one).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.tco import make_system
from repro_torch.device import resolve_device
from repro_torch.dispatch import DispatchConfig
from repro_torch.energy import block_bootstrap, region_params
from repro_torch.fleet import PolicySpec, build_grid
from repro_torch.tune import (Coupling, TuneConfig, cell_best_rows, hard_cpc,
                              optimize, problem_from_grid)


def build(args, device=None):
    hours = 400 if args.smoke else 4380
    n_markets = 2 if args.smoke else 4
    markets = [region_params("germany", seed=s) for s in range(n_markets)]
    markets = [mp.replace(n_hours=hours) for mp in markets]
    p_avg = markets[0].p_avg
    psis = (2.0,) if args.smoke else (0.8, 2.0)
    systems = [make_system(psi * hours * 1.0 * p_avg, 1.0, float(hours),
                           device=device) for psi in psis]
    policies = [PolicySpec("always_on"), PolicySpec("x3", x=0.03),
                PolicySpec("x8", x=0.08)]
    if not args.smoke:
        policies += [PolicySpec("x1", x=0.01), PolicySpec("x15", x=0.15),
                     PolicySpec("x5_hyst", x=0.05, hysteresis=0.9)]
    return build_grid(markets, systems, policies,
                      system_names=[f"psi{p}" for p in psis], device=device)


def validate_on_resamples(grid, res, n_resamples: int, seed: int = 123):
    """Held-out check: hard CPC of tuned vs *cell-best* swept params on
    block-bootstrap resamples of each market's trace.

    The baseline per row is the best swept policy of its (market, system)
    cell — judged on the training trace, then deployed on the resample —
    so the comparison is the one an operator faces: tuned thresholds vs
    the best hand-picked policy, both on unseen data."""
    prices = grid.prices.cpu().numpy()
    problem = problem_from_grid(grid)
    dev = grid.prices.device
    best_row = torch.as_tensor(cell_best_rows(grid, res.cpc_swept),
                               device=dev)
    mi = grid.market_idx
    deltas = []
    for r in range(n_resamples):
        resampled = torch.as_tensor(np.stack([
            block_bootstrap(prices[n], 1, block_hours=7 * 24,
                            seed=seed + 1000 * r + n)[0]
            for n in range(prices.shape[0])]), device=dev)
        prob_r = problem._replace(prices=resampled,
                                  price_sum=resampled.sum(dim=1)[mi])
        cpc_tuned = hard_cpc(res.params.p_on, res.params.p_off,
                             res.params.off_level, prob_r)
        cpc_swept = hard_cpc(grid.p_on[best_row], grid.p_off[best_row],
                             grid.off_level[best_row], prob_r)
        deltas.append((1.0 - cpc_tuned.double() / cpc_swept.double())
                      .cpu().numpy())
    return np.stack(deltas)                       # [R, B]


def dispatch_soft_demo(args, device) -> int:
    """Dispatch-aware vs re-score-only on a one-policy-per-site fleet (the
    soft selection is exact with one candidate per site): 4 German market
    draws x 1 system (Psi 0.5) x the 8% policy at off level 0.3, 2190 h
    and 200 steps (``--smoke``: 400 h and 40 steps)."""
    hours = 400 if args.smoke else 2190
    n_sites = 4
    markets = [region_params("germany", seed=s).replace(n_hours=hours)
               for s in range(n_sites)]
    p_avg = markets[0].p_avg
    systems = [make_system(0.5 * hours * 1.0 * p_avg, 1.0, float(hours),
                           device=device)]
    grid = build_grid(markets, systems,
                      [PolicySpec("x8", x=0.08, off_level=0.3)],
                      market_names=[f"de-seed{s}" for s in range(n_sites)],
                      device=device)
    dcfg = DispatchConfig(demand_frac=0.25, migrate_cost=4.0, min_dwell_h=3)
    steps = 40 if args.smoke else 200
    print(f"fleet: {n_sites} sites x {grid.n_hours} h, demand "
          f"{dcfg.demand_frac:.0%} of ratings, fee {dcfg.migrate_cost}, "
          f"dwell {dcfg.min_dwell_h} h; {steps} steps")

    rescore = optimize(grid, TuneConfig(steps=steps,
                                        coupling=Coupling(reeval=dcfg)),
                       device=device)
    aware = optimize(grid, TuneConfig(steps=steps,
                                      coupling=Coupling(dispatch=dcfg)),
                     device=device)
    dr, da = rescore.dispatch, aware.dispatch
    cpc_r = min(dr["cpc_tuned"], dr["cpc_swept"])
    cpc_a = min(da["cpc_tuned"], da["cpc_swept"])

    print(f"\n{'site':10s} {'isolated p_off':>14s} {'aware p_off':>12s} "
          f"{'share iso':>10s} {'share aware':>12s}")
    chosen_r = dr[dr["chosen"]] if dr["chosen"] else None
    chosen_a = da[da["chosen"]] if da["chosen"] else None
    share_r = chosen_r.site_mwh / chosen_r.delivered_mwh \
        if chosen_r is not None else np.full(n_sites, np.nan)
    share_a = chosen_a.site_mwh / chosen_a.delivered_mwh \
        if chosen_a is not None else np.full(n_sites, np.nan)
    for i, name in enumerate(grid.market_names):
        print(f"{name:10s} {float(rescore.params.p_off[i]):14.1f} "
              f"{float(aware.params.p_off[i]):12.1f} "
              f"{share_r[i]:10.1%} {share_a[i]:12.1%}")
    print(f"\nfleet CPC under hard feasible dispatch: re-score-only "
          f"{cpc_r:.3f} ({dr['chosen']}) vs dispatch-aware {cpc_a:.3f} "
          f"({da['chosen']})")
    edge = 1.0 - cpc_a / cpc_r if np.isfinite(cpc_r) else float("nan")
    print(f"dispatch-aware edge: {edge:.3%}")
    return 0 if cpc_a <= cpc_r * (1.0 + 1e-9) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid, few steps (CI)")
    ap.add_argument("--resamples", type=int, default=None)
    ap.add_argument("--fused", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="hand-written soft-scan VJP (default); --no-fused "
                    "uses autograd through the doubling scan")
    ap.add_argument("--dispatch-soft", action="store_true",
                    help="dispatch-aware tuning demo: gradients through "
                    "the relaxed water-fill vs re-score-only, with the "
                    "swing-site threshold table")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record a telemetry run into DIR (comes with the "
                    "telemetry slice)")
    args = ap.parse_args(argv)
    if args.trace:
        raise NotImplementedError(
            "--trace: telemetry comes to the port with the telemetry slice "
            "(ROADMAP queue 1)")
    dev = resolve_device(args.device)
    if args.dispatch_soft:
        return dispatch_soft_demo(args, dev)

    grid = build(args, dev)
    cfg = TuneConfig(steps=40 if args.smoke else 300, fused=args.fused)
    print(f"grid: {grid.n_markets} markets x {grid.n_systems} systems x "
          f"{grid.n_policies} policies = {grid.n_rows} rows x "
          f"{grid.n_hours} h; tuning {cfg.steps} steps, "
          f"tau {cfg.tau_start} -> {cfg.tau_end}, "
          f"{'fused' if cfg.fused else 'native'} VJP")

    res = optimize(grid, cfg, device=dev)
    print(f"soft loss {res.history['loss'][0]:.4f} -> "
          f"{res.history['loss'][-1]:.4f}")
    print(f"improvement vs best swept policy per row: "
          f"mean {res.improvement_vs_best.mean():.3%} "
          f"max {res.improvement_vs_best.max():.3%}  "
          f"(strictly better on "
          f"{(res.cpc < res.cpc_swept_best * (1 - 1e-6)).sum()}"
          f"/{grid.n_rows} rows)")
    print(f"improvement vs each row's own swept policy: "
          f"mean {res.improvement_vs_own.mean():.3%}")

    n_res = args.resamples or (3 if args.smoke else 8)
    deltas = validate_on_resamples(grid, res, n_res)   # [R, B]
    held = deltas.mean(axis=0)
    print(f"\nheld-out ({n_res} block-bootstrap resamples/market): tuned "
          f"vs cell-best swept params on unseen pseudo-years:")
    print(f"  mean improvement {held.mean():.3%}  "
          f"rows improved {(held > 0).mean():.1%}")

    ok = bool(np.all(res.cpc <= res.cpc_swept_best * (1 + 1e-6)))
    if not ok:
        print("ERROR: tuned CPC worse than best swept policy on some row")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
