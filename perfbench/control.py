#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place and computed in bfloat16, one step below the float32
that the configurations state, judged by the cell's own check.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

For each seed it builds the cell's inputs as a run does, runs the
program once (one job, or one request) for what the control is judged
beside, replaces the program's compared outputs by the bfloat16
reference's (a tuner job's losses, its replayed rows' final variables
and its CPC; a request's thresholds, CPC, reductions and starts) and
prints each number the check compares, with its limit, and whether the
control came out correct (it has to come out false).
Run on the card at the cell's own size; the benchmark's runs never run
it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CONTROL_DTYPE = "bfloat16"


def control_checks(r, dtype) -> dict:
    """The check's numbers for the control of run ``r``'s cell."""
    from harness import entry_sweep as sweep
    from harness import entry_tune as tune
    from harness import inputs

    mix = r.cell.mix
    if mix["entry"] == "tune":
        st = tune.setup(r)
        prog = tune.job(st)
        prices = st["prices"]
        del st
        fake = dict(prog)
        fake["loss"] = tune.reference_losses(r, prices, dtype)
        idx = tune.replay_rows(r, len(prog["cpc"]))
        if len(idx):
            final = tune.reference_replay(r, prices, idx, dtype)["final"]
            fake["raw"] = {k: v.copy() for k, v in prog["raw"].items()}
            for k in tune.LEAVES:
                fake["raw"][k][idx] = final[k]
        fake["cpc"] = tune.reference_cpc(r, prices, fake["raw"], dtype)
        return tune.check(r, prices, [fake])
    prices = inputs.prices(r.cell.config, mix, r.seed, r.device)
    pols = inputs.draw_policies(mix["policies"], r.rng(sweep.POLICY_STREAM),
                                0)
    want = sweep.reference_request(r, prices, pols, dtype)
    fake = {"policies": pols, "p_on": want["p_on"], "p_off": want["p_off"],
            "cpc": want["cpc"].float(),
            "reduction": want["reduction"].float().cpu().numpy(),
            "starts": want["starts"].float().cpu().numpy()}
    del want
    return sweep.check(r, prices, [fake])


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT / "src")]
    import torch

    from harness import cells, entries

    cell = cells.load(ROOT, json.loads((ROOT / "BENCHMARK.json")
                                       .read_text()), args.workload)
    dtype = getattr(torch, CONTROL_DTYPE)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = entries.make_run(cell, seed=seed, seconds=0.0, trace=False,
                             device=args.device)
        checks = control_checks(r, dtype)
        ok = all(v <= lim for v, lim in checks.values())
        failed_all &= not ok
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": CONTROL_DTYPE, "correct": ok,
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
