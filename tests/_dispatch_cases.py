"""Dispatch problems for the tests of the dispatch kernel's walk, which
stops at the demand: its plain mirror on the CPU
(`tests/test_torch_dispatch.py`) and the kernel on the card
(`tests/test_torch_gpu.py`). Imports neither JAX nor the reference."""

import numpy as np

from repro_torch.dispatch import segment_rank


def cut_case(kind, s, t, mc, seed):
    """avail [S, T], rank [T, 3S] and demand [T] with hours of ``kind``:
    zero demand, demand above the hour's total, a negative availability
    (the hour walks to the end), integer prices (ties), or none of these
    (demand 30-90% of the total)."""
    rng = np.random.default_rng(seed)
    prices = (rng.integers(20, 30, (s, t)) if kind == "ties"
              else rng.normal(80, 40, (s, t))).astype(np.float32)
    avail = rng.uniform(0.0, 400.0 / s, (s, t)).astype(np.float32)
    total = avail.sum(axis=0)
    demand = rng.uniform(0.3, 0.9, t) * total
    if kind == "zero demand":
        demand[::3] = 0.0
    elif kind == "above total":
        demand[::4] = 1.3 * total[::4]
    elif kind == "negative avail":
        avail[rng.integers(0, s, t // 5), np.arange(0, t, 5)[:t // 5]] = -1.5
    return avail, segment_rank(prices, mc)[1], demand.astype(np.float32)
