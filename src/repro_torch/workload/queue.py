"""Pure-numpy work-ledger oracle: the ground truth the scans replay.

One hour of the ledger, in plain sequential prose (no cumsum idiom, no
vectorised clip — deliberately a *third* implementation, independent of
both the ledger kernels of `repro_torch.kernels.queue_scan` and their
plain versions in `repro_torch.kernels.ref`):

  1. line up the waiting work oldest-first, arrivals last;
  2. serve greedily oldest-first until this hour's capacity is spent;
  3. work that has now waited past ``deadline`` hours drops (deadline
     expiry);
  4. survivors age one hour and re-queue oldest-first while the backlog
     bound has room — overflow drops youngest-first (the work most
     likely to still be retried upstream).

Every MWh is conserved by construction: arrivals + carried-in backlog
== served + dropped + carried-out backlog, hour by hour (exactly, for
integer-valued work in float64, where every sum is exact).

The tests hold the ledger kernels' plain versions against it. The
reference's module as it is: numpy only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LedgerReplay(NamedTuple):
    """Per-hour ledger series of one arrival trace ([T] each)."""

    served: np.ndarray    # MWh served this hour
    dropped: np.ndarray   # MWh dropped (deadline expiry + overflow)
    backlog: np.ndarray   # MWh still queued at end of hour
    q_final: np.ndarray   # [deadline] end-of-run queue, youngest first


def replay_ledger(arrivals, cap, *, deadline: int,
                  bound: float) -> LedgerReplay:
    """Replay the hard hour-granularity work ledger for one trace.

    ``arrivals`` and ``cap`` are [T] MWh per hour (``cap`` broadcasts
    from a scalar). ``deadline`` is the number of *extra* hours work may
    wait after its arrival hour (0 = serve-or-drop the same hour);
    ``bound`` caps the carried backlog in MWh.
    """
    a = np.asarray(arrivals, np.float64)
    if a.ndim != 1:
        raise ValueError("replay_ledger replays ONE [T] trace (got "
                         f"shape {a.shape}); loop rows/draws, or use "
                         "queue_scan for batched traces")
    c = np.broadcast_to(np.asarray(cap, np.float64), a.shape)
    d = int(deadline)
    # q[i] has waited i+1 hours; q[d-1] is one hour from expiry
    q = [0.0] * d
    served = np.zeros(a.shape, np.float64)
    dropped = np.zeros(a.shape, np.float64)
    backlog = np.zeros(a.shape, np.float64)
    for t in range(a.shape[0]):
        work = [q[d - 1 - i] for i in range(d)] + [a[t]]  # oldest first
        rem = c[t]
        unserved = []
        for w in work:
            s = min(rem, w)
            rem -= s
            served[t] += s
            unserved.append(w - s)
        dropped[t] = unserved[0]          # waited past the deadline
        q = []
        kept = 0.0
        for w in unserved[1:]:            # oldest survivor first
            keep = min(w, max(bound - kept, 0.0))
            kept += keep
            dropped[t] += w - keep        # overflow drops youngest
            q.append(keep)
        q = q[::-1]                       # back to youngest-first
        backlog[t] = kept
    return LedgerReplay(served, dropped, backlog,
                        np.asarray(q, np.float64))


def ledger_cost(replay: LedgerReplay, *, slo_penalty_eur_mwh: float,
                voll_eur_mwh: float) -> dict:
    """SLO economics of a replay: deferral priced per MWh-hour of
    carried backlog (on top of the energy actually paid when the work is
    finally served — that part rides the fleet's own bill), drops at the
    VoLL rate of `repro_torch.dispatch.Relief`."""
    deferred = float(np.sum(replay.backlog))
    dropped = float(np.sum(replay.dropped))
    return {
        "served_mwh": float(np.sum(replay.served)),
        "deferred_mwh_h": deferred,
        "dropped_mwh": dropped,
        "defer_cost": slo_penalty_eur_mwh * deferred,
        "drop_cost": voll_eur_mwh * dropped,
    }
