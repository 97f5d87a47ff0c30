"""The yardstick: published peaks of one NVIDIA H100 SXM and the least
time each measured piece of work needs on it.

Work is counted from the call's shapes: each input byte read once, each
output byte written once, and the float32 operations the algorithm
needs, never from what a kernel happens to load or launch. The least
time is the larger of bytes over the memory bandwidth and operations
over the float32 rate outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
F32 = 4


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def fleet_scan(b: int, t: int, n: int) -> float:
    """The hard backtest's scan of B rows over an [N, T] price block read
    through the int64 row index: the block, the index and four [B]
    policy fields read, four [B] sums written; 10 operations a row-hour
    (two compares, a select, the capacity and draw, four sums)."""
    nbytes = F32 * n * t + b * (8 + 4 * F32) + 4 * F32 * b
    return least_s(nbytes, 10.0 * b * t)


def soft_scan_fwd(b: int, t: int, block_t: int) -> float:
    """The relaxed recurrence forward: prices [B, T] read, states [B, T]
    and the block carries written; ~20 operations a row-hour (two
    sigmoid gates, the affine step)."""
    nb = -(-t // block_t)
    nbytes = F32 * (2 * b * t + b * nb + 2 * b + 1)
    return least_s(nbytes, 20.0 * b * t)


def soft_scan_bwd(b: int, t: int, block_t: int) -> float:
    """Its backward as the tuner calls it (no price gradient): prices and
    the cotangent [B, T] and the carries read, three [B] sums written;
    ~45 operations a row-hour (the gates again, the adjoint, the chain
    rule)."""
    nb = -(-t // block_t)
    nbytes = F32 * (2 * b * t + b * nb + 2 * b + 3 * b + 1)
    return least_s(nbytes, 45.0 * b * t)


def soft_dispatch_fwd(s: int, t: int, n_bisect: int) -> float:
    """The entropic water-fill forward with its residuals: availability,
    keys, order and demand read, allocation, entering dwell and level
    written (36 S T + 8 T bytes); each hour evaluates 3 S segments at
    n_bisect + 2 levels, ~12 operations each."""
    return least_s(36.0 * s * t + 8.0 * t, 12.0 * 3 * s * t * (n_bisect + 2))


def soft_dispatch_bwd(s: int, t: int) -> float:
    """Its backward without key gradients: seven inputs read, the
    availability and demand gradients written (32 S T + 12 T bytes); ~60
    operations a segment-hour."""
    return least_s(32.0 * s * t + 12.0 * t, 60.0 * 3 * s * t)


def tune_step(shape: dict) -> float:
    """The least time of one tuner step's needed work: the soft scan
    forward and backward, plus the soft dispatch forward and backward
    where the step is coupled."""
    b, t, bt = shape["rows"], shape["hours"], shape["block_t"]
    s = soft_scan_fwd(b, t, bt) + soft_scan_bwd(b, t, bt)
    if shape.get("sites"):
        s += soft_dispatch_fwd(shape["sites"], t, shape["n_bisect"]) \
            + soft_dispatch_bwd(shape["sites"], t)
    return s
