"""The hard ledger kernel's arithmetic on the CPU.

`csrc/queue_scan.cu`'s `workload_ledger_kernel` runs the hours in windows
(a window's prices and demand loaded a window ahead, its shutdown states
before its hours), keeps each lane's queue as its inclusive prefix sums
and runs an hour in closed form, and sums the hourly series over the
draws in draw order once a window. Its mirror,
`repro_torch.kernels.ref.workload_ledger_seg_ref` (the kernel's float32
operations in its order, every one rounded once; on the card the kernel
equals it bit for bit), is held here against the plain hour loop
(`workload_ledger_ref`) and the JAX reference's `workload_fleet_scan`, at
d 0, 1, 4 and 9, B 1, T 1, T off the window, and G 1 to 40. Inputs are
numpy from a seed.

Tolerances:
  * integer-valued work (integer demand, capacity and prices, dt 1,
    off level 0): bit for bit against the plain loop (every sum is
    exact), its hourly series too;
  * sampled work: rtol 1e-5 / atol 1e-4 against the plain loop and the
    reference's ledger sums (the closed form rounds in another order);
    the reference's hourly means over rows x draws against the mirror's
    per-row sums reduced in float64, rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.queue_scan import \
    workload_fleet_scan as jax_workload_fleet_scan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BOUND = 3.0
W = ref.LEDGER_WINDOW
# (rows, markets, draws, hours, deadline)
CASES = [(1, 1, 1, 1, 4), (1, 1, 1, 50, 2), (3, 2, 5, W + 1, 0),
         (4, 3, 8, 400, 4), (8, 4, 40, 250, 9), (2, 2, 3, W - 1, 1),
         (5, 5, 1, W, 4), (6, 3, 33, 100, 9)]


def _inputs(b, n, g, t, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        prices = rng.integers(0, 100, (n, t)).astype(np.float32)
        dem = rng.integers(0, 5, (g, t)).astype(np.float32)
        lvl, dt = np.zeros(b, np.float32), np.ones(b, np.float32)
        cmwh = rng.integers(1, 6, b).astype(np.float32)
    else:
        prices = rng.normal(80, 30, (n, t)).astype(np.float32)
        dem = rng.uniform(0, 3, (g, t)).astype(np.float32)
        lvl = rng.uniform(0, 0.5, b).astype(np.float32)
        dt = rng.uniform(0.5, 2, b).astype(np.float32)
        cmwh = rng.uniform(1, 4, b).astype(np.float32)
    p_off = rng.uniform(60, 110, b).astype(np.float32)
    p_on = p_off * np.float32(0.9)
    if integer:
        p_off, p_on = np.round(p_off), np.round(p_on)
    midx = rng.integers(0, n, b)
    return (prices, p_on, p_off, lvl, cmwh, dem, dt), midx


def _torch(arrays, midx):
    return [torch.as_tensor(a) for a in arrays], torch.as_tensor(midx)


@pytest.mark.parametrize("integer", [True, False],
                         ids=["integer", "sampled"])
@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_plain_loop(case, integer):
    """The mirror against `workload_ledger_ref`: the four [B, G] sums and
    the [4, B, T] hourly series, bit for bit on integer work, within
    rtol 1e-5 otherwise; its sums the same with and without the hourly
    series."""
    b, n, g, t, d = case
    arrays, midx = _inputs(b, n, g, t, integer, sum(case))
    args, idx = _torch(arrays, midx)
    kw = dict(deadline=d, bound=BOUND, market_idx=idx)
    got, hr = ref.workload_ledger_seg_ref(*args, hourly=True, **kw)
    got_off, none = ref.workload_ledger_seg_ref(*args, **kw)
    want, hr_w = ref.workload_ledger_ref(*args, hourly=True, **kw)
    assert none is None
    assert hr.shape == (4, b, t) and got.served.shape == (b, g)
    for x, y, z in zip(got, got_off, want):
        assert torch.equal(x, y)
        if integer:
            assert torch.equal(x, z)
        else:
            torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-4)
    if integer:
        assert torch.equal(hr, hr_w)
    else:
        torch.testing.assert_close(hr, hr_w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_the_reference_scan(case):
    """The mirror against the JAX reference's `workload_fleet_scan` (its
    ledger half, on the rows gathered through the index): the [B, G]
    sums within rtol 1e-5, and the reference's hourly means over rows x
    draws against the mirror's per-row hourly sums reduced in float64
    (as `workload_fleet_scan` reduces the kernel's)."""
    b, n, g, t, d = case
    arrays, midx = _inputs(b, n, g, t, False, sum(case) + 1)
    prices, p_on, p_off, lvl, cmwh, dem, dt = arrays
    rows = prices[midx]
    idle = np.zeros(b, np.float32)
    out, hw = jax_workload_fleet_scan(
        jnp.asarray(rows), p_on, p_off, lvl, idle, cmwh, jnp.asarray(dem),
        dt, deadline=d, bound=BOUND, hourly=True)
    args, idx = _torch(arrays, midx)
    got, hr = ref.workload_ledger_seg_ref(
        *args, deadline=d, bound=BOUND, market_idx=idx, hourly=True)
    for x, y in zip(got, (out.served, out.dropped, out.backlog,
                          out.served_cost)):
        torch.testing.assert_close(x, torch.as_tensor(np.array(y)),
                                   rtol=1e-5, atol=1e-4)
    means = (hr.double().sum(1) / (b * g)).to(torch.float32)
    for x, y in zip(means, hw):
        torch.testing.assert_close(x, torch.as_tensor(np.array(y)),
                                   rtol=1e-5, atol=1e-6)


def test_mirror_reads_rows_through_the_index():
    """The mirror's ``market_idx`` form equals its gathered form bit for
    bit (the kernel reads a row's prices through the index)."""
    arrays, midx = _inputs(6, 3, 4, 40, False, 5)
    args, idx = _torch(arrays, midx)
    kw = dict(deadline=4, bound=BOUND, hourly=True)
    got = ref.workload_ledger_seg_ref(*args, market_idx=idx, **kw)
    gathered = [args[0][idx]] + args[1:]
    want = ref.workload_ledger_seg_ref(*gathered, **kw)
    for x, y in zip([*got[0], got[1]], [*want[0], want[1]]):
        assert torch.equal(x, y)
