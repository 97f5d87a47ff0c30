"""The fleet-scan kernel's composition on the CPU, against the JAX
reference: `repro_torch.kernels.ref.fleet_scan_seg_ref` (the plain mirror
of ``csrc/fleet_scan.cu``: per-run last decisive events, their exclusive
max-scan across the threads, each run's replay from its entering state,
the fixed tree of the sums) against `repro.kernels.fleet_scan.fleet_scan`
in interpret mode and `repro.kernels.ref.fleet_scan_ref`, on the same
numpy inputs; the wrapper's indexed form (``market_idx``) against its
gathered form; and the backtest reading its grid's prices through the
index.

Tolerances: start counts are integral and must match exactly; sums
match the reference's Pallas kernel within rtol 2e-5 / atol 1e-3, its own
kernel tolerance (the mirror adds each thread's hours in float32 and the
threads in float64; the reference sums within and across its time blocks
in float32), and the reference's sequential float32 oracle within rtol
1e-4 (that oracle's own running-sum drift over 8760 hours). In float64 the
mirror is within 1e-12 (relative) of the plain version.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fleet_scan import fleet_scan as jax_fleet_scan  # noqa: E402
from repro.kernels.ref import fleet_scan_ref as jax_fleet_scan_ref  # noqa: E402
from repro_torch.core.tco import make_system  # noqa: E402
from repro_torch.fleet import PolicySpec, backtest, build_grid  # noqa: E402
from repro_torch.fleet import engine  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fleet_scan import fleet_scan  # noqa: E402
from repro_torch.kernels.ref import (FLEET_SCAN_SEGS,  # noqa: E402
                                     FLEET_SCAN_THREADS, fleet_scan_ref,
                                     fleet_scan_seg, fleet_scan_seg_ref)

CPU = torch.device("cpu")
# the reference's sequential float32 oracle adds every hour into one
# running float32 sum, which drifts by up to ~5e-5 relative over 8760 hours
# (a non-dyadic capacity level added 8760 times); its Pallas kernel, which
# sums within and across time blocks, and the float64 plain version are
# held at 2e-5
SEQ_RTOL = 1e-4


def _inputs(b, t, seed, kind="random", hours=1):
    """Prices and parameters (numpy float32). ``kind``: "random";
    "equal_band" (p_on == p_off on every row); "quiet" (rows 0 and 2 never
    leave the band, so they decide nothing and stay on); "last_hour"
    (decisive hours only at the last hour of each run of ``hours``,
    alternately off and on); "inverted" (p_on > p_off on every other
    row)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(80, 40, (b, t))
    p_off = rng.uniform(40, 160, b)
    p_on = p_off * rng.uniform(0.7, 1.0, b)
    if kind == "equal_band":
        p_on = p_off.copy()
        p[:, ::7] = p_on[:, None]           # samples exactly at the band
    elif kind == "quiet":
        p_on, p_off = np.full(b, 50.0), np.full(b, 150.0)
        p[[0, 2]] = rng.uniform(60, 140, (2, t))
    elif kind == "last_hour":
        p_on, p_off = np.full(b, 50.0), np.full(b, 150.0)
        p = rng.uniform(60, 140, (b, t))
        last = np.arange(hours - 1, t, hours)
        p[:, last[0::2]] = 200.0            # off
        p[:, last[1::2]] = 10.0             # on
    elif kind == "inverted":
        p_on[::2] = p_off[::2] * rng.uniform(1.05, 1.3, len(p_on[::2]))
    lvl = rng.uniform(0.0, 0.6, b)
    idle = rng.uniform(0.0, 0.3, b)
    return [np.asarray(a, np.float32) for a in (p, p_on, p_off, lvl, idle)]


def _assert_close(got, want, label, rtol=2e-5):
    np.testing.assert_array_equal(got.n_starts.numpy(),
                                  np.asarray(want.n_starts),
                                  err_msg=f"{label} n_starts")
    for name in want._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name), np.float64),
            np.asarray(getattr(want, name), np.float64),
            rtol=rtol, atol=1e-3, err_msg=f"{label} {name}")


# (B, T, threads, hours, kind): B = 1; T below one window; T not a multiple
# of threads x hours; several windows (carried from one to the next); the
# tuner's and the backtest's lengths at the kernel's own layout, and two
# windows of it (9300 > 256 x 36); rows that
# decide nothing; events in a run's last hour; p_on == p_off
SEG_CASES = [
    (1, 64, 256, None, "random"),
    (5, 333, 32, 3, "random"),
    (4, 1000, 64, 4, "random"),
    (3, 2190, 256, None, "random"),
    (2, 8760, 256, None, "random"),
    (1, 9300, 256, None, "random"),
    (4, 300, 32, 4, "quiet"),
    (3, 400, 32, 5, "last_hour"),
    (3, 1000, 32, 1, "last_hour"),
    (6, 500, 32, 5, "equal_band"),
]


@pytest.mark.parametrize("case", SEG_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_seg_mirror_matches_the_reference(case):
    b, t, threads, hours, kind = case
    args = _inputs(b, t, seed=b * t, kind=kind, hours=hours or 1)
    got = fleet_scan_seg_ref(*(torch.as_tensor(a) for a in args),
                             threads=threads, hours=hours)
    assert got.draw_price_sum.dtype == torch.float32
    _assert_close(got, jax_fleet_scan(*(jnp.asarray(a) for a in args),
                                      interpret=True),
                  f"{case} vs reference Pallas kernel (interpret)")
    _assert_close(got, jax_fleet_scan_ref(*(jnp.asarray(a) for a in args)),
                  f"{case} vs reference ref", rtol=SEQ_RTOL)
    # the same decisions as the port's plain version; float64 within 1e-12
    plain = fleet_scan_ref(*(torch.as_tensor(a) for a in args))
    assert torch.equal(got.n_starts, plain.n_starts)
    f64 = [torch.as_tensor(args[0]).double(),
           *(torch.as_tensor(a) for a in args[1:])]
    seg64, plain64 = (fleet_scan_seg_ref(*f64, threads=threads,
                                         hours=hours),
                      fleet_scan_ref(*f64))
    for g, w in zip(seg64, plain64):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)


def test_quiet_rows_and_last_hour_events_decide_as_built():
    """The constructed cases do what their names say: quiet rows stay on
    with no start; every other last hour of a run is a restart."""
    args = [torch.as_tensor(a) for a in _inputs(4, 300, 1, "quiet")]
    out = fleet_scan_seg_ref(*args, threads=32, hours=4)
    assert float(out.n_starts[0]) == float(out.n_starts[2]) == 0.0
    assert float(out.up_units[0]) == pytest.approx(300.0)
    args = [torch.as_tensor(a) for a in _inputs(3, 400, 1, "last_hour", 5)]
    out = fleet_scan_seg_ref(*args, threads=32, hours=5)
    assert out.n_starts.tolist() == [40.0] * 3


def test_seg_mirror_inverted_band_matches_the_plain_version():
    """An inverted band (p_on > p_off) tests off first, as the port's
    plain version does (the reference's kernel gives on precedence there,
    so only the port's plain version is the oracle)."""
    for threads, hours in ((32, 3), (256, None)):
        args = [torch.as_tensor(a)
                for a in _inputs(6, 777, 5, kind="inverted")]
        got = fleet_scan_seg_ref(*args, threads=threads, hours=hours)
        plain = fleet_scan_ref(*args)
        exact = fleet_scan_ref(args[0].double(), *args[1:])
        assert torch.equal(got.n_starts, plain.n_starts)
        for g, e in zip(got, exact):
            torch.testing.assert_close(g.double(), e, rtol=2e-5, atol=1e-3)


def test_seg_mirror_layout_is_the_kernels():
    """The mirror's default threads and hours a thread are the kernel
    source's, and the hours a thread follow the kernel's rule."""
    src = (build.CSRC / "fleet_scan.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    segs = re.search(r"#define FLEET_SEGS ([\d, ]+)\n", src)[1]
    assert threads == FLEET_SCAN_THREADS
    assert tuple(int(x) for x in segs.split(",")) == FLEET_SCAN_SEGS
    assert fleet_scan_seg(8760) == 36 and fleet_scan_seg(2190) == 9
    assert fleet_scan_seg(64) == 1 and fleet_scan_seg(257) == 2
    assert fleet_scan_seg(20000) == 36
    for threads in (48, 16):
        with pytest.raises(ValueError, match="power of two"):
            fleet_scan_seg_ref(*(torch.as_tensor(a)
                                 for a in _inputs(1, 8, 0)), threads=threads)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_indexed_form_equals_the_gathered_form_on_the_cpu(use_kernel):
    rng = np.random.default_rng(7)
    prices = torch.as_tensor(rng.normal(80, 40, (5, 300)), dtype=torch.float32)
    mi = torch.as_tensor(rng.integers(0, 5, 17))
    _, p_on, p_off, lvl, idle = (torch.as_tensor(a)
                                 for a in _inputs(17, 1, seed=8))
    got = fleet_scan(prices, p_on, p_off, lvl, idle, market_idx=mi,
                     use_kernel=use_kernel)
    want = fleet_scan(prices[mi], p_on, p_off, lvl, idle,
                      use_kernel=use_kernel)
    for g, w in zip(got, want):
        assert g.shape == (17,) and torch.equal(g, w)


def test_indexed_form_checks_its_index():
    prices = torch.zeros((3, 10))
    with pytest.raises(ValueError, match="int64"):
        fleet_scan(prices, 1.0, 2.0, 0.0, 0.0,
                   market_idx=torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        fleet_scan(prices, 1.0, 2.0, 0.0, 0.0,
                   market_idx=torch.zeros((2, 1), dtype=torch.int64))
    with pytest.raises(IndexError):
        fleet_scan(prices, 1.0, 2.0, 0.0, 0.0, market_idx=torch.tensor([3]))
    with pytest.raises(ValueError, match="CUDA"):
        fleet_scan(prices, 1.0, 2.0, 0.0, 0.0, market_idx=torch.tensor([0]),
                   use_kernel=True)


def test_backtest_reads_prices_through_the_index(monkeypatch):
    """The backtest hands the scan its [N, T] markets and the grid's index,
    and gathers no [B, T] block itself."""
    prices = np.random.default_rng(4).lognormal(4.3, 0.5, (3, 400))
    grid = build_grid(prices.astype(np.float32),
                      [make_system(9e4, 1.0, 400.0, device=CPU)],
                      [PolicySpec("ao"), PolicySpec("x2", x=0.02)],
                      device=CPU)
    seen = []

    def spy(p, *args, **kw):
        seen.append((p, kw.get("market_idx")))
        return fleet_scan(p, *args, **kw)
    monkeypatch.setattr(engine, "fleet_scan", spy)
    rep = backtest(grid, device=CPU)
    (p, mi), = seen
    assert p.shape == (3, 400) and torch.equal(p, grid.prices)
    assert torch.equal(mi, grid.market_idx)
    plain = fleet_scan_ref(grid.prices[grid.market_idx], grid.p_on,
                           grid.p_off, grid.off_level, grid.idle_frac)
    assert torch.equal(rep.n_starts, plain.n_starts)
