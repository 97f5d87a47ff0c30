"""The soft ledger pair's kernel arithmetic on the CPU.

`csrc/queue_scan.cu` puts a row's d + 1 slots on the lanes of a warp
segment: each hour's exclusive sums come from the lanes' running sums
and a Hillis-Steele scan, every clip runs at once, the lanes' sums meet
in a butterfly, and the backward splits into a coefficient pass over
every (row, hour) and a reverse chain that is linear in the queue's
adjoint. Their mirrors in `repro_torch.kernels.ref`
(`ledger_seg_plan`, `soft_ledger_fwd_seg_ref`, `soft_ledger_coef_seg_ref`,
`soft_ledger_bwd_seg_ref`: the kernels' order, every operation rounded
once) are held here against the plain hour loops
(`soft_ledger_fwd_ref` / `soft_ledger_bwd_ref`), torch autograd through
them and the JAX reference's soft `queue_scan` with `jax.grad`, at d 0,
1, 4, 9 and 48 (a two-day deadline: 32 lanes, 2 slots a lane), at B 1
and at T 1, with and without prices. Inputs are numpy from a seed.

Tolerances:
  * float64: the mirrors' sums, queue history, final queue, hourly
    series, d cap and d demand within 1e-12 of max(1, the output's
    largest entry) of the plain loops and of the reference (the sums
    are taken in another order);
  * float32 (the tuner's form): the chip's gates, the forward within
    rtol 1e-5 / atol 1e-3 of the plain loop, d cap and d demand within
    1e-4 of max(1, their largest entry) of autograd through it (the
    mirrors take exp / log1p in float32, the plain loop in float64
    rounded once);
  * the hard ledger on integer-valued work: bit for bit (every sum is
    exact);
  * the coefficient pass: each derivative within 1e-12 of autograd of
    `smoothclip` at the plain loop's clip arguments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.queue_scan import queue_scan as jax_queue_scan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BOUND, TAU = 3.0, 0.3
# (rows, hours, deadline)
CASES = [(3, 24, 0), (2, 30, 1), (4, 24, 4), (1, 40, 4), (3, 1, 4),
         (2, 20, 9), (2, 16, 48)]


def _inputs(b, t, d, dtype, *, integer=False):
    rng = np.random.default_rng(100 * b + 10 * t + d)
    if integer:
        a = rng.integers(0, 6, (b, t)).astype(np.float64)
        c = rng.integers(0, 6, (b, t)).astype(np.float64)
        p = np.round(rng.normal(80.0, 20.0, (b, t)))
    else:
        a = rng.uniform(0.0, 1.5, (b, t))
        c = rng.uniform(0.0, 2.0, (b, t))
        p = rng.normal(80.0, 20.0, (b, t))
    g = rng.normal(size=(4, b))
    return [torch.as_tensor(x).to(dtype) for x in (a, c, p, g)] + [
        torch.tensor([TAU], dtype=dtype)]


def _scaled(x, y) -> float:
    if x.numel() == 0:
        return 0.0
    return float((x.double() - y.double()).abs().max()
                 / max(1.0, float(y.double().abs().max())))


@pytest.mark.parametrize("d,plan", [
    (0, (1, 1)), (1, (2, 1)), (4, (8, 1)), (9, (16, 1)), (31, (32, 1)),
    (32, (32, 2)), (48, (32, 2)), (64, (32, 4)), (255, (32, 8)),
    (256, (32, 9)), (700, (32, 22))])
def test_seg_plan(d, plan):
    """The kernels' segment plan: S lanes (the power of 2 >= d + 1) with
    one slot a lane up to d = 31, then 32 lanes and 2, 4 or 8 slots a
    lane in registers, then the slots a lane needs (the memory form)."""
    s, k = ref.ledger_seg_plan(d)
    assert (s, k) == plan
    assert s * k >= d + 1 and 32 % s == 0


@pytest.mark.parametrize("prices", [True, False])
@pytest.mark.parametrize("b,t,d", CASES)
def test_mirrors_match_plain_and_jax_float64(b, t, d, prices):
    a, c, p, g, tau = _inputs(b, t, d, torch.float64)
    p = p if prices else None
    kw = dict(deadline=d, bound=BOUND, prices=p)
    got = ref.soft_ledger_fwd_seg_ref(a, c, tau, hourly=True, **kw)
    want = ref.soft_ledger_fwd_ref(a, c, tau, hourly=True, **kw)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert _scaled(x, y) <= 1e-12
    d_cap, d_dem = ref.soft_ledger_bwd_seg_ref(a, c, tau, got[1], g, **kw)
    w_cap, w_dem = ref.soft_ledger_bwd_ref(a, c, tau, want[1], g, **kw)
    assert _scaled(d_cap, w_cap) <= 1e-12
    assert _scaled(d_dem, w_dem) <= 1e-12
    with jax.enable_x64(True):
        pj = None if p is None else p.numpy()

        def jloss(av, cv):
            o = jax_queue_scan(av, cv, deadline=d, bound=BOUND, tau=TAU,
                               prices=pj)
            sums = (o.served, o.dropped, o.backlog, o.served_cost)
            return sum(jnp.sum(jnp.asarray(g[k].numpy()) * v)
                       for k, v in enumerate(sums)), sums
        (_, j_sums), (j_a, j_c) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(a.numpy()),
                                                 jnp.asarray(c.numpy()))
    for k in range(4):
        assert _scaled(got[0][k], torch.as_tensor(np.array(j_sums[k]))) \
            <= 1e-12
    assert _scaled(d_cap, torch.as_tensor(np.array(j_c))) <= 1e-12
    assert _scaled(d_dem, torch.as_tensor(np.array(j_a))) <= 1e-12


@pytest.mark.parametrize("b,t,d", CASES)
def test_mirrors_float32_within_the_chip_gates(b, t, d):
    """Float32, the tuner's form: the forward within rtol 1e-5 / atol 1e-3
    of the plain loop, d cap and d demand within 1e-4 of max(1, their
    largest entry) of autograd through it (with prices)."""
    a, c, p, g, tau = _inputs(b, t, d, torch.float32)
    kw = dict(deadline=d, bound=BOUND, prices=p)
    sums, hist, _, _ = ref.soft_ledger_fwd_seg_ref(a, c, tau, **kw)
    d_cap, d_dem = ref.soft_ledger_bwd_seg_ref(a, c, tau, hist, g, **kw)
    at, ct = (x.clone().requires_grad_(True) for x in (a, c))
    out = ref.queue_scan_ref(at, ct, deadline=d, bound=BOUND, tau=TAU,
                             prices=p)
    plain = (out.served, out.dropped, out.backlog, out.served_cost)
    w_a, w_c = torch.autograd.grad(
        sum((g[k] * v).sum() for k, v in enumerate(plain)), [at, ct])
    for x, y in zip(sums, plain):
        torch.testing.assert_close(x, y.detach(), rtol=1e-5, atol=1e-3)
    assert _scaled(d_cap, w_c) <= 1e-4
    assert _scaled(d_dem, w_a) <= 1e-4


@pytest.mark.parametrize("b,t,d", CASES)
def test_hard_mirror_bit_for_bit_on_integer_work(b, t, d):
    """The hard forward (the live replay's ledger) in float64 and float32
    on integer-valued work, with integer prices: every output equal to
    the plain loop's."""
    for dtype in (torch.float64, torch.float32):
        a, c, p, _, _ = _inputs(b, t, d, dtype, integer=True)
        kw = dict(deadline=d, bound=BOUND, prices=p, hard=True,
                  hourly=True)
        got = ref.soft_ledger_fwd_seg_ref(a, c, None, **kw)
        want = ref.soft_ledger_fwd_ref(a, c, None, **kw)
        assert got[1] is None and want[1] is None
        for i in (0, 2, 3):
            assert torch.equal(got[i], want[i])


@pytest.mark.parametrize("d", [0, 4, 48])
def test_coefficients_are_smoothclip_derivatives(d):
    """The coefficient pass: dz1, dw1 of every serve clip and dz2, dw2 of
    every keep clip equal autograd's derivatives of `smoothclip` at the
    plain loop's arguments (the room before each bucket, the bound's room
    before each survivor), 0 at slot 0's keep and above slot d."""
    b, t = 3, 12
    a, c, _, _, tau = _inputs(b, t, d, torch.float64)
    _, hist, _, _ = ref.soft_ledger_fwd_ref(a, c, tau, deadline=d,
                                            bound=BOUND)
    cf = ref.soft_ledger_coef_seg_ref(a, c, tau, hist, deadline=d,
                                      bound=BOUND)
    s, k = ref.ledger_seg_plan(d)
    assert cf.shape == (t, b, s, k, 4)
    cf = cf.reshape(t, b, s * k, 4)
    assert torch.equal(cf[:, :, d + 1:], torch.zeros_like(cf[:, :, d + 1:]))
    assert torch.equal(cf[:, :, 0, 2:], torch.zeros_like(cf[:, :, 0, 2:]))
    for h in range(t):
        w = torch.cat([hist[h].flip(-1), a[:, h:h + 1]], -1)
        room = (c[:, h:h + 1] - (torch.cumsum(w, -1) - w)).requires_grad_()
        wg = w.clone().requires_grad_()
        dz1, dw1 = torch.autograd.grad(
            ref.smoothclip(room, wg, tau[0]).sum(), [room, wg])
        assert _scaled(cf[h, :, :d + 1, 0], dz1) <= 1e-12
        assert _scaled(cf[h, :, :d + 1, 1], dw1) <= 1e-12
        if d == 0:
            continue
        u = (w - ref.smoothclip(room, w, tau[0])).detach()[:, 1:]
        za = (BOUND - (torch.cumsum(u, -1) - u)).requires_grad_()
        ug = u.clone().requires_grad_()
        dz2, dw2 = torch.autograd.grad(
            ref.smoothclip(za, ug, tau[0]).sum(), [za, ug])
        assert _scaled(cf[h, :, 1:d + 1, 2], dz2) <= 1e-12
        assert _scaled(cf[h, :, 1:d + 1, 3], dw2) <= 1e-12
