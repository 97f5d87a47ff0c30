"""The port's relaxed scan and its fused VJP against the JAX reference:
`repro_torch.kernels.soft_scan` / `soft_scan_vjp` (on the CPU, the plain
blocked versions of the two CUDA kernels) against `repro.kernels.soft_scan`,
the reference's `soft_state_fused` (its blocked XLA path and its Pallas
kernel pair in interpret mode) and the sequential oracles of
`repro.kernels.ref`, on the same numpy inputs.

Tolerances: states within atol 1e-5 (float32 recurrences in another
order); gradients within rtol 1e-4 and atol 1e-5 max|g| (sums over
hours in another order), where g is the gradient of the same kind: the
prices' own, both thresholds' together (one unit, so a threshold whose
gradient nearly cancels is held to the pair's scale), tau's own; the
plain blocked versions against the reference's blocked XLA forward
within atol 1e-6 (the same sequential order). `torch.autograd.gradcheck`
runs in float64.

The segmented mirrors of the CUDA kernels (`soft_scan_fwd_seg_ref`,
`soft_scan_bwd_seg_ref`: windows of nt x L hours, float64 segment maps
and block scans, float32 reruns) are held at the chip's tolerances, on
inputs drawn as `chip_smoke.py` draws its own (tau 3, a positive
cotangent: every hour's threshold terms of one sign, so their sums carry
no cancellation; where they cancel, as at tau 2 with a signed cotangent,
the plain float32 version misses these tolerances by as much): states
and carries within atol 1e-5 of the float64 plain versions and of the
reference's blocked XLA path; d_p within rtol 2e-5 + atol 1e-5
max|d_p|; d_p_on, d_p_off and d_inv_tau within rtol 2e-5. In float64 the mirrors equal the float64 plain versions
within 1e-12 (the same recurrence in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import soft_scan_grad_ref as jax_grad_ref  # noqa: E402
from repro.kernels.ref import soft_scan_ref as jax_soft_scan_ref  # noqa: E402
from repro.kernels.soft_scan import soft_fleet_scan as jax_soft_fleet_scan  # noqa: E402
from repro.kernels.soft_scan import soft_state as jax_soft_state  # noqa: E402
from repro.kernels.soft_scan_vjp import _xla_bwd, _xla_fwd  # noqa: E402
from repro.kernels.soft_scan_vjp import soft_state_fused as jax_fused  # noqa: E402
from repro_torch.kernels.ref import (SOFT_SCAN_MAX_SEG,  # noqa: E402
                                     SOFT_SCAN_THREADS, soft_scan_bwd_ref,
                                     soft_scan_bwd_seg_ref,
                                     soft_scan_fwd_ref,
                                     soft_scan_fwd_seg_ref,
                                     soft_scan_grad_ref, soft_scan_ref,
                                     soft_scan_seg)
from repro_torch.kernels.soft_scan import soft_fleet_scan, soft_state  # noqa: E402
from repro_torch.kernels.soft_scan_vjp import (soft_scan_bwd,  # noqa: E402
                                               soft_scan_fwd,
                                               soft_state_fused)

TAU = 2.0
ODD_SHAPES = [(3, 40, 64),     # T smaller than one block
              (5, 333, 64),    # odd T, partial last block
              (2, 513, 256),   # one hour past a block boundary
              (1, 7, 4)]       # tiny everything


def _case(b, t, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(80, 40, (b, t)).astype(np.float32)
    p_off = rng.uniform(60, 120, b).astype(np.float32)
    p_on = (p_off * rng.uniform(0.7, 1.0, b)).astype(np.float32)
    w = rng.normal(0, 1, (b, t)).astype(np.float32)
    return p, p_on, p_off, w


def _t(*arrays, requires_grad=False):
    return [torch.tensor(a, requires_grad=requires_grad) for a in arrays]


def _close(got, want, *, rtol=0.0, atol=0.0, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("b,t,bt", ODD_SHAPES)
@pytest.mark.parametrize("fused", [False, True], ids=["native", "fused"])
def test_soft_state_matches_reference(fused, b, t, bt):
    p, p_on, p_off, _ = _case(b, t, seed=b + t)
    want = np.asarray(jax_soft_state(p, p_on, p_off, tau=TAU))
    got = soft_state(*_t(p, p_on, p_off), tau=TAU, fused=fused, block_t=bt)
    _close(got.numpy(), want, atol=1e-5, name="s")
    want_fused = np.asarray(jax_fused(p, p_on, p_off, tau=TAU, block_t=bt,
                                      use_pallas=False))
    _close(got.numpy(), want_fused, atol=1e-5, name="s vs xla fused")


@pytest.mark.parametrize("b,t,bt", [(5, 333, 64), (3, 40, 64)])
def test_fused_matches_reference_pallas_kernels_in_interpret_mode(b, t, bt):
    p, p_on, p_off, w = _case(b, t, seed=7)
    want = np.asarray(jax_fused(p, p_on, p_off, tau=TAU, block_t=bt,
                                use_pallas=True, interpret=True))
    got = soft_state_fused(*_t(p, p_on, p_off), tau=TAU, block_t=bt)
    _close(got.numpy(), want, atol=1e-5, name="s")

    def jloss(on_, off_):
        return jnp.sum(w * jax_fused(p, on_, off_, tau=TAU, block_t=bt,
                                     use_pallas=True, interpret=True))
    g_on, g_off = jax.grad(jloss, argnums=(0, 1))(p_on, p_off)
    on_t, off_t = _t(p_on, p_off, requires_grad=True)
    (soft_state_fused(torch.tensor(p), on_t, off_t, tau=TAU, block_t=bt)
     * torch.tensor(w)).sum().backward()
    scale = max(float(np.abs(g_on).max()), float(np.abs(g_off).max()))
    for name, got_g, want_g in (("d_p_on", on_t.grad, g_on),
                                ("d_p_off", off_t.grad, g_off)):
        _close(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
               atol=1e-5 * scale, name=name)


@pytest.mark.parametrize("b,t,bt", ODD_SHAPES)
def test_fused_gradients_match_reference(b, t, bt):
    p, p_on, p_off, w = _case(b, t, seed=3 * b + t)

    def jloss(p_, on_, off_, tau_):
        return jnp.sum(w * jax_fused(p_, on_, off_, tau=tau_, block_t=bt,
                                     use_pallas=False))
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(p, p_on, p_off,
                                                 jnp.float32(TAU))
    leaves = _t(p, p_on, p_off, np.float32(TAU), requires_grad=True)
    (soft_state_fused(leaves[0], leaves[1], leaves[2], tau=leaves[3],
                      block_t=bt) * torch.tensor(w)).sum().backward()
    want = [np.asarray(x) for x in want]
    scales = [np.abs(want[0]).max()] \
        + [max(np.abs(want[1]).max(), np.abs(want[2]).max())] * 2 \
        + [np.abs(want[3]).max()]
    for name, leaf, want_g, scale in zip(
            ("d_p", "d_p_on", "d_p_off", "d_tau"), leaves, want, scales):
        _close(leaf.grad.numpy(), want_g, rtol=1e-4, atol=1e-5 * scale,
               name=name)


def test_fused_gradients_match_native_autograd():
    p, p_on, p_off, w = _case(6, 300, seed=11)
    grads = []
    for fused in (False, True):
        leaves = _t(p, p_on, p_off, np.float32(TAU), requires_grad=True)
        (soft_state(leaves[0], leaves[1], leaves[2], tau=leaves[3],
                    fused=fused, block_t=64) * torch.tensor(w)).sum() \
            .backward()
        grads.append([x.grad.numpy() for x in leaves])
    for name, a, b_ in zip(("d_p", "d_p_on", "d_p_off", "d_tau"), *grads):
        _close(b_, a, rtol=1e-4, atol=1e-5 * np.abs(a).max(), name=name)


def test_soft_state_fused_gradcheck_float64():
    p, p_on, p_off, _ = _case(3, 45, seed=5)
    leaves = [torch.tensor(a.astype(np.float64), requires_grad=True)
              for a in (p, p_on, p_off, np.float64(25.0))]
    assert torch.autograd.gradcheck(
        lambda a, b_, c, d: soft_state_fused(a, b_, c, tau=d, block_t=16),
        leaves)


def test_plain_blocked_versions_match_reference_blocked_forward():
    p, p_on, p_off, w = _case(4, 333, seed=9)
    want_s, want_c = _xla_fwd(jnp.asarray(p), jnp.asarray(p_on),
                              jnp.asarray(p_off), jnp.float32(1.0 / TAU), 64)
    itau = torch.tensor([1.0 / TAU], dtype=torch.float32)
    s, carries = soft_scan_fwd_ref(*_t(p, p_on, p_off), itau, 64)
    _close(s.numpy(), np.asarray(want_s), atol=1e-6, name="s")
    _close(carries.numpy(), np.asarray(want_c), atol=1e-6, name="carries")
    assert carries.shape == (4, 6)

    # the blocked backward against the sequential oracle of both packages
    d_p, d_on, d_off, d_it = soft_scan_bwd_ref(*_t(p, p_on, p_off), itau,
                                               carries, torch.tensor(w), 64)
    want = jax_grad_ref(p, p_on, p_off, w, tau=TAU)
    seq = soft_scan_grad_ref(*_t(p, p_on, p_off, w), tau=TAU)
    d_tau = -(1.0 / TAU) ** 2 * d_it
    for name, got, ref, oracle in zip(
            ("d_p", "d_p_on", "d_p_off", "d_tau"), (d_p, d_on, d_off, d_tau),
            want, seq):
        ref = np.asarray(ref)
        _close(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(),
               name=name)
        _close(oracle.numpy(), ref, rtol=1e-4,
               atol=1e-5 * np.abs(ref).max(), name=f"{name} oracle")


def test_soft_fleet_scan_and_sequential_oracle_match_reference():
    p, p_on, p_off, _ = _case(5, 200, seed=13)
    rng = np.random.default_rng(14)
    lvl = rng.uniform(0.0, 0.6, 5).astype(np.float32)
    idle = rng.uniform(0.0, 0.3, 5).astype(np.float32)
    want = jax_soft_fleet_scan(p, p_on, p_off, lvl, idle, tau=TAU)
    want_seq = jax_soft_scan_ref(p, p_on, p_off, lvl, idle, tau=TAU)
    args = _t(p, p_on, p_off, lvl, idle)
    for fused in (False, True):
        got = soft_fleet_scan(*args, tau=TAU, fused=fused, block_t=64)
        for name, a, b_ in zip(got._fields, got, want):
            _close(a.numpy(), np.asarray(b_), rtol=2e-5, atol=1e-3,
                   name=name)
    got_seq = soft_scan_ref(*args, tau=TAU)
    for name, a, b_ in zip(got_seq._fields, got_seq, want_seq):
        _close(a.numpy(), np.asarray(b_), rtol=2e-5, atol=1e-3, name=name)


def test_wrappers_run_the_plain_version_on_the_cpu_and_count_nothing():
    p, p_on, p_off, w = _case(3, 100, seed=1)
    args = _t(p, p_on, p_off) + [torch.tensor([0.5])]
    before = (soft_scan_fwd.launches, soft_scan_bwd.launches)
    s, carries = soft_scan_fwd(*args, block_t=32)
    soft_scan_bwd(*args, carries, torch.tensor(w), block_t=32)
    assert (soft_scan_fwd.launches, soft_scan_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        soft_scan_fwd(*args, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        soft_scan_bwd(*args, carries, torch.tensor(w), use_kernel=True)


def test_backward_skips_price_gradient_when_prices_need_none():
    p, p_on, p_off, w = _case(2, 90, seed=2)
    on_t = torch.tensor(p_on, requires_grad=True)
    s = soft_state_fused(torch.tensor(p), on_t, torch.tensor(p_off),
                         tau=torch.tensor(3.0), block_t=32)
    (s * torch.tensor(w)).sum().backward()
    assert on_t.grad is not None and bool(torch.isfinite(on_t.grad).all())


# (B, T, block_t, nt, seg): the kernels' layout at small T through small
# windows (seg None: the kernels' own L for nt)
SEG_CASES = [(1, 7, 4, 32, 1),          # B = 1, T < nt, one hour a thread
             (3, 40, 64, 256, None),    # T < nt, block_t >= T
             (4, 333, 48, 32, 4),       # 3 windows, the last ragged
             (2, 513, 100, 64, 3),      # block_t divides no window start
             (2, 1000, 1, 64, 3),       # block_t 1: every hour a carry
             (3, 1300, 2000, 64, 3),    # block_t >= T, 7 windows: sweeps
             (2, 700, 96, 128, None),   # nt 128, L 6, T not a multiple
             (1, 600, 256, 512, None),  # nt 512, L 2
             (2, 2190, 256, 256, None)]  # the tuner's layout: 256 x 9


SEG_TAU = 3.0


def _seg_inputs(b, t, seed, dtype=np.float32):
    """`chip_smoke.py`'s soft-scan inputs: prices, thresholds, inv_tau [1]
    and a positive cotangent g [B, T]."""
    rng = np.random.default_rng(seed)
    p = rng.normal(80, 40, (b, t)).astype(np.float32)
    p_off = rng.uniform(40, 160, b).astype(np.float32)
    p_on = (p_off * rng.uniform(0.7, 1.0, b)).astype(np.float32)
    g = np.random.default_rng(seed + 7).uniform(0.5, 1.5, (b, t))
    itau = np.array([1.0 / SEG_TAU], np.float32)
    return [torch.tensor(a.astype(dtype)) for a in (p, p_on, p_off, itau,
                                                    g)]


def _seg_run(b, t, bt, nt, seg, dtype):
    p, p_on, p_off, itau, g = _seg_inputs(b, t, b + t + bt, dtype)
    s, carries = soft_scan_fwd_seg_ref(p, p_on, p_off, itau, bt, nt=nt,
                                       seg=seg)
    grads = soft_scan_bwd_seg_ref(p, p_on, p_off, itau, carries, g, bt,
                                  nt=nt, seg=seg)
    f64 = [x.double() for x in (p, p_on, p_off, itau)]
    s64, c64 = soft_scan_fwd_ref(*f64, bt)
    exact = soft_scan_bwd_ref(*f64, c64, g.double(), bt)
    return (p, p_on, p_off, itau, g), (s, carries, grads), \
        (s64, c64, exact)


def _hold_chip_tolerances(s, carries, grads, s_w, c_w, want, label):
    _close(s, s_w, atol=1e-5, name=f"{label} s")
    _close(carries, c_w, atol=1e-5, name=f"{label} carries")
    want = [np.asarray(x, np.float64) for x in want]
    _close(grads[0], want[0], rtol=2e-5, atol=1e-5 * np.abs(want[0]).max(),
           name=f"{label} d_p")
    for k, name in ((1, "d_p_on"), (2, "d_p_off"), (3, "d_inv_tau")):
        _close(grads[k], want[k], rtol=2e-5, name=f"{label} {name}")


@pytest.mark.parametrize("b,t,bt,nt,seg", SEG_CASES)
def test_seg_mirrors_match_plain_versions_and_reference(b, t, bt, nt, seg):
    (p, p_on, p_off, itau, g), (s, carries, grads), (s64, c64, exact) = \
        _seg_run(b, t, bt, nt, seg, np.float32)
    assert carries.shape == (b, -(-t // bt))
    _hold_chip_tolerances(s, carries, grads, s64, c64, exact, "plain f64")
    # the reference's blocked XLA path on the same float32 inputs
    j = [jnp.asarray(x.numpy()) for x in (p, p_on, p_off)]
    jt = jnp.asarray(itau.numpy()[0])
    js, jc = _xla_fwd(*j, jt, bt)
    jgrads = _xla_bwd(*j, jt, jc, jnp.asarray(g.numpy()), bt)
    _hold_chip_tolerances(s, carries, grads, np.asarray(js), np.asarray(jc),
                          jgrads, "reference xla")


@pytest.mark.parametrize("b,t,bt,nt,seg", SEG_CASES)
def test_seg_mirrors_in_float64_equal_plain_versions(b, t, bt, nt, seg):
    _, (s, carries, grads), (s64, c64, exact) = _seg_run(b, t, bt, nt, seg,
                                                         np.float64)
    assert s.dtype == torch.float64
    for name, got, want in zip(("s", "carries", "d_p", "d_p_on", "d_p_off",
                                "d_inv_tau"), (s, carries, *grads),
                               (s64, c64, *exact)):
        scale = max(float(want.abs().max()), 1.0)
        _close(got, want, atol=1e-12 * scale, name=name)


def test_seg_mirrors_match_reference_pallas_kernels_in_interpret_mode():
    b, t, bt = 3, 333, 64
    (p, p_on, p_off, itau, g), (s, _, grads), _ = _seg_run(
        b, t, bt, 64, 2, np.float32)
    want_s = jax_fused(p.numpy(), p_on.numpy(), p_off.numpy(),
                       tau=SEG_TAU, block_t=bt, use_pallas=True,
                       interpret=True)
    _close(s, np.asarray(want_s), atol=1e-5, name="s")

    def jloss(p_, on_, off_, tau_):
        return jnp.sum(g.numpy() * jax_fused(p_, on_, off_, tau=tau_,
                                             block_t=bt, use_pallas=True,
                                             interpret=True))
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        p.numpy(), p_on.numpy(), p_off.numpy(), jnp.float32(SEG_TAU))
    d_tau = -float(itau[0]) ** 2 * grads[3].double()
    _close(grads[0], np.asarray(want[0]), rtol=2e-5,
           atol=1e-5 * float(np.abs(want[0]).max()), name="d_p")
    for name, got, w in (("d_p_on", grads[1], want[1]),
                         ("d_p_off", grads[2], want[2]),
                         ("d_tau", d_tau, want[3])):
        _close(got, np.asarray(w), rtol=2e-5, name=name)


def test_seg_layout_covers_each_row_in_as_few_windows_as_fit():
    nt, most = SOFT_SCAN_THREADS, SOFT_SCAN_MAX_SEG
    for t in (1, 31, 256, 2190, 3072, 3073, 4097, 8760, 8761, 20000):
        seg = soft_scan_seg(t)
        nw = -(-t // (nt * seg))
        assert 1 <= seg <= most and nw == -(-t // (nt * most))
        assert seg == 1 or nw * nt * (seg - 1) < t   # no shorter L fits
    assert soft_scan_seg(2190) == 9 and soft_scan_seg(8760) == 12
