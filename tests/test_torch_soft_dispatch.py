"""The relaxed (entropic) water-fill: the port's plain soft-dispatch
forward, its residual-emitting forward and its hand-written backward
against the JAX reference on the same numpy inputs, plus float64 checks of
the hand-written adjoint and the port's routing. Everything runs on the CPU,
where the three soft-dispatch wrappers run their plain versions; the CUDA
kernels are held against the same plain versions in
`tests/test_torch_gpu.py` and `chip_smoke.py`.

Tolerances, and why:
- Allocations within 1e-5 MW (sites of 0.2-3 MW) and dwell states within
  1e-4 (counts up to 6). The port evaluates exp in float64 and rounds once,
  and sums every reduction in float64; the reference uses float32 exp and
  float32 sums. A bisection step then compares differently in the last
  bits near the root, which the Newton step absorbs to ~1e-7 MW.
- Bisected levels within 1e-3 EUR/MWh (1e-5 of prices of ~100; seen
  1.4e-4): the bisection resolves 80 tau / 2^30, but where the fill's slope
  is small a rounding-level change of the sum moves the level further.
- Gradients: each output within 1e-4 of the largest magnitude of the
  reference's same output, or of the cotangent where that is larger (seen:
  2e-6), because the adjoint chains float32 products over up to 96 hours.
  With one site the allocation is the demand whatever the availability, so
  d avail, d keys and d tau are rounding noise on both sides.
- A zero-demand hour: the reference's float32 renormalisation adjoint is
  0/0 there (its Pallas backward pads with ones for that reason), and the
  NaN flows back to every earlier hour. The port forms it in float64: its
  gradients are finite, equal to the reference's after the last zero hour,
  and to its own float64 run everywhere.
- A flat demand under dwell locks at a low temperature (the third of the
  reference's `SOFT_CASES`: 8 sites, dwell 6, tau 0.5) is compared hour by
  hour from the reference's own entering state, not as a whole run: every
  hour, the locked widths sum to the demand to within rounding, so the
  level lies in a gap between segment keys and the Newton step divides by
  a vanishing slope (clipped at 40 tau); the last bit of the residual then
  moves O(1) MW and the dwell ledger carries it forward, in the port
  against itself in float64 as much as against the reference. The
  backward in such hours divides by the floored slope (1e-30), so its
  gradients are compared on the other cases only. ROADMAP queue 3 records
  this.
- Float64 checks (torch only): the hand-written hour adjoint equals
  autograd through `soft_dispatch_hour_fixed` within 1e-12 of the output
  scale; `gradcheck` of the fused VJP at its defaults.
- The kernels' restructurings in their plain mirrors: the bisection taken
  k levels of the tree a round (`_bisect_level_tree`) equals the
  sequential one bit for bit, flat-locked gap hour included; the two-pass
  backward (`soft_dispatch_bwd_two_pass_ref`) equals the hour-by-hour one
  bit for bit in float32, and in float64 on continuous availabilities is
  within the gradient tolerance above of the reference's oracle.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dispatch import segment_keys as jax_segment_keys  # noqa: E402
from repro.dispatch import segment_rank as jax_segment_rank  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import soft_dispatch as jsd  # noqa: E402
from repro_torch.dispatch import (DispatchProblem, dispatch,  # noqa: E402
                                  segment_keys, segment_rank,
                                  summarize_alloc)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import soft_dispatch as sd  # noqa: E402

# (S, T, migrate_cost, min_dwell, tau): the reference's SOFT_CASES
# (tests/test_soft_dispatch.py) with T cut to at most 96 hours
SOFT_CASES = [(1, 64, 0.0, 0, 5.0), (5, 96, 5.0, 0, 2.0),
              (8, 96, 5.0, 6, 0.5), (16, 96, 3.0, 3, 20.0)]
WELL_POSED = [SOFT_CASES[i] for i in (0, 1, 3)]     # not the flat locked one
ALLOC_ATOL, DWELL_ATOL, LAM_ATOL, GRAD_REL = 1e-5, 1e-4, 1e-3, 1e-4

_jax_fwd = jax.jit(jsd._xla_fused_fwd, static_argnames=("min_dwell",
                                                        "n_bisect"))
_jax_bwd = jax.jit(jsd._xla_fused_bwd, static_argnames=("min_dwell",))


def _case(s, t, mc, seed=0, zero_hours=()):
    """The reference's `_random_case`: normal prices, sites of 1-3 MW at
    20% or 100% availability, a flat demand at half the leanest hour."""
    r = np.random.default_rng(29 + seed)
    prices = r.normal(80, 40, (s, t)).astype(np.float32)
    power = r.uniform(1.0, 3.0, s).astype(np.float32)
    on = (r.uniform(size=(s, t)) > 0.3).astype(np.float32)
    avail = power[:, None] * (0.2 + 0.8 * on)
    demand = np.full(t, 0.5 * float(avail.sum(axis=0).min()), np.float32)
    demand[list(zero_hours)] = 0.0
    keys = jax_segment_keys(prices, mc).astype(np.float32)
    order, _ = jax_segment_rank(prices, mc)
    return prices, avail, keys, order, demand


def _smooth_case(s, t, mc, seed, zero_hours=()):
    """Continuous random availability and demand: no two hours share an
    availability, so no site holds ``prev == avail`` exactly and no hour's
    demand equals a prefix of its widths."""
    r = np.random.default_rng(seed)
    prices = r.normal(80, 40, (s, t)).astype(np.float32)
    avail = r.uniform(0.5, 2.0, (s, t)).astype(np.float32)
    demand = (r.uniform(0.3, 0.6, t) * avail.sum(axis=0)).astype(np.float32)
    demand[list(zero_hours)] = 0.0
    keys = jax_segment_keys(prices, mc).astype(np.float32)
    order, _ = jax_segment_rank(prices, mc)
    return prices, avail, keys, order, demand


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _inv_taus(tau):
    it = np.float32(1.0) / np.float32(tau)
    return it, it / np.float32(0.05)


def _close_rel(got, want, rel=GRAD_REL, msg="", floor=1e-30):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the plain forward against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", WELL_POSED)
def test_plain_forward_matches_reference_run(case):
    s, t, mc, dwell, tau = case
    _, avail, keys, order, demand = _case(s, t, mc)
    want = np.asarray(jsd._soft_dispatch_ref_jit(
        jnp.asarray(avail), jnp.asarray(keys), order, demand, tau=tau,
        min_dwell=dwell))
    got = ref.soft_dispatch_ref(*_t(avail, keys, order, demand), tau=tau,
                                min_dwell=dwell)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ALLOC_ATOL)
    np.testing.assert_allclose(got.numpy().sum(axis=0), demand, rtol=1e-5)


@pytest.mark.parametrize("case", SOFT_CASES)
def test_plain_hours_match_reference_from_its_states(case):
    """Every hour of the port from the reference's own entering state
    (its allocation of the hour before and its entering dwell)."""
    s, t, mc, dwell, tau = case
    _, avail, keys, order, demand = _case(s, t, mc)
    it, itm = _inv_taus(tau)
    alloc, dwin, lam = (np.asarray(x) for x in _jax_fwd(
        jnp.asarray(avail), jnp.asarray(keys), jnp.asarray(order),
        jnp.asarray(demand), jnp.float32(it), jnp.float32(itm),
        min_dwell=dwell, n_bisect=30))
    prev = np.concatenate([np.zeros((s, 1), np.float32), alloc[:, :-1]], 1)
    worst_a = worst_d = 0.0
    for h in range(t):
        a, d, _ = ref.soft_dispatch_hour_parts(
            *_t(prev[:, h], dwin[:, h], avail[:, h], keys[h], order[h],
                demand[h]), inv_tau=torch.tensor(it),
            inv_tau_mw=torch.tensor(itm), min_dwell=dwell)
        worst_a = max(worst_a, float(np.abs(a.numpy() - alloc[:, h]).max()))
        if h + 1 < t:
            worst_d = max(worst_d,
                          float(np.abs(d.numpy() - dwin[:, h + 1]).max()))
    assert worst_a <= ALLOC_ATOL and worst_d <= DWELL_ATOL


# the reference's Pallas kernels run in interpret mode here: 48 hours; the
# last case has a varying demand (its level is never in a gap) with two
# zero-demand hours
PALLAS_CASES = [(1, 48, 0.0, 0, 5.0, ()), (5, 48, 5.0, 0, 2.0, ()),
                (16, 48, 3.0, 3, 20.0, ()), (4, 48, 4.0, 3, 3.0, (5, 17))]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_fused_forward_matches_reference_pallas_kernels(case):
    s, t, mc, dwell, tau, zero = case
    _, avail, keys, order, demand = (
        _smooth_case(s, t, mc, seed=11, zero_hours=zero) if zero
        else _case(s, t, mc))
    it, itm = _inv_taus(tau)
    alloc, dwin, lam = ref.soft_dispatch_fwd_ref(
        *_t(avail, keys, order, demand), torch.tensor(it),
        torch.tensor(itm), min_dwell=dwell)
    want = np.asarray(jsd.soft_dispatch_pallas(
        avail, keys, order, demand, tau=tau, min_dwell=dwell,
        interpret=True))
    np.testing.assert_allclose(alloc.numpy(), want, rtol=0, atol=ALLOC_ATOL)
    j_alloc, j_dwin, j_lam = jsd._fused_primal(
        jnp.asarray(avail), jnp.asarray(keys), order, jnp.asarray(demand),
        jnp.float32(tau), dwell, 0.05, 30, 512, True, True)
    np.testing.assert_allclose(alloc.numpy(), np.asarray(j_alloc), rtol=0,
                               atol=ALLOC_ATOL)
    np.testing.assert_allclose(dwin.numpy(), np.asarray(j_dwin), rtol=0,
                               atol=DWELL_ATOL)
    live = demand > 0          # a zero-demand hour's level is arbitrary
    np.testing.assert_allclose(lam.numpy()[live], np.asarray(j_lam)[live],
                               rtol=0, atol=LAM_ATOL)
    assert np.all(alloc.numpy()[:, ~live] == 0.0)


# ---------------------------------------------------------------------------
# the backward against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", WELL_POSED)
def test_plain_backward_matches_reference_from_its_residuals(case):
    """The reversed-time chain of hand-written hour adjoints against the
    reference's (`jax.vjp` of each hour) on the reference's residuals."""
    s, t, mc, dwell, tau = case
    _, avail, keys, order, demand = _case(s, t, mc)
    g = np.random.default_rng(5).normal(size=(s, t)).astype(np.float32)
    it, itm = _inv_taus(tau)
    res = _jax_fwd(jnp.asarray(avail), jnp.asarray(keys), jnp.asarray(order),
                   jnp.asarray(demand), jnp.float32(it), jnp.float32(itm),
                   min_dwell=dwell, n_bisect=30)
    want = _jax_bwd(jnp.asarray(avail), jnp.asarray(keys),
                    jnp.asarray(demand), jnp.float32(it), jnp.float32(itm),
                    *res, jnp.asarray(g), min_dwell=dwell)
    got = ref.soft_dispatch_bwd_ref(
        *_t(avail, keys, demand), torch.tensor(it), torch.tensor(itm),
        *_t(*(np.asarray(x) for x in res), g), min_dwell=dwell)
    for name, a, b in zip(("d_avail", "d_keys", "d_demand", "d_itau",
                           "d_itau_mw"), got, want):
        if name == "d_itau_mw" and dwell == 0:
            assert float(a) == float(b) == 0.0
            continue
        _close_rel(a.numpy(), b, msg=name, floor=float(np.abs(g).max()))


@pytest.mark.parametrize("case", WELL_POSED)
def test_grad_oracle_matches_reference(case):
    s, t, mc, dwell, tau = case
    _, avail, keys, order, demand = _case(s, t, mc)
    g = np.random.default_rng(6).normal(size=(s, t)).astype(np.float32)
    want = jref.soft_dispatch_grad_ref(jnp.asarray(avail), jnp.asarray(keys),
                                       order, demand, g, tau=tau,
                                       min_dwell=dwell)
    got = ref.soft_dispatch_grad_ref(*_t(avail, keys, order, demand, g),
                                     tau=tau, min_dwell=dwell)
    if s == 1:
        # one site takes the whole demand: d avail, d keys and d tau are
        # zero up to rounding on both sides; d demand is g itself
        np.testing.assert_allclose(got[2].numpy(), g[0], rtol=1e-5)
        for a in (got[0], got[1], got[3]):
            assert float(a.abs().max()) <= 1e-6 * float(np.abs(g).max())
        return
    for name, a, b in zip(("d_avail", "d_keys", "d_demand", "d_tau"), got,
                          want):
        _close_rel(a.numpy(), b, msg=name)


def test_fused_gradients_match_jax_grad_through_pallas():
    """The port's fused VJP (plain versions on the CPU) against `jax.grad`
    through the reference's fused Pallas pair in interpret mode."""
    prices, avail, keys, order, demand = _smooth_case(4, 48, 4.0, seed=7)
    tau, dwell = 3.0, 3

    def jloss(a, d, tt):
        x = jsd.soft_dispatch_fused(a, keys, order, d, tau=tt,
                                    min_dwell=dwell, use_pallas=True,
                                    interpret=True)
        return jnp.sum(x * prices)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(avail), jnp.asarray(demand), jnp.float32(tau))
    a, d = (x.clone().requires_grad_(True) for x in _t(avail, demand))
    tt = torch.tensor(tau, dtype=torch.float32, requires_grad=True)
    out = sd.soft_dispatch(a, torch.as_tensor(keys), torch.as_tensor(order),
                           d, tau=tt, min_dwell=dwell, fused=True)
    torch.sum(out * torch.as_tensor(prices)).backward()
    for name, x, w in (("d_avail", a.grad, want[0]),
                       ("d_demand", d.grad, want[1]),
                       ("d_tau", tt.grad, want[2])):
        _close_rel(x.numpy(), w, msg=name)


def _hour(seed, *, tie=False, s=5):
    r = np.random.default_rng(seed)
    prices = r.normal(80, 40, (s, 1))
    keys = segment_keys(prices, 4.0)[0]
    order = segment_rank(prices, 4.0)[0][0]
    avail = r.uniform(0.5, 2.0, s)
    prev = r.uniform(0.0, 2.0, s)
    if tie:
        prev[:2] = avail[:2]          # held = min(prev, avail) at a tie
    dwell = r.uniform(0.0, 3.0, s)
    return prev, dwell, avail, keys, order, 0.45 * avail.sum()


HOURS = [dict(seed=1), dict(seed=2, tie=True), dict(seed=3, clip=True),
         dict(seed=4, tie=True, clip=True)]


@pytest.mark.parametrize("min_dwell", [0, 3])
@pytest.mark.parametrize("hour", HOURS, ids=["plain", "tie", "clipped",
                                             "tie+clipped"])
def test_hour_grad_matches_reference(hour, min_dwell):
    """Single hours at the bisected level, at a ``prev == avail`` tie, and
    with the level moved 60 tau off (the Newton step clipped)."""
    prev, dwell, avail, keys, order, demand = _hour(hour["seed"],
                                                    tie=hour.get("tie",
                                                                 False))
    tau = 2.0
    it, itm = _inv_taus(tau)
    f32 = [np.asarray(x, np.float32) for x in (prev, dwell, avail, keys)]
    dem = np.float32(demand)
    lam = float(ref.soft_dispatch_hour_parts(
        *_t(*f32, order), torch.tensor(dem), inv_tau=torch.tensor(it),
        inv_tau_mw=torch.tensor(itm), min_dwell=min_dwell)[2])
    if hour.get("clip"):
        lam += 60.0 * tau
    r = np.random.default_rng(hour["seed"] + 50)
    u_a, u_d = (r.normal(size=prev.shape).astype(np.float32)
                for _ in range(2))
    want = jref.soft_dispatch_hour_grad(
        *(jnp.asarray(x) for x in f32), dem, jnp.float32(lam),
        jnp.float32(it), jnp.float32(itm), jnp.asarray(u_a),
        jnp.asarray(u_d), min_dwell=min_dwell)
    got = ref.soft_dispatch_hour_grad(
        *_t(*f32), torch.tensor(dem), torch.tensor(np.float32(lam)),
        torch.tensor(it), torch.tensor(itm), *_t(u_a, u_d),
        min_dwell=min_dwell)
    # one scale for all outputs: near-cancelling adjoints (the Newton
    # step's and the renormalisation's) leave rounding noise of ~1e-7 of
    # the largest adjoint in entries whose exact value is ~0
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, a, w in zip(("d_prev", "d_dwell", "d_avail", "d_keys",
                           "d_demand", "d_itau", "d_itau_mw"), got, want):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)


# ---------------------------------------------------------------------------
# float64, torch only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_dwell", [0, 3])
@pytest.mark.parametrize("hour", HOURS, ids=["plain", "tie", "clipped",
                                             "tie+clipped"])
def test_hour_grad_is_the_transpose_of_the_fixed_hour(hour, min_dwell):
    """The hand-written adjoint against autograd through
    `soft_dispatch_hour_fixed`, in float64."""
    prev, dwell, avail, keys, order, demand = _hour(hour["seed"],
                                                    tie=hour.get("tie",
                                                                 False))
    tau = 2.0
    d64 = [torch.tensor(x, dtype=torch.float64)
           for x in (prev, dwell, avail, keys, demand, 1.0 / tau,
                     1.0 / (tau * 0.05))]
    lam = ref.soft_dispatch_hour_parts(
        *d64[:4], torch.as_tensor(order), d64[4], inv_tau=d64[5],
        inv_tau_mw=d64[6], min_dwell=min_dwell)[2]
    if hour.get("clip"):
        lam = lam + 60.0 * tau
    leaves = [x.clone().requires_grad_(True) for x in d64]
    alloc, dw = ref.soft_dispatch_hour_fixed(
        *leaves[:5], lam, leaves[5], leaves[6], min_dwell=min_dwell)
    r = np.random.default_rng(hour["seed"] + 70)
    u_a, u_d = (torch.tensor(r.normal(size=prev.shape)) for _ in range(2))
    auto = torch.autograd.grad((alloc * u_a).sum() + (dw * u_d).sum(),
                               leaves, allow_unused=True)
    hand = ref.soft_dispatch_hour_grad(*d64[:5], lam, d64[5], d64[6], u_a,
                                       u_d, min_dwell=min_dwell)
    scale = max(float(h.abs().max()) for h in hand)
    for h, a in zip(hand, auto):
        a = torch.zeros_like(h) if a is None else a
        torch.testing.assert_close(h, a.to(h.dtype), rtol=0,
                                   atol=1e-12 * scale)


@pytest.mark.parametrize("min_dwell", [0, 2])
def test_fused_vjp_gradcheck_float64(min_dwell):
    _, avail, keys, order, demand = _smooth_case(3, 10, 4.0, seed=3)
    a, d = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
            for x in (avail, demand))
    tt = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    k = torch.tensor(keys, dtype=torch.float64, requires_grad=True)
    o = torch.as_tensor(order)
    assert torch.autograd.gradcheck(
        lambda a_, k_, d_, t_: sd.soft_dispatch_fused(
            a_, k_, o, d_, tau=t_, min_dwell=min_dwell),
        (a, k, d, tt), eps=1e-6, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("min_dwell", [0, 3])
def test_fused_and_native_gradients_agree_float64(min_dwell):
    prices, avail, keys, order, demand = _smooth_case(4, 24, 4.0, seed=9)
    grads = []
    for fused in (False, True):
        a, k, d = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                   for x in (avail, keys, demand))
        tt = torch.tensor(2.5, dtype=torch.float64, requires_grad=True)
        out = sd.soft_dispatch(a, k, torch.as_tensor(order), d, tau=tt,
                               min_dwell=min_dwell, fused=fused)
        grads.append((out.detach(), *torch.autograd.grad(
            torch.sum(out * torch.as_tensor(prices, dtype=torch.float64)),
            (a, k, d, tt))))
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("lam_other,demand,in_gap", [
    (75.0, 1.0, True),     # the fill is 1 MW, the demand, from 50 to 100
    (110.0, 1.0, False),   # key 100 lies between the levels
    (75.0, 0.9, False),    # flat, but not at the demand
    (70.0 + 2e-3, 1.0, True),
])
def test_level_in_gap_needs_a_flat_fill_at_the_demand(lam_other, demand,
                                                      in_gap):
    """Two fresh sites of 1 MW keyed at 50 and 100 at tau 0.5, and a
    level at 70: another level may differ from it only where the fill is
    flat at the demand between the two. The zero-width segments' keys
    (72) bound no step of the fill."""
    zero = torch.zeros(2)
    keys = torch.tensor([72.0, 72.0, 72.0, 72.0, 50.0, 100.0])
    got = ref.soft_level_in_gap(zero, zero, torch.ones(2), keys,
                                torch.tensor(demand), torch.tensor(70.0),
                                torch.tensor(lam_other), torch.tensor(2.0),
                                min_dwell=0)
    assert got is in_gap


# ---------------------------------------------------------------------------
# the kernels' two restructurings, in their plain mirrors: the bisection k
# levels a round, and the backward's coefficient pass ahead of its chain
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _run(case_index):
    """The plain forward's residuals on a `SOFT_CASES` case (its entering
    states), with its inputs, as torch tensors."""
    s, t, mc, dwell, tau = SOFT_CASES[case_index]
    _, avail, keys, order, demand = _case(s, t, mc)
    it, itm = _inv_taus(tau)
    x = _t(avail, keys, order, demand)
    res = ref.soft_dispatch_fwd_ref(*x, torch.tensor(it), torch.tensor(itm),
                                    min_dwell=dwell)
    return x, res, torch.tensor(it), dwell


def _bisection_hour(case_index, h):
    """(keys, widths, demand, hard level) of hour h of a case, from the plain
    forward's entering state, as `soft_dispatch_hour_parts` forms them."""
    (avail, keys, order, demand), (alloc, dwin, _), it, dwell = \
        _run(case_index)
    prev = alloc[:, h - 1] if h > 0 else torch.zeros_like(alloc[:, 0])
    widths = ref._hour_widths(prev, dwin[:, h], avail[:, h], inv_tau=it,
                              min_dwell=dwell)
    o = order[h].long()
    cums = torch.cumsum(widths[o].double(), 0)
    below = torch.sum(cums < demand[h].double())
    lam0 = keys[h][o][torch.clamp(below, max=keys.shape[1] - 1)]
    return keys[h], widths, demand[h], lam0, it


# an hour of each of the four soft cases, and hour 13 of the flat-locked
# third one, where the fill is flat at the demand about the level
BISECTION_HOURS = [(0, 32), (1, 48), (2, 48), (3, 48), (2, 13)]


def test_the_flat_locked_hour_is_a_gap_of_the_fill():
    (avail, keys, _, demand), (alloc, dwin, lam), it, dwell = _run(2)
    assert ref.soft_level_in_gap(alloc[:, 12], dwin[:, 13], avail[:, 13],
                                 keys[13], demand[13], lam[13] - 0.5,
                                 lam[13] + 0.5, it, min_dwell=dwell)


@pytest.mark.parametrize("n_bisect", [0, 1, 7, 30, 31])
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_bisection_by_rounds_of_levels_equals_the_sequential_one(levels,
                                                                  n_bisect):
    """The forward kernel's bisection, k levels of the tree a round, in its
    plain mirror: the same level as `_bisect_level`, bit for bit."""
    for case_index, h in BISECTION_HOURS:
        keys, widths, demand, lam0, it = _bisection_hour(case_index, h)
        want = ref._bisect_level(keys, widths, demand, lam0, it,
                                 n_bisect=n_bisect)
        got = ref._bisect_level_tree(keys, widths, demand, lam0, it,
                                     n_bisect=n_bisect, levels=levels)
        assert torch.equal(got, want), (case_index, h, float(got),
                                        float(want))


@pytest.mark.parametrize("case", SOFT_CASES + [(8, 60, 5.0, 4, 3.0)])
def test_two_pass_backward_equals_the_hour_by_hour_one(case):
    """The backward kernels' two passes in their plain mirror (every hour's
    coefficients at once, then the chain) against `soft_dispatch_bwd_ref`
    on the plain forward's residuals, float32: equal bit for bit (both
    sum each hour's short rows in order on the CPU). The last case has
    zero-demand hours."""
    s, t, mc, dwell, tau = case
    zero = (0, 5, 6) if t == 60 else ()
    _, avail, keys, order, demand = (_smooth_case(s, t, mc, seed=3,
                                                  zero_hours=zero)
                                     if zero else _case(s, t, mc))
    g = np.random.default_rng(8).normal(size=(s, t)).astype(np.float32)
    it, itm = (torch.tensor(x) for x in _inv_taus(tau))
    x = _t(avail, keys, order, demand)
    res = ref.soft_dispatch_fwd_ref(*x, it, itm, min_dwell=dwell)
    args = (x[0], x[1], x[3], it, itm, *res, torch.as_tensor(g))
    want = ref.soft_dispatch_bwd_ref(*args, min_dwell=dwell)
    got = ref.soft_dispatch_bwd_two_pass_ref(*args, min_dwell=dwell)
    for name, a, b in zip(("d_avail", "d_keys", "d_demand", "d_itau",
                           "d_itau_mw"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("case", [(5, 48, 5.0, 0, 2.0), (16, 48, 3.0, 3, 20.0),
                                  (4, 48, 4.0, 3, 3.0)])
def test_two_pass_backward_float64_matches_reference(case):
    """The two-pass mirror in float64, on continuous availabilities,
    against the reference's sequential gradient oracle (float32, so within
    GRAD_REL of each output's scale)."""
    s, t, mc, dwell, tau = case
    prices, avail, keys, order, demand = _smooth_case(s, t, mc, seed=21)
    g = np.random.default_rng(9).normal(size=(s, t)).astype(np.float32)
    want = jref.soft_dispatch_grad_ref(jnp.asarray(avail), jnp.asarray(keys),
                                       order, demand, g, tau=tau,
                                       min_dwell=dwell)
    f64 = torch.float64
    a, k, d, gg = (torch.tensor(x, dtype=f64) for x in (avail, keys, demand,
                                                         g))
    it = 1.0 / torch.tensor(tau, dtype=f64)
    itm = it / torch.tensor(0.05, dtype=f64)
    res = ref.soft_dispatch_fwd_ref(a, k, torch.as_tensor(order), d, it, itm,
                                    min_dwell=dwell)
    d_av, d_ke, d_de, s_it, s_itm = ref.soft_dispatch_bwd_two_pass_ref(
        a, k, d, it, itm, *res, gg, min_dwell=dwell)
    assert d_av.dtype == f64
    d_tau = -(it ** 2) * s_it - it * itm * s_itm
    for name, x, w in (("d_avail", d_av, want[0]), ("d_keys", d_ke, want[1]),
                       ("d_demand", d_de, want[2]), ("d_tau", d_tau, want[3])):
        _close_rel(x.numpy(), np.asarray(w), msg=name)


# ---------------------------------------------------------------------------
# zero demand, convergence, shed, routing
# ---------------------------------------------------------------------------

def test_zero_demand_hour_forward_and_backward_are_finite():
    prices, avail, keys, order, demand = _smooth_case(4, 24, 4.0, seed=13,
                                                      zero_hours=(0, 6, 7))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        a, d = (torch.tensor(x, dtype=dtype, requires_grad=True)
                for x in (avail, demand))
        tt = torch.tensor(3.0, dtype=dtype, requires_grad=True)
        out = sd.soft_dispatch(a, torch.tensor(keys, dtype=dtype),
                               torch.as_tensor(order), d, tau=tt,
                               min_dwell=3, fused=True)
        assert torch.all(out[:, [0, 6, 7]] == 0.0)
        torch.sum(out * torch.tensor(prices, dtype=dtype)).backward()
        grads[dtype] = (a.grad, d.grad, tt.grad)
        for x in grads[dtype]:
            assert bool(torch.isfinite(x).all())
    for x, y in zip(*grads.values()):
        _close_rel(x.numpy(), y.numpy())
    want = jref.soft_dispatch_grad_ref(
        jnp.asarray(avail), jnp.asarray(keys), order, demand, prices,
        tau=3.0, min_dwell=3)
    assert np.isnan(np.asarray(want[0])[:, :8]).any()   # the reference's
    _close_rel(grads[torch.float32][0].numpy()[:, 8:],
               np.asarray(want[0])[:, 8:], msg="d_avail")
    _close_rel(grads[torch.float32][1].numpy()[8:],
               np.asarray(want[2])[8:], msg="d_demand")


@pytest.mark.parametrize("mc,dwell", [(5.0, 4), (3.0, 8)])
def test_soft_converges_to_hard_cpc(mc, dwell):
    """At tau = 1e-3 the relaxed allocation's CPC matches the port's hard
    dispatch within rel 1e-3, its delivered MWh within rel 1e-5 (the
    reference's `test_soft_converges_to_hard_cpc`, 6 sites x 400 h)."""
    prices, avail, _, _, demand = _case(6, 400, mc)
    keys = segment_keys(prices, mc)
    order, rank = segment_rank(prices, mc)
    prob = DispatchProblem(
        prices=prices, avail_mw=avail, demand_mw=demand,
        power_cap_mw=float("inf"), migrate_cost=mc, min_dwell_h=dwell,
        compute_floor_mwh=0.0, fixed_cost=0.0, order=order, rank=rank)
    hard = dispatch(prob, device="cpu")
    soft = summarize_alloc(prob, sd.soft_dispatch(
        *_t(avail, keys.astype(np.float32), order, demand), tau=1e-3,
        min_dwell=dwell).numpy())
    assert soft.cpc == pytest.approx(hard.cpc, rel=1e-3)
    assert soft.delivered_mwh == pytest.approx(hard.delivered_mwh, rel=1e-5)


def test_soft_shed_matches_reference():
    r = np.random.default_rng(2)
    total = r.uniform(0.0, 10.0, 50).astype(np.float32)
    demand = r.uniform(0.0, 10.0, 50).astype(np.float32)
    for tau in (30.0, 0.3):
        want = np.asarray(jsd.soft_shed(jnp.asarray(total),
                                        jnp.asarray(demand), tau))
        got = sd.soft_shed(*_t(total, demand), tau)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors no kernel is built or launched: every route runs a
    plain version, fused=False keeps autograd through the plain
    operations, and the counters stay where they were."""
    _, avail, keys, order, demand = _case(3, 12, 4.0)
    counters = (sd.soft_dispatch_scan, sd.soft_dispatch_fused_fwd,
                sd.soft_dispatch_fused_bwd)
    before = [fn.launches for fn in counters]
    a = torch.as_tensor(avail).requires_grad_(True)
    k, o, d = _t(keys, order, demand)
    native = sd.soft_dispatch(a, k, o, d, tau=2.0, min_dwell=2)
    assert native.grad_fn is not None
    fused = sd.soft_dispatch(a, k, o, d, tau=2.0, min_dwell=2, fused=True)
    torch.testing.assert_close(native, fused, rtol=0, atol=0)
    fused.sum().backward()
    scan = sd.soft_dispatch_scan(a.detach(), k, o, d, tau=2.0, min_dwell=2)
    torch.testing.assert_close(scan, native.detach(), rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers' input checks (they run before any launch), on
    CPU tensors of the kernels' layout."""
    s, t = 4, 10
    f32 = torch.float32
    avail = torch.rand(s, t)
    keys = torch.rand(t, 3 * s)
    order = torch.zeros(t, 3 * s, dtype=torch.int32)
    demand = torch.rand(t)
    it, itm = torch.ones(1), torch.ones(1)
    sd._check_problem(avail, keys, order, demand, it, itm, 0)
    with pytest.raises(ValueError, match="float32"):
        sd._check_problem(avail.double(), keys, order, demand, it, itm, 0)
    with pytest.raises(ValueError, match="int32"):
        sd._check_problem(avail, keys, order.long(), demand, it, itm, 0)
    with pytest.raises(ValueError, match="contiguous"):
        sd._check_problem(avail, keys.T.contiguous().T, order, demand, it,
                          itm, 0)
    with pytest.raises(ValueError, match=r"\[10, 12\]"):
        sd._check_problem(avail, keys[:, :6], order, demand, it, itm, 0)
    with pytest.raises(ValueError, match="min_dwell"):
        sd._check_problem(avail, keys, order, demand, it, itm, -1)
    with pytest.raises(ValueError, match="1024 sites"):
        sd._check_problem(torch.rand(1025, 2, dtype=f32), keys, order,
                          demand, it, itm, 0)
    with pytest.raises(ValueError, match="inv_tau"):
        sd._check_problem(avail, keys, order, demand, torch.ones(2), itm, 0)
