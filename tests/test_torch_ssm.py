"""The port's Mamba2 slice against the JAX reference: the SSD scan (the
sequential oracle, the kernel's plain version, the model's blockwise
form and the `ops.ssd_scan` entry point), the Mamba2 block, the ssm
family's prefill and decode, its parameters and caches, and the conv tail
of a prompt shorter than the conv. The reference's parameters are carried
across with `params_from_numpy`; everything runs on the CPU at float32,
where `ops.ssd_scan` runs the kernel's plain version. The reference's
Pallas SSD kernel runs in interpret mode, as `tests/test_kernels.py` runs
it.

Tolerances: the SSD scans within 1e-5 of the output's scale (max |y| or
max |h|), absolute: every form sums the same float32 terms in another
order, and at these sizes they agree within 1e-6 (the reference holds its
kernel to 2e-3); the block and the model's logits within 1e-4 (float32
through two layers, as `tests/test_torch_models.py` holds the dense
family); conv and state caches within 1e-5; the port's decode after a
short prompt against the prefill of the longer prompt within 1e-5
(float32 rounding), where the reference's differs by more than 1e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import model, ssm  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

CPU = torch.device("cpu")
SSD_TOL = 1e-5       # of the output's scale
TOL = dict(atol=1e-4, rtol=1e-4)

# B, S, H, P, G, N, chunk: the reference's SSD_CASES (tests/test_kernels.py)
SSD_CASES = [
    (2, 64, 4, 16, 1, 32, 16),
    (1, 128, 8, 32, 2, 16, 32),
    (2, 96, 4, 64, 1, 128, 48),
    (1, 64, 2, 8, 1, 8, 64),      # single chunk
]


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    """The reference tests' distributions: x ~ N(0, 1), dt = 0.1 |N|,
    a = -|N| - 0.1, B and C ~ 0.3 N."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, s, h, p)).astype(f),
            (np.abs(rng.normal(size=(b, s, h))) * 0.1).astype(f),
            (-np.abs(rng.normal(size=(h,))) - 0.1).astype(f),
            (rng.normal(size=(b, s, g, n)) * 0.3).astype(f),
            (rng.normal(size=(b, s, g, n)) * 0.3).astype(f))


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_to_scale(got, want, tol=SSD_TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, \
        f"{what}: max |err| {err:.3g}, scale {scale:.3g}"


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_forms_match_the_reference(case):
    """The port's oracle, plain version, blockwise form and entry point
    against the reference's sequential oracle, Pallas kernel (interpret
    mode) and blockwise form, on the same inputs."""
    b, s, h, p, g, n, l = case
    arrays = _ssd_inputs(b, s, h, p, g, n)
    jin = [jnp.asarray(a) for a in arrays]
    want = {"ssd_ref": jref.ssd_ref(*jin),
            "pallas": jops.ssd_scan(*jin, l),
            "ssd_chunked": jssm.ssd_chunked(*jin, l)}
    tin = _t(arrays)
    got = {"ssd_ref": ref.ssd_ref(*tin),
           "ssd_scan_plain": ref.ssd_scan_plain(*tin, l),
           "ops.ssd_scan": ops.ssd_scan(*tin, l),
           "ssd_chunked": ssm.ssd_chunked(*tin, l)}
    for gname, (gy, gh) in got.items():
        assert gy.dtype == torch.float32 and gh.dtype == torch.float32
        for wname, (wy, wh) in want.items():
            _close_to_scale(gy, wy, what=f"y {gname} vs {wname}")
            _close_to_scale(gh, wh, what=f"h {gname} vs {wname}")


def test_ssd_h0_continuation():
    """Two half-sequence scans chained through h0 equal one full scan, on
    every port form (the property serving's decode relies on)."""
    b, s, h, p, g, n, l = 2, 64, 4, 16, 1, 32, 16
    x, dt, a, bb, cc = _t(_ssd_inputs(b, s, h, p, g, n, seed=1))
    yj, hj = jref.ssd_ref(*(jnp.asarray(t.numpy())
                            for t in (x, dt, a, bb, cc)))
    for fn in (ref.ssd_scan_plain, ops.ssd_scan, ssm.ssd_chunked):
        y1, h1 = fn(x[:, :32], dt[:, :32], a, bb[:, :32], cc[:, :32], l)
        y2, h2 = fn(x[:, 32:], dt[:, 32:], a, bb[:, 32:], cc[:, 32:], l,
                    h1)
        _close_to_scale(torch.cat([y1, y2], dim=1), yj, what=fn.__name__)
        _close_to_scale(h2, hj, what=fn.__name__)
    y1, h1 = ref.ssd_ref(x[:, :40], dt[:, :40], a, bb[:, :40], cc[:, :40])
    y2, h2 = ref.ssd_ref(x[:, 40:], dt[:, 40:], a, bb[:, 40:], cc[:, 40:],
                         h1)
    _close_to_scale(torch.cat([y1, y2], dim=1), yj, what="ssd_ref")


@pytest.mark.parametrize("s", [37, 100])
def test_ssd_length_not_a_multiple_of_the_chunk(s):
    """Zero padding to a chunk multiple is exact (the padded dt is 0): the
    padded forms equal the sequential oracle, and `ops.ssd_scan` equals
    the reference's `ops.ssd_scan`."""
    b, h, p, g, n, l = 2, 4, 16, 2, 16, 16
    arrays = _ssd_inputs(b, s, h, p, g, n, seed=2)
    jin = [jnp.asarray(a) for a in arrays]
    wy, wh = jref.ssd_ref(*jin)
    ky, kh = jops.ssd_scan(*jin, l)
    tin = _t(arrays)
    for fn in (ref.ssd_scan_plain, ops.ssd_scan, ssm.ssd_chunked):
        gy, gh = fn(*tin, l)
        assert tuple(gy.shape) == (b, s, h, p)
        for y, hh, name in ((wy, wh, "ssd_ref"), (ky, kh, "pallas")):
            _close_to_scale(gy, y, what=f"{fn.__name__} vs {name}")
            _close_to_scale(gh, hh, what=f"{fn.__name__} vs {name}")


def test_ssd_plain_version_takes_bf16_inputs_and_casts_them():
    """bf16 x, B and C are converted to float32 first, as the kernel
    converts them on load: the result equals the float32 run on the
    rounded inputs, exactly."""
    x, dt, a, bb, cc = _t(_ssd_inputs(1, 48, 4, 16, 1, 32, seed=3))
    xb, bbb, ccb = (t.to(torch.bfloat16) for t in (x, bb, cc))
    y, h = ref.ssd_scan_plain(xb, dt, a, bbb, ccb, 16)
    y32, h32 = ref.ssd_scan_plain(xb.float(), dt, a, bbb.float(),
                                  ccb.float(), 16)
    assert torch.equal(y, y32) and torch.equal(h, h32)


def test_exp_is_taken_below_the_diagonal_only():
    """With a strongly decaying a (cum reaches -400 in a chunk of 256),
    exp over the whole L x L block overflows above the diagonal; the plain
    version stays finite and equals the sequential oracle."""
    b, s, h, p, g, n, l = 1, 256, 2, 8, 1, 8, 256
    x, dt, a, bb, cc = _t(_ssd_inputs(b, s, h, p, g, n, seed=4))
    dt = torch.full_like(dt, 0.1)
    a = torch.tensor([-16.0, -1.0])
    y, hh = ref.ssd_scan_plain(x, dt, a, bb, cc, l)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hh).all())
    wy, wh = ref.ssd_ref(x, dt, a, bb, cc)
    _close_to_scale(y, wy, what="y")
    _close_to_scale(hh, wh, what="h")


def test_ssd_wrapper_routes_by_device():
    """CPU tensors run the plain version and launch nothing; asking for
    the kernel on CPU tensors raises."""
    x, dt, a, bb, cc = _t(_ssd_inputs(1, 32, 2, 8, 1, 8))
    before = ssd_scan.launches
    y, h = ssd_scan(x, dt, a, bb, cc, 16)
    wy, wh = ref.ssd_scan_plain(x, dt, a, bb, cc, 16)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert ssd_scan.launches == before
    with pytest.raises(ValueError, match="use_kernel"):
        ssd_scan(x, dt, a, bb, cc, 16, use_kernel=True)


# ---------------------------------------------------------------------------
# the Mamba2 block and the ssm family
# ---------------------------------------------------------------------------

JCFG = jinputs.reduced_config(jbase.get_config("mamba2-1.3b"))


def _port_cfg(jcfg):
    return base.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def carried():
    """(reference params, port cfg, port params) of reduced mamba2: 2
    layers, d_model 64, 8 heads of P 16, N 16, chunk 8, conv width 4."""
    jp = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    cfg = _port_cfg(JCFG)
    return jp, cfg, model.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device=CPU)


def _layer0(tree):
    return jax.tree.map(lambda v: v[0], tree)


def test_ssm_block_matches_reference(carried):
    """The full-sequence block (12 positions: one full chunk and a padded
    one), the one-token decode step from a random cache, and
    `ssm_prefill_with_cache`."""
    jp, cfg, params = carried
    jb = _layer0(jp["blocks"]["ssm"])
    tb = {k: v[0] for k, v in params["blocks"]["ssm"].items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    jo, _ = jssm.ssm_block(jnp.asarray(x), jb, JCFG)
    to, none = ssm.ssm_block(torch.as_tensor(x), tb, cfg)
    assert none is None
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)

    jo, jc = jssm.ssm_prefill_with_cache(jnp.asarray(x), jb, JCFG)
    to, tc = ssm.ssm_prefill_with_cache(torch.as_tensor(x), tb, cfg)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(_np(tc.conv), _np(jc.conv), atol=1e-5)
    np.testing.assert_allclose(_np(tc.state), _np(jc.state), atol=1e-5)

    _, nh, hp, n, conv_dim = ssm._dims(cfg)
    conv = rng.normal(size=(2, cfg.ssm_conv - 1, conv_dim)).astype(
        np.float32)
    state = rng.normal(size=(2, nh, hp, n)).astype(np.float32)
    x1 = x[:, :1]
    jo, jc = jssm.ssm_block(jnp.asarray(x1), jb, JCFG,
                            cache=jssm.SSMCache(jnp.asarray(conv),
                                                jnp.asarray(state)))
    to, tc = ssm.ssm_block(torch.as_tensor(x1), tb, cfg,
                           cache=ssm.SSMCache(torch.as_tensor(conv),
                                              torch.as_tensor(state)))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(_np(tc.conv), _np(jc.conv), atol=1e-5)
    np.testing.assert_allclose(_np(tc.state), _np(jc.state), atol=1e-5)


@pytest.mark.parametrize("s", [8, 13])
def test_prefill_and_decode_match_reference(carried, s):
    """Prefill (a whole chunk, and a chunk and a ragged one) then four
    greedy decode steps: the logits and both caches."""
    jp, cfg, params = carried
    rng = np.random.default_rng(s)
    toks = rng.integers(2, JCFG.vocab - 1, (2, s)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, JCFG)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("conv", "state"):
        np.testing.assert_allclose(_np(getattr(tc["ssm"], name)),
                                   _np(getattr(jc["ssm"], name)), atol=1e-5)
    pos = np.array([s, s], np.int32)
    for step in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc,
                                    jnp.asarray(pos), JCFG)
        tl, tc2 = model.decode_step(params, torch.as_tensor(nxt), tc,
                                    torch.as_tensor(pos), cfg)
        assert tc2 is tc                      # updated in place
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_allclose(_np(tc["ssm"].state),
                                   _np(jc["ssm"].state), atol=1e-5)
        pos = pos + 1


def test_params_from_numpy_round_trip(carried):
    """The reference's tree, names, shapes, dtypes and values, and back to
    numpy unchanged; the SSM leaves keep their own dtypes (A_log, D,
    dt_bias, gated_norm float32 at any param dtype)."""
    jp, cfg, params = carried
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    jcfg = JCFG.replace(param_dtype="bfloat16", dtype="bfloat16")
    jp16 = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    p16 = model.params_from_numpy(jax.tree.map(np.asarray, jp16),
                                  _port_cfg(jcfg), device=CPU)
    blk = p16["blocks"]["ssm"]
    for k in ("A_log", "D", "dt_bias", "gated_norm"):
        assert blk[k].dtype == torch.float32, k
    for k in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert blk[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            blk[k].float().numpy(),
            np.asarray(jp16["blocks"]["ssm"][k], np.float32))


def test_init_params_and_cache_match_reference_shapes():
    """Random parameters: the reference's tree, shapes and dtypes, its
    scales and its deterministic leaves (A_log, D, gated_norm, conv_b);
    one seed draws the same parameters from an int and from a CPU
    generator. The empty cache equals the reference's."""
    cfg = _port_cfg(JCFG)
    jp = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    p1 = model.init_params(torch.Generator().manual_seed(3), cfg)
    p2 = model.init_params(3, cfg, device=CPU)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        a, b = p1, p2
        for key in path:
            a, b = a[key.key], b[key.key]
        assert tuple(a.shape) == tuple(leaf.shape)
        assert str(a.dtype).split(".")[-1] == str(leaf.dtype)
        assert torch.equal(a, b)
    for k in ("A_log", "D", "gated_norm", "conv_b"):
        np.testing.assert_allclose(p1["blocks"]["ssm"][k].numpy(),
                                   np.asarray(jp["blocks"]["ssm"][k]),
                                   rtol=1e-6)
    dt = torch.nn.functional.softplus(p1["blocks"]["ssm"]["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    assert abs(float(p1["blocks"]["ssm"]["conv_w"].std()) / 0.2 - 1) < 0.1
    want = jmodel.init_cache(JCFG, 3, 20)["ssm"]
    got = model.init_cache(cfg, 3, 20, device=CPU)["ssm"]
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w))


# ---------------------------------------------------------------------------
# the conv tail of a prompt shorter than the conv (a fault of the reference)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_conv_tail(carried, s):
    """Prefill S < K-1 tokens into an engine slot, then decode token S+1:
    the port's logits equal the prefill of the S+1 tokens (its conv tail
    is left-padded with zeros, as the causal conv pads), while the
    reference's engine writes the S rows at the front of the slot's K-1
    rows and its logits differ."""
    jp, cfg, params = carried
    rng = np.random.default_rng(10 + s)
    toks = rng.integers(2, JCFG.vocab - 1, (1, s + 1)).astype(np.int32)
    pos = np.array([s], np.int32)

    jfull, _ = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, JCFG)
    _, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, JCFG)
    pool = jax.tree.map(lambda p_, o: jengine._slot_set(p_, o, 0),
                        jmodel.init_cache(JCFG, 1, 16), jc)
    jdec, _ = jmodel.decode_step(jp, jnp.asarray(toks[:, s:]), pool,
                                 jnp.asarray(pos), JCFG)
    assert float(np.abs(_np(jdec) - _np(jfull)).max()) > 1e-2

    tfull, _ = model.prefill(params, {"tokens": torch.as_tensor(toks)}, cfg)
    _, tc = model.prefill(params, {"tokens": torch.as_tensor(toks[:, :s])},
                          cfg)
    assert tuple(tc["ssm"].conv.shape[2:3]) == (cfg.ssm_conv - 1,)
    pool = model.init_cache(cfg, 1, 16, device=CPU)
    engine._slot_set(pool["ssm"], tc["ssm"], 0)
    tdec, _ = model.decode_step(params, torch.as_tensor(toks[:, s:]), pool,
                                torch.as_tensor(pos), cfg)
    np.testing.assert_allclose(_np(tdec), _np(tfull), atol=1e-5, rtol=0)
