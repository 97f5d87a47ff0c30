"""The port's hybrid family (zamba2: Mamba2 blocks with one weight-shared
attention + MLP block after every ``hybrid_attn_every`` of them, each
application with its own K/V cache) against the JAX reference: parameters
and caches, prefill logits and caches, decode steps, the conv tail of a
prompt shorter than the conv, and the plain kernels' routing on the CPU.
The reference's parameters are carried across with `params_from_numpy`;
everything runs on the CPU at float32 through the reference's XLA path
(``attn_impl="xla"``, its blockwise attention and `ssd_chunked`), where
the port's kernel wrappers run their plain versions. Two configurations:
reduced zamba2 (4 layers, the shared block after every 2: two
applications, no trailing layer) and a 5-layer variant (two applications
and one trailing Mamba2 layer).

Tolerances, those of `tests/test_torch_ssm.py` and
`tests/test_torch_models.py`: logits within 1e-4 (float32 through the
layers, sums in another order); SSM conv and state caches within 1e-5;
cached K/V within 1e-4 or one bf16 rounding step (2^-7 relative),
whichever is larger, since the reduced config keeps the reference's
bfloat16 KV cache; positions in the cache exactly; the port's decode after
a short prompt against the prefill of the longer prompt within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ssd_scan as smod  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
REDUCED = jinputs.reduced_config(jbase.get_config("zamba2-1.2b"))
JCFGS = {"zamba2-smoke": REDUCED,                       # 4 = 2 x 2 layers
         "zamba2-5": REDUCED.replace(name="zamba2-5", n_layers=5)}


def _port_cfg(jcfg):
    return base.ModelConfig(**dataclasses.asdict(jcfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=sorted(JCFGS))
def carried(request):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = JCFGS[request.param]
    assert jcfg.attn_impl == "xla" and jcfg.family == "hybrid"
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = _port_cfg(jcfg)
    return jcfg, jp, cfg, model.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device=CPU)


def _check_kv(got, want):
    for g, w in ((got.k, want.k), (got.v, want.v)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        g, w = _np(g), _np(w)
        step = np.maximum(1e-4, np.abs(w) * 2.0 ** -7)
        assert np.all(np.abs(g - w) <= step), float(np.abs(g - w).max())
    np.testing.assert_array_equal(got.pos_buf.numpy(),
                                  np.asarray(want.pos_buf))


def _check_ssm(got, want):
    for name in ("conv", "state"):
        g, w = getattr(got, name), getattr(want, name)
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_init_params_and_cache_match_reference_shapes(carried):
    """Random parameters: the reference's tree (the stacked Mamba2 blocks
    and the one ``shared`` attention + MLP block), shapes and dtypes; one
    seed draws the same parameters from an int and from a CPU generator.
    The empty cache: the SSM cache over the layers and the K/V cache over
    the applications, linear over max_seq, equal to the reference's."""
    jcfg, jp, cfg, _ = carried
    p1 = model.init_params(torch.Generator().manual_seed(3), cfg)
    p2 = model.init_params(3, cfg, device=CPU)
    assert set(p1) == set(jp) == {"embed", "blocks", "final_norm", "shared"}
    for path, leaf in _leaves(jp):
        a, b = _at(p1, path), _at(p2, path)
        assert tuple(a.shape) == tuple(leaf.shape), path
        assert str(a.dtype).split(".")[-1] == str(leaf.dtype), path
        assert torch.equal(a, b)
    n_apps = cfg.n_layers // cfg.hybrid_attn_every
    assert p1["shared"]["attn"]["wq"].shape == (
        cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)
    want = jmodel.init_cache(jcfg, 3, 20)
    got = model.init_cache(cfg, 3, 20, device=CPU)
    assert set(got) == set(want) == {"ssm", "attn"}
    assert got["attn"].k.shape[:3] == (n_apps, 3, 20)
    assert got["ssm"].state.shape[:2] == (cfg.n_layers, 3)
    for name in ("ssm", "attn"):
        for g, w in zip(got[name], want[name]):
            if w is None:                  # a bf16 cache's scales
                assert g is None
                continue
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(_np(g), _np(w))


def test_params_from_numpy_round_trip(carried):
    """The reference's tree, the ``shared`` block's included: names,
    shapes, dtypes and values, and back to numpy unchanged."""
    _, jp, _, params = carried
    assert "shared" in params
    for path, leaf in _leaves(jp):
        node = _at(params, path)
        assert tuple(node.shape) == tuple(leaf.shape)
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(_leaves(jp)) == sum(
        1 for _ in jax.tree_util.tree_leaves(
            jax.tree.map(lambda t: 0, params,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [5, 8, 13])
def test_prefill_and_decode_match_reference(carried, s):
    """Prefill (chunk 8: a padded chunk, a whole one, a whole and a padded
    one) into caches of 24 positions, then four greedy decode steps: the
    logits, both caches after the prefill and after each step, the pool
    updated in place."""
    jcfg, jp, cfg, params = carried
    rng = np.random.default_rng(s)
    toks = rng.integers(2, jcfg.vocab - 1, (2, s)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            max_seq=24)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(toks)}, cfg,
                           max_seq=24)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert set(tc) == {"ssm", "attn"}
    _check_ssm(tc["ssm"], jc["ssm"])
    _check_kv(tc["attn"], jc["attn"])
    pos = np.array([s, s], np.int32)
    for step in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc,
                                    jnp.asarray(pos), jcfg)
        tl, tc2 = model.decode_step(params, torch.as_tensor(nxt), tc,
                                    torch.as_tensor(pos), cfg)
        assert tc2 is tc                      # updated in place
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode step {step}")
        _check_ssm(tc["ssm"], jc["ssm"])
        _check_kv(tc["attn"], jc["attn"])
        pos = pos + 1


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_conv_tail(carried, s):
    """Prefill S < K-1 tokens into an engine slot, then decode token S+1:
    the port's logits equal the prefill of the S+1 tokens (its conv tail
    is left-padded with zeros, as the causal conv pads: a documented
    departure), while the reference's engine writes the S rows at the
    front of the slot's K-1 rows and its logits differ. The K/V cache is
    float32 here, so that the decode step's attention reads the keys the
    longer prefill attends over, not their bf16 roundings."""
    jcfg, jp, cfg, params = carried
    jcfg = jcfg.replace(kv_cache_dtype="float32")
    cfg = cfg.replace(kv_cache_dtype="float32")
    rng = np.random.default_rng(20 + s)
    toks = rng.integers(2, jcfg.vocab - 1, (1, s + 1)).astype(np.int32)
    pos = np.array([s], np.int32)

    jfull, _ = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg,
                           max_seq=16)
    pool = jax.tree.map(lambda p_, o: jengine._slot_set(p_, o, 0),
                        jmodel.init_cache(jcfg, 1, 16), jc)
    jdec, _ = jmodel.decode_step(jp, jnp.asarray(toks[:, s:]), pool,
                                 jnp.asarray(pos), jcfg)
    assert float(np.abs(_np(jdec) - _np(jfull)).max()) > 1e-2

    tfull, _ = model.prefill(params, {"tokens": torch.as_tensor(toks)}, cfg)
    _, tc = model.prefill(params, {"tokens": torch.as_tensor(toks[:, :s])},
                          cfg, max_seq=16)
    assert tuple(tc["ssm"].conv.shape[2:3]) == (cfg.ssm_conv - 1,)
    pool = model.init_cache(cfg, 1, 16, device=CPU)
    for name in pool:
        engine._slot_set(pool[name], tc[name], 0)
    tdec, _ = model.decode_step(params, torch.as_tensor(toks[:, s:]), pool,
                                torch.as_tensor(pos), cfg)
    np.testing.assert_allclose(_np(tdec), _np(tfull), atol=1e-5, rtol=0)


def test_cpu_tensors_run_the_plain_kernels(carried, monkeypatch):
    """On CPU tensors the three kernel wrappers launch nothing and run
    their plain versions: per prefill the SSD scan once per Mamba2 layer
    and flash once per application of the shared block, per decode step
    the decode attention once per application."""
    jcfg, _, cfg, params = carried
    n_apps = cfg.n_layers // cfg.hybrid_attn_every
    calls = {"ssd": 0, "flash": 0, "decode": 0}

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call
    for mod, name, key in ((smod, "ssd_scan_plain", "ssd"),
                           (fmod, "flash_attention_plain", "flash"),
                           (dmod, "decode_attention_plain", "decode")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    wrappers = (smod.ssd_scan, fmod.flash_attention, dmod.decode_attention)
    before = [w.launches for w in wrappers]
    toks = torch.as_tensor(np.arange(2, 12, dtype=np.int64)[None])
    _, caches = model.prefill(params, {"tokens": toks}, cfg, max_seq=16)
    assert calls == {"ssd": cfg.n_layers, "flash": n_apps, "decode": 0}
    model.decode_step(params, toks[:, :1], caches, torch.tensor([10]), cfg)
    assert calls == {"ssd": cfg.n_layers, "flash": n_apps,
                     "decode": n_apps}
    assert [w.launches for w in wrappers] == before
