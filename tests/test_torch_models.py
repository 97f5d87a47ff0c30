"""The port's model stack (configs, layers, attention, the dense decoder,
prefill and decode) against the JAX reference. The reference's random
parameters (`repro.models.model.init_params`, drawn by `jax.random`,
which torch cannot reproduce) are carried across with
`params_from_numpy`; everything runs on the CPU at float32, where the
attention kernels' wrappers run their plain versions.

Tolerances: layer primitives within 1e-6 (the same float32 operations;
transcendental functions and sums may differ in the last bits);
prefill and decode logits within 1e-4 (float32 through two layers,
with the attention's online softmax summed in another order); cached K/V
within 1e-4 or one bf16 rounding step (2^-7 relative), whichever is
larger, since the reduced configs keep the reference's bfloat16 KV cache
and a float32 value a few ulps off can round to the neighbouring bf16
value; positions in the cache exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import inputs  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.attention import init_attn_cache  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(jcfg):
    """The same configuration in the port's dataclass."""
    return base.ModelConfig(**dataclasses.asdict(jcfg))


def _small_configs():
    q3 = jinputs.reduced_config(jbase.get_config("qwen2.5-3b"))
    return {
        "qwen2.5-3b-smoke": q3,                             # H 4, G 1
        "qwen1.5-0.5b-smoke": jinputs.reduced_config(
            jbase.get_config("qwen1.5-0.5b")),              # MHA
        "gqa-16-2": q3.replace(name="gqa-16-2", n_heads=16,
                               n_kv_heads=2, head_dim=16),  # R 8, G 2
        "swa-8": q3.replace(name="swa-8", swa_window=8),    # rolling cache
    }


CONFIGS = _small_configs()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def carried(request):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = CONFIGS[request.param]
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    cfg = _port_cfg(jcfg)
    return jcfg, jp, cfg, model.params_from_numpy(tree, cfg, device=CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_equal_the_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert list(base.SHAPES) == list(jbase.SHAPES)
    for arch in jbase.ARCH_IDS:
        want = dataclasses.asdict(jbase.get_config(arch))
        assert dataclasses.asdict(base.get_config(arch)) == want
        assert dataclasses.asdict(inputs.reduced_config(
            base.get_config(arch))) == dataclasses.asdict(
                jinputs.reduced_config(jbase.get_config(arch)))
        assert base.get_config(arch).resolved_head_dim == \
            jbase.get_config(arch).resolved_head_dim
    assert base.runnable_cells() == jbase.runnable_cells()
    assert inputs.SMOKE_DECODE == base.ShapeSpec(
        **dataclasses.asdict(jinputs.SMOKE_DECODE))


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

def test_layer_primitives_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(10, 15, dtype=np.int32)
    got = layers.apply_rope(torch.as_tensor(x),
                            torch.as_tensor(pos).expand(2, 5), 1e6)
    want = jlayers.apply_rope(jnp.asarray(x),
                              jnp.broadcast_to(jnp.asarray(pos), (2, 5)), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)

    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    np.testing.assert_allclose(
        _np(layers.rms_norm(torch.as_tensor(h), torch.as_tensor(scale),
                            1e-6)),
        _np(jlayers.rms_norm(jnp.asarray(h), jnp.asarray(scale), 1e-6)),
        atol=1e-6, rtol=1e-6)

    jcfg = CONFIGS["qwen2.5-3b-smoke"]
    cfg = _port_cfg(jcfg)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in (("w1", (64, 128)), ("w2", (128, 64)),
                      ("w3", (64, 128)))}
    np.testing.assert_allclose(
        _np(layers.mlp(torch.as_tensor(h),
                       {k: torch.as_tensor(v) for k, v in p.items()}, cfg)),
        _np(jlayers.mlp(jnp.asarray(h),
                        {k: jnp.asarray(v) for k, v in p.items()}, jcfg)),
        atol=1e-6, rtol=1e-5)

    tok = rng.normal(size=(256, 64)).astype(np.float32)
    ids = rng.integers(0, 256, (2, 5))
    emb_t = layers.embed(torch.as_tensor(ids), {"tok": torch.as_tensor(tok)},
                         cfg)
    emb_j = jlayers.embed(jnp.asarray(ids), {"tok": jnp.asarray(tok)}, jcfg)
    np.testing.assert_array_equal(_np(emb_t), _np(emb_j))
    np.testing.assert_allclose(
        _np(layers.unembed(torch.as_tensor(h), {"tok": torch.as_tensor(tok)},
                           cfg)),
        _np(jlayers.unembed(jnp.asarray(h), {"tok": jnp.asarray(tok)},
                            jcfg)), atol=1e-5, rtol=1e-5)


def test_unembed_rounds_logits_to_the_activation_dtype():
    """At bf16 the logits are computed in bf16 and then cast to the
    float32 logit dtype, as the reference does: every logit is a bf16
    value."""
    cfg = _port_cfg(CONFIGS["qwen2.5-3b-smoke"]).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    rng = np.random.default_rng(1)
    h = torch.as_tensor(rng.normal(size=(1, 1, 64))).to(torch.bfloat16)
    tok = torch.as_tensor(rng.normal(size=(256, 64))).to(torch.bfloat16)
    logits = layers.unembed(h, {"tok": tok}, cfg)
    assert logits.dtype == torch.float32
    assert torch.equal(logits, logits.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_from_numpy_keeps_the_reference_tree(carried):
    jcfg, jp, cfg, params = carried
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        np.testing.assert_array_equal(_np(node), _np(leaf))


def test_init_params_shapes_dtypes_and_scale():
    """Random parameters from a torch.Generator: the reference's tree,
    shapes and dtypes; draws at the reference's scales; the same seed
    draws the same parameters."""
    jcfg = CONFIGS["gqa-16-2"]
    cfg = _port_cfg(jcfg)
    jp = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    p1 = model.init_params(torch.Generator().manual_seed(3), cfg)
    p2 = model.init_params(3, cfg, device=CPU)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        a, b = p1, p2
        for key in path:
            a, b = a[key.key], b[key.key]
        assert tuple(a.shape) == tuple(leaf.shape)
        assert str(a.dtype).split(".")[-1] == str(leaf.dtype)
        assert torch.equal(a, b)
    assert abs(float(p1["embed"]["tok"].std()) - 0.02) < 2e-3
    wo_scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert abs(float(p1["blocks"]["attn"]["wo"].std()) / wo_scale - 1) < 0.1
    assert torch.all(p1["blocks"]["attn"]["bq"] == 0)
    assert torch.all(p1["blocks"]["ln1"]["scale"] == 1)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def _check_cache(got, want):
    for g, w in ((got.k, want.k), (got.v, want.v)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        g, w = _np(g), _np(w)
        step = np.maximum(1e-4, np.abs(w) * 2.0 ** -7)
        assert np.all(np.abs(g - w) <= step), float(np.abs(g - w).max())
    np.testing.assert_array_equal(got.pos_buf.numpy(),
                                  np.asarray(want.pos_buf))


@pytest.mark.parametrize("max_seq", [None, 24])
def test_prefill_and_decode_match_reference(carried, max_seq):
    jcfg, jp, cfg, params = carried
    rng = np.random.default_rng(4)
    toks = rng.integers(2, jcfg.vocab - 1, (2, 12)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            max_seq=max_seq)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(toks)}, cfg,
                           max_seq=max_seq)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _check_cache(tc["attn"], jc["attn"])
    if max_seq is None:
        return
    pos = np.array([12, 12], np.int32)
    for step in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc,
                                    jnp.asarray(pos), jcfg)
        tl, tc = model.decode_step(params, torch.as_tensor(nxt), tc,
                                   torch.as_tensor(pos), cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode step {step}")
        _check_cache(tc["attn"], jc["attn"])
        pos = pos + 1


def test_init_cache_matches_reference():
    for name in ("gqa-16-2", "swa-8"):
        jcfg = CONFIGS[name]
        want = jmodel.init_cache(jcfg, 3, 20)["attn"]
        got = model.init_cache(_port_cfg(jcfg), 3, 20, device=CPU)["attn"]
        for g, w in zip(got, want):
            if w is None:                  # a bf16 cache's scales
                assert g is None
                continue
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("change", [dict(kv_cache_align=4)])
def test_unported_cache_layouts_raise(change):
    """The head-aligned cache, once refused, is ported with the model
    mesh: its empty cache equals the reference's (KV heads stored at
    ``cfg.cache_heads``)."""
    jcfg = CONFIGS["gqa-16-2"].replace(**change)
    cfg = _port_cfg(CONFIGS["gqa-16-2"]).replace(**change)
    assert cfg.cache_heads == jcfg.cache_heads == 4
    want = jmodel.init_cache(jcfg, 1, 8)["attn"]
    for got in (model.init_cache(cfg, 1, 8, device=CPU)["attn"],
                init_attn_cache(cfg, 1, 8, CPU)):
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert tuple(g.shape)[-g.ndim:] == tuple(w.shape)[-g.ndim:]
            np.testing.assert_array_equal(_np(g), _np(w)[(0,) * (
                w.ndim - g.ndim)])


def test_vlm_prefill_matches_reference():
    """The vision frontend's patch embeddings take the first
    ``vis_tokens`` positions of the dense backbone (reduced internvl2)."""
    jcfg = jinputs.reduced_config(jbase.get_config("internvl2-76b"))
    cfg = _port_cfg(jcfg)
    jp = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
    params = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     device=CPU)
    rng = np.random.default_rng(6)
    toks = rng.integers(2, jcfg.vocab - 1, (2, 14)).astype(np.int32)
    patches = rng.normal(size=(2, jcfg.vis_tokens, jcfg.d_model)).astype(
        np.float32)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "patches": jnp.asarray(patches)}, jcfg,
                            max_seq=20)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(toks),
                                    "patches": torch.as_tensor(patches)},
                           cfg, max_seq=20)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _check_cache(tc["attn"], jc["attn"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    cfg = _port_cfg(CONFIGS["qwen2.5-3b-smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(cfg, 1, 8)
