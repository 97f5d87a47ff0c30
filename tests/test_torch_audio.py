"""The port's audio family (whisper's encoder-decoder:
`repro_torch.models.transformer.encoder_forward` /
`encdec_decoder_forward`, the plain gelu MLP, cross-attention and the
rope-free bidirectional encoder) against the JAX reference, on the CPU
at reduced whisper-large-v3 (2 + 2 layers, d_model 64, 4 heads, 24
frames). The reference's parameters are carried across with
`params_from_numpy`; the attention wrappers run their plain versions.

Tolerances: the MLP within 1e-5 (the same float32 operations; tanh and
the sums differ in the last bits); the encoder's output within 1e-5;
prefill and decode logits and the cross K/V within 1e-4; the self
cache's bf16 K/V within 1e-4 or one bf16 rounding step, positions exactly
(`tests/test_torch_models.py`); `loss_fn` within rtol 1e-5 and each
gradient leaf within 1e-5 of its largest reference entry.
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
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import layers, model, transformer  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def whisper():
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jinputs.reduced_config(jbase.get_config("whisper-large-v3"))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = base.ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, cfg, model.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device=CPU)


def _batch(jcfg, b=2, s=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(2, jcfg.vocab - 1, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32),
            "frames": rng.normal(size=(b, jcfg.enc_seq, jcfg.d_model)
                                 ).astype(np.float32)}


def test_gelu_mlp_matches_reference():
    """whisper's plain MLP: `jax.nn.gelu`'s default is the tanh
    approximation, which the port's `mlp(act="gelu")` takes too."""
    jcfg = jinputs.reduced_config(jbase.get_config("whisper-large-v3"))
    cfg = base.ModelConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"w1": rng.normal(size=(64, 128)).astype(np.float32) * 0.2,
         "w2": rng.normal(size=(128, 64)).astype(np.float32) * 0.2}
    want = jlayers.mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in p.items()}, jcfg,
                       act="gelu")
    got = layers.mlp(torch.as_tensor(x), {k: torch.as_tensor(v)
                                          for k, v in p.items()}, cfg,
                     act="gelu")
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    erf = torch.matmul(torch.nn.functional.gelu(
        torch.as_tensor(x) @ torch.as_tensor(p["w1"])),
        torch.as_tensor(p["w2"]))
    assert float((erf - got).abs().max()) > 1e-5   # tanh, not erf
    gen = torch.Generator().manual_seed(0)
    assert set(layers.init_mlp(gen, cfg, CPU, gated=False)) == {"w1", "w2"}


def test_params_tree_matches_reference(whisper):
    jcfg, jp, cfg, params = whisper
    fresh = model.init_params(3, cfg, device=CPU)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node, new = params, fresh
        for key in path:
            node, new = node[key.key], new[key.key]
        np.testing.assert_array_equal(_np(node), _np(leaf))
        assert tuple(new.shape) == tuple(leaf.shape), path
    assert "bq" not in fresh["blocks"]["cross_attn"]
    enc_wo = fresh["enc_blocks"]["attn"]["wo"]
    assert abs(float(enc_wo.std())
               / (0.02 / (2 * cfg.enc_layers) ** 0.5) - 1) < 0.1


def test_encoder_matches_reference(whisper):
    jcfg, jp, cfg, params = whisper
    frames = _batch(jcfg)["frames"]
    want = jtransformer.encoder_forward(jp, jnp.asarray(frames), jcfg)
    got = transformer.encoder_forward(params, torch.as_tensor(frames), cfg)
    assert tuple(got.shape) == (2, jcfg.enc_seq, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def _check_self_cache(got, want):
    for g, w in ((got.k, want.k), (got.v, want.v)):
        g, w = _np(g), _np(w)
        step = np.maximum(1e-4, np.abs(w) * 2.0 ** -7)
        assert np.all(np.abs(g - w) <= step), float(np.abs(g - w).max())
    np.testing.assert_array_equal(got.pos_buf.numpy(),
                                  np.asarray(want.pos_buf))


@pytest.mark.parametrize("s", [10, 1])
def test_prefill_and_decode_match_reference(whisper, s):
    """Prefill (logits, the self cache, the cross K/V) and 6 decode steps
    against the self and cross caches; a 1-token prompt takes the cross
    attention's one-token (decode kernel) route in the prefill too."""
    jcfg, jp, cfg, params = whisper
    batch = _batch(jcfg, s=s, seed=2)
    del batch["labels"]
    jl, jc = jmodel.prefill(jp, {k: jnp.asarray(v)
                                 for k, v in batch.items()}, jcfg,
                            max_seq=20)
    tl, tc = model.prefill(params, {k: torch.as_tensor(v)
                                    for k, v in batch.items()}, cfg,
                           max_seq=20)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert set(tc) == {"self", "cross_k", "cross_v"}
    _check_self_cache(tc["self"], jc["self"])
    for name in ("cross_k", "cross_v"):
        assert tuple(tc[name].shape) == (cfg.n_layers, 2, cfg.enc_seq,
                                         cfg.n_kv_heads, 16)
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)
    pos = np.full((2,), s, np.int32)
    jdecode = jax.jit(jmodel.decode_step, static_argnums=4)
    for step in range(6):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(pos), jcfg)
        tl, tc = model.decode_step(params, torch.as_tensor(nxt), tc,
                                   torch.as_tensor(pos), cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode step {step}")
        _check_self_cache(tc["self"], jc["self"])
        pos = pos + 1


def test_init_cache_matches_reference(whisper):
    jcfg, _, cfg, _ = whisper
    want = jmodel.init_cache(jcfg, 3, 20)
    got = model.init_cache(cfg, 3, 20, device=CPU)
    assert set(got) == set(want)
    for name in ("cross_k", "cross_v"):
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
    for g, w in zip(got["self"][:3], want["self"][:3]):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_np(g), _np(w))
    assert got["self"].k_scale is None


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


def _leaf_err(got, want) -> float:
    g, w = _np(got), np.asarray(want, np.float32)
    scale = float(np.abs(w).max())
    return float(np.abs(g - w).max()) / scale if scale else \
        float(np.abs(g).max())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_reference(whisper, remat):
    jcfg, jp, cfg, params = whisper
    cfg = cfg.replace(remat=remat)
    batch = _batch(jcfg, s=12, seed=3)
    batch["loss_mask"] = (np.random.default_rng(4).random((2, 12)) > 0.2
                          ).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    params = _requiring_grad(params)
    loss, metrics = model.loss_fn(
        params, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(metrics["moe_aux"]) == float(jm["moe_aux"]) == 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert _leaf_err(node.grad, leaf) <= GRAD_TOL, path


def test_audio_family_is_no_longer_refused(whisper):
    transformer.check_family(whisper[2])
    assert "audio" in transformer.FAMILIES
