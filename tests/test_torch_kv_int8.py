"""The port's int8 KV cache (``kv_cache_dtype="int8"``: `quantize_kv`,
`_cache_from_kv`'s linear and rolling forms, the decode path with
scales) against the JAX reference's, on the CPU. The reference decodes an
int8 cache outside its Pallas kernel, in plain operations with the
k-scale on the scores and the v-scale on the softmax weights; the port's
`decode_attention_int8` is the same route.

Tolerances: `quantize_kv` on the same input: int8 values exactly, scales
within rtol 1e-6; `_cache_from_kv` on the same K/V: int8 values and
positions exactly, scales within rtol 1e-6; `decode_attention_int8` on
the same int8 cache within 1e-6; through the model, where the K/V that
are quantised already differ in the last float32 bits, an int8 value
may land one step away at a rounding boundary: int8 caches within one
step, scales within rtol 1e-5, logits within 1e-4. The port's int8
against its bf16 cache: the reference's `test_int8_kv_cache_close_to_bf16`
bound (max |logit diff| below 2% of the largest bf16 logit).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import attention, model  # noqa: E402
from repro_torch.serving.engine import (Request, ServeConfig,  # noqa: E402
                                        ServingEngine)

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen2.5-3b", "mixtral-8x22b", "whisper-large-v3")


def _jcfg(arch, **kw):
    return jinputs.reduced_config(jbase.get_config(arch)).replace(
        kv_cache_dtype="int8", **kw)


def _port_cfg(jcfg):
    return base.ModelConfig(**dataclasses.asdict(jcfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_quantize_kv_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32) * 2.5
    x[0, 0, 0] = 0.0                      # an all-zero row: scale 0
    x[1, 2, 1, :4] = 1e-3                 # a tiny row
    x[2, 3, 0] = np.linspace(-127, 127, 16)   # exact multiples: ties
    q, s = attention.quantize_kv(torch.as_tensor(x))
    jq, js = jattention.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                               atol=0)
    assert float(s[0, 0, 0]) == 0.0 and not bool(q[0, 0, 0].any())


@pytest.mark.parametrize("w", [24, 8])
def test_cache_from_kv_matches_reference(w):
    """Linear (w >= s: a pad, scales 0 on the empty slots) and rolling
    (w < s: the last w positions at slot pos % w) int8 caches from the
    same collected K/V [L, B, S, G, Dh]."""
    jcfg = _jcfg("qwen2.5-3b")
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(1)
    k, v = (rng.normal(size=(2, 3, 13, 1, 16)).astype(np.float32)
            for _ in range(2))
    want = jmodel._cache_from_kv(jnp.asarray(k), jnp.asarray(v), w, jcfg)
    got = model._cache_from_kv(torch.as_tensor(k), torch.as_tensor(v), w,
                               cfg)
    for name in ("k", "v", "pos_buf"):
        g, x = getattr(got, name), getattr(want, name)
        assert str(g.dtype).split(".")[-1] == str(x.dtype), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(x),
                                      err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_decode_attention_int8_matches_reference():
    rng = np.random.default_rng(2)
    b, w, g, r, dh = 2, 30, 2, 3, 16
    q = rng.normal(size=(b, 1, g * r, dh)).astype(np.float32)
    kq, ks = jattention.quantize_kv(jnp.asarray(
        rng.normal(size=(b, w, g, dh)).astype(np.float32)))
    vq, vs = jattention.quantize_kv(jnp.asarray(
        rng.normal(size=(b, w, g, dh)).astype(np.float32)))
    valid = rng.random((b, w)) > 0.3
    valid[:, 0] = True
    jcfg = _jcfg("qwen2.5-3b")
    want = jattention._decode_attention(jnp.asarray(q), kq, vq,
                                        jnp.asarray(valid), jcfg,
                                        k_scale=ks, v_scale=vs)
    calls = attention.decode_attention_int8.calls
    got = attention.decode_attention_int8(
        torch.as_tensor(q), *(torch.as_tensor(np.array(a))
                              for a in (kq, vq)),
        torch.as_tensor(valid).to(torch.int8),
        *(torch.as_tensor(np.array(a)) for a in (ks, vs)))
    assert attention.decode_attention_int8.calls == calls + 1
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


def _carry(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = _port_cfg(jcfg)
    return jp, cfg, model.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device=CPU)


def _batch(jcfg, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, jcfg.vocab - 1, (2, s)).astype(
        np.int32)}
    if jcfg.family == "audio":
        batch["frames"] = rng.normal(size=(2, jcfg.enc_seq, jcfg.d_model)
                                     ).astype(np.float32)
    return batch


def _check_int8_cache(got, want):
    for name in ("k", "v"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.int8
        diff = g.numpy().astype(np.int32) - np.asarray(w).astype(np.int32)
        assert int(np.abs(diff).max()) <= 1
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got.pos_buf.numpy(),
                                  np.asarray(want.pos_buf))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_with_int8_cache_match_reference(arch):
    """12-token prompts (past mixtral's window of 8: a rolling int8 cache)
    and 6 decode steps through the int8 cache, every decode step on the
    int8 route."""
    jcfg = _jcfg(arch)
    jp, cfg, params = _carry(jcfg, seed=3)
    key = "self" if jcfg.family == "audio" else "attn"
    batch = _batch(jcfg, 12, 4)
    jl, jc = jmodel.prefill(jp, {k: jnp.asarray(v)
                                 for k, v in batch.items()}, jcfg,
                            max_seq=24)
    tl, tc = model.prefill(params, {k: torch.as_tensor(v)
                                    for k, v in batch.items()}, cfg,
                           max_seq=24)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _check_int8_cache(tc[key], jc[key])
    pos = np.full((2,), 12, np.int32)
    jdecode = jax.jit(jmodel.decode_step, static_argnums=4)
    calls = attention.decode_attention_int8.calls
    for step in range(6):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(pos), jcfg)
        tl, tc = model.decode_step(params, torch.as_tensor(nxt), tc,
                                   torch.as_tensor(pos), cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode step {step}")
        _check_int8_cache(tc[key], jc[key])
        pos = pos + 1
    assert attention.decode_attention_int8.calls == calls + 6 * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_close_to_bf16(arch):
    """The reference's `test_int8_kv_cache_close_to_bf16` on the port:
    prefill 16 tokens, decode 5, the last logits of the int8 cache within
    2% of the bf16 cache's largest logit."""
    jcfg = _jcfg(arch)
    _, cfg8, params = _carry(jcfg, seed=5)
    cfg = cfg8.replace(kv_cache_dtype="bfloat16")
    batch = {k: torch.as_tensor(v) for k, v in _batch(jcfg, 21, 6).items()}
    toks = batch["tokens"]
    outs = {}
    for name, c in (("base", cfg), ("int8", cfg8)):
        _, caches = model.prefill(params, dict(batch, tokens=toks[:, :16]),
                                  c, max_seq=24)
        for i in range(5):
            lg, caches = model.decode_step(
                params, toks[:, 16 + i:17 + i], caches,
                torch.full((2,), 16 + i, dtype=torch.int32), c)
        outs[name] = lg
    rel = float((outs["base"] - outs["int8"]).abs().max()) / (
        float(outs["base"].abs().max()) + 1e-9)
    assert rel < 0.02, (arch, rel)


def test_engine_serves_an_int8_pool():
    """`ServingEngine` over an int8 pool: the scales travel with the
    slots; each request's tokens equal its own prefill + decode loop."""
    jcfg = _jcfg("qwen2.5-3b")
    _, cfg, params = _carry(jcfg, seed=6)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab - 1, n).astype(
        np.int32), max_new=4) for i, n in enumerate((5, 9, 3))]
    eng = ServingEngine(params, cfg, ServeConfig(slots=2, max_seq=20),
                        device=CPU)
    assert eng.caches["attn"].k.dtype == torch.int8
    assert eng.caches["attn"].k_scale.shape == eng.caches["attn"].k.shape[:4]
    for r in reqs:
        eng.submit(r)
    eng.run(ticks=12)
    assert len(eng.completed) == 3
    for r in eng.completed:
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(r.prompt[None].astype(
                np.int64))}, cfg, max_seq=20)
        want = [int(torch.argmax(logits, -1)[0])]
        for j in range(3):
            logits, caches = model.decode_step(
                params, torch.tensor([[want[-1]]]), caches,
                torch.tensor([len(r.prompt) + j]), cfg)
            want.append(int(torch.argmax(logits, -1)[0]))
        assert r.output == want, r.rid


def test_bf16_cache_has_no_scales():
    cfg = _port_cfg(_jcfg("qwen2.5-3b")).replace(kv_cache_dtype="bfloat16")
    cache = attention.init_attn_cache(cfg, 2, 8, CPU)
    assert cache.k_scale is None and cache.v_scale is None
    pool = model.init_cache(cfg, 2, 8, device=CPU)["attn"]
    assert pool.k_scale is None and pool.k.dtype == torch.bfloat16
