"""The port's MoE family (`repro_torch.models.moe`, the moe blocks of
`repro_torch.models.transformer`) against the JAX reference, on the CPU:
reduced mixtral-8x22b (top-2 of 4 experts, SWA window 8) and grok-1-314b
(no window). The reference's parameters are carried across with
`params_from_numpy`.

Tolerances: routing is discrete and must match exactly (the chosen
experts, the sorted assignments, each one's rank and slot, which ones are
kept and dropped); weights and the aux within 1e-6, the expert FFN's
output within 1e-5 (float32; the products sum in another order);
prefill and decode logits within 1e-4 (`tests/test_torch_models.py`);
`loss_fn` within rtol 1e-5 and each gradient leaf within 1e-5 of its
largest reference entry (`tests/test_torch_train.py`). The reference
computes its router and norms in float32 by construction, so no float64
reference exists; in float64 the port's dispatch, expert GEMMs and
combine are held under autograd against a dense per-token oracle (the
same routing, each token's k experts applied one by one) within 1e-8.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.energy import stream as jstream  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.energy import stream  # noqa: E402
from repro_torch.models import model, moe, transformer  # noqa: E402
from repro_torch.runtime import scheduler  # noqa: E402
from repro_torch.serving.engine import (Request, ServeConfig,  # noqa: E402
                                        ServingEngine)

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-5
ARCHS = ("mixtral-8x22b", "grok-1-314b")


def _jcfg(arch, **kw):
    return jinputs.reduced_config(jbase.get_config(arch)).replace(**kw)


def _port_cfg(jcfg):
    return base.ModelConfig(**dataclasses.asdict(jcfg))


def _carry(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = _port_cfg(jcfg)
    return jp, cfg, model.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device=CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _moe_params(jcfg, seed):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return p, {k: model._tensor(v, CPU) for k, v in p.items()}


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

ROUTE_CASES = [
    # (arch, tokens, capacity_factor, router scale)
    ("mixtral-8x22b", 24, 1.25, 1.0),    # cap 16: dropless
    ("grok-1-314b", 64, 1.25, 1.0),      # cap 40
    ("mixtral-8x22b", 64, 0.25, 2.0),    # cap 8 < every expert's load
    ("grok-1-314b", 40, 0.5, 0.0),       # a zero router: every prob ties
]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_and_dispatch_matches_reference_exactly(case):
    arch, t, cf, scale = case
    jcfg = _jcfg(arch, capacity_factor=cf)
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(t, jcfg.d_model)).astype(np.float32)
    router = (scale * rng.normal(size=(jcfg.d_model, jcfg.n_experts))
              ).astype(np.float32)
    jbuf, jmeta, jaux = jmoe.route_and_dispatch(jnp.asarray(x),
                                                jnp.asarray(router), jcfg)
    buf, meta, aux = moe.route_and_dispatch(torch.as_tensor(x),
                                            torch.as_tensor(router), cfg)
    assert moe._capacity(t, cfg) == jmoe._capacity(t, jcfg) == meta.cap
    for name in ("eid_s", "tok_s", "rank_c", "keep"):
        np.testing.assert_array_equal(getattr(meta, name).numpy(),
                                      np.asarray(getattr(jmeta, name)),
                                      err_msg=name)
    np.testing.assert_allclose(meta.wgt_s.numpy(), np.asarray(jmeta.wgt_s),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_np(buf), _np(jbuf))
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                               rtol=1e-6)
    drops = int((~meta.keep).sum())
    assert drops == int((~np.asarray(jmeta.keep)).sum())
    if cf < 1:
        assert drops > 0
    if scale == 0.0:
        # ties go to the lower expert index, as jax.lax.top_k's do
        first = meta.eid_s[meta.tok_s.argsort(stable=True)].reshape(t, -1)
        assert torch.equal(first, torch.arange(cfg.top_k).expand(t, -1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_ffn_local_matches_reference(arch, cf):
    jcfg = _jcfg(arch, capacity_factor=cf)
    cfg = _port_cfg(jcfg)
    jp, p = _moe_params(jcfg, 3)
    x = np.random.default_rng(5).normal(size=(48, jcfg.d_model)).astype(
        np.float32)
    want, jaux = jmoe.moe_ffn_local(jnp.asarray(x), jp, jcfg)
    got, aux = moe.moe_ffn_local(torch.as_tensor(x), p, cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5,
                               rtol=1e-5)


def test_moe_ffn_local_bf16_casts_in_the_reference_order():
    """At bf16 the combine multiplies each expert output by its weight
    rounded to bf16 and scatter-adds in bf16, as the reference does: the
    outputs agree within one bf16 rounding step of their scale."""
    jcfg = _jcfg("mixtral-8x22b", dtype="bfloat16", param_dtype="bfloat16")
    cfg = _port_cfg(jcfg)
    jp, tp = _moe_params(jcfg, 4)
    x = np.random.default_rng(6).normal(size=(32, jcfg.d_model)).astype(
        np.float32)
    want, _ = jmoe.moe_ffn_local(jnp.asarray(x).astype(jnp.bfloat16), jp,
                                 jcfg)
    got, _ = moe.moe_ffn_local(torch.as_tensor(x).to(torch.bfloat16), tp,
                               cfg)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(_np(want)).max())
    assert float(np.abs(_np(got) - _np(want)).max()) <= 2 ** -7 * scale


# ---------------------------------------------------------------------------
# the model: parameters, prefill, decode through the rolling cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_matches_reference(arch):
    jcfg = _jcfg(arch)
    cfg = _port_cfg(jcfg)
    jp = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    params = model.init_params(1, cfg, device=CPU)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    w2 = params["blocks"]["ffn"]["w2"]
    assert abs(float(w2.std()) / (0.02 / (2 * cfg.n_layers) ** 0.5) - 1) \
        < 0.1
    assert params["blocks"]["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A 12-token prompt (past mixtral's window of 8: the prefill's cache
    is rolling) and 8 decode steps, logits and caches."""
    jcfg = _jcfg(arch)
    jp, cfg, params = _carry(jcfg, seed=2)
    rng = np.random.default_rng(7)
    toks = rng.integers(2, jcfg.vocab - 1, (2, 12)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            max_seq=24)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(toks)}, cfg,
                           max_seq=24)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    w = min(jcfg.swa_window or 24, 24)
    assert tc["attn"].k.shape[2] == w
    np.testing.assert_array_equal(tc["attn"].pos_buf.numpy(),
                                  np.asarray(jc["attn"].pos_buf))
    pos = np.array([12, 12], np.int32)
    jdecode = jax.jit(jmodel.decode_step, static_argnums=4)
    for step in range(8):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(pos), jcfg)
        tl, tc = model.decode_step(params, torch.as_tensor(nxt), tc,
                                   torch.as_tensor(pos), cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_allclose(_np(tc["attn"].k), _np(jc["attn"].k),
                                   **TOL)
        np.testing.assert_array_equal(tc["attn"].pos_buf.numpy(),
                                      np.asarray(jc["attn"].pos_buf))
        pos = pos + 1


def test_engine_serves_moe_as_the_reference_engine():
    """Reduced mixtral through `ServingEngine` (prompts past the window,
    the price gate on): the same tokens per request and summary as the
    reference's engine."""
    jcfg = _jcfg("mixtral-8x22b")
    jp, cfg, params = _carry(jcfg, seed=1)
    rng = np.random.default_rng(0)
    prices = 80 + 40 * rng.random(24 * 30)
    prices[rng.random(prices.size) < 0.1] *= 4
    kw = dict(slots=3, min_slots=1, max_seq=32, hours_per_tick=0.25)
    ref_eng = jengine.ServingEngine(
        jp, jcfg, jengine.ServeConfig(**kw),
        scheduler=jsched.EnergyAwareScheduler(
            jstream.PriceStream(prices, start=100),
            jsched.SchedulerConfig(psi=2.0, mode="oracle")))
    eng = ServingEngine(
        params, cfg, ServeConfig(**kw),
        scheduler=scheduler.EnergyAwareScheduler(
            stream.PriceStream(prices, start=100),
            scheduler.SchedulerConfig(psi=2.0, mode="oracle"), device=CPU),
        device=CPU)
    lens = (5, 14)
    for cls, e in ((jengine.Request, ref_eng), (Request, eng)):
        r = np.random.default_rng(1)
        for i in range(4):
            e.submit(cls(rid=i, prompt=r.integers(
                2, jcfg.vocab - 1, lens[i % 2]).astype(np.int32), max_new=5))
    want, got = ref_eng.run(ticks=24), eng.run(ticks=24)
    assert [r.output for r in eng.completed] == \
        [r.output for r in ref_eng.completed]
    for key in ("completed", "tokens_served", "queued"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _leaf_err(got, want) -> float:
    g, w = _np(got), np.asarray(want, np.float32)
    scale = float(np.abs(w).max())
    return float(np.abs(g - w).max()) / scale if scale else \
        float(np.abs(g).max())


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    jcfg = _jcfg(arch, loss_chunk=8)
    jp, cfg, params = _carry(jcfg, seed=4)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32),
             "loss_mask": (rng.random((2, 16)) > 0.25).astype(np.float32)}
    (jl, jm), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    params = _requiring_grad(params)
    loss, metrics = model.loss_fn(
        params, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_aux"].detach()),
                               float(jm["moe_aux"]), rtol=1e-5)
    assert float(metrics["moe_aux"].detach()) > 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert _leaf_err(node.grad, leaf) <= GRAD_TOL, path


def _dense_oracle(x, p, cfg, top_i, weights, keep_tok):
    """Each token's k experts applied one by one (SwiGLU), weighted by
    the renormalised top-k weights; ``keep_tok`` [T, k] zeroes the
    dropped assignments."""
    out = torch.zeros_like(x)
    for j in range(top_i.shape[1]):
        e = top_i[:, j]
        h1 = torch.einsum("td,tdf->tf", x, p["w1"][e])
        h3 = torch.einsum("td,tdf->tf", x, p["w3"][e])
        y = torch.einsum("tf,tfd->td", torch.nn.functional.silu(h1) * h3,
                         p["w2"][e])
        out = out + y * (weights[:, j] * keep_tok[:, j])[:, None]
    return out


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_moe_gradients_in_float64_match_a_dense_oracle(cf):
    """The capacity dispatch, expert GEMMs and scatter-add combine under
    autograd against the dense per-token oracle, in float64, with every
    assignment kept (cf 4) and with drops (cf 0.25): outputs, aux and the
    gradients of x and every weight within 1e-8."""
    jcfg = _jcfg("mixtral-8x22b", dtype="float64", param_dtype="float64",
                 capacity_factor=cf)
    cfg = _port_cfg(jcfg)
    gen = torch.Generator().manual_seed(9)
    p = {k: v.double().requires_grad_()
         for k, v in moe.init_moe(gen, cfg.replace(param_dtype="float32"),
                                  CPU).items()}
    x = torch.randn((40, cfg.d_model), generator=gen,
                    dtype=torch.float64).requires_grad_()
    out, aux = moe.moe_ffn_local(x, p, cfg)
    (out.square().sum() + aux).backward()
    got = [x.grad] + [p[k].grad for k in sorted(p)]

    xs, ps = x.detach().requires_grad_(), {
        k: v.detach().requires_grad_() for k, v in p.items()}
    probs = torch.softmax(xs @ ps["router"], dim=-1)
    top_p, top_i = moe._top_k(probs, cfg.top_k)
    weights = top_p / top_p.sum(-1, keepdim=True)
    # which assignments the capacity keeps, in token order
    _, meta, _ = moe.route_and_dispatch(x.detach(), p["router"].detach(),
                                        cfg)
    keep = torch.zeros(x.shape[0] * cfg.top_k, dtype=torch.float64)
    order = torch.argsort(top_i.reshape(-1), stable=True)
    keep[order] = meta.keep.double()
    keep = keep.reshape(-1, cfg.top_k)
    if cf > 1:
        assert bool(keep.all())
    else:
        assert not bool(keep.all())
    frac = torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts
                          ).double() / top_i.numel()
    aux_o = cfg.n_experts * torch.sum(frac * probs.mean(0))
    want = _dense_oracle(xs, ps, cfg, top_i, weights, keep)
    (want.square().sum() + aux_o).backward()
    torch.testing.assert_close(out, want, atol=1e-8, rtol=1e-8)
    torch.testing.assert_close(aux, aux_o, atol=1e-8, rtol=1e-8)
    for g, w in zip(got, [xs.grad] + [ps[k].grad for k in sorted(ps)]):
        torch.testing.assert_close(g, w, atol=1e-8, rtol=1e-8)


def test_moe_family_is_no_longer_refused():
    cfg = _port_cfg(_jcfg("grok-1-314b"))
    transformer.check_family(cfg)
    assert "moe" in transformer.FAMILIES
