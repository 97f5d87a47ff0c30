"""The port's training path (the attention and SSD kernels under autograd,
`loss_fn` with remat, the `Trainer`, its launcher and example) against
the JAX reference, on the CPU. The reference's parameters and batches are
carried across as numpy (`params_from_numpy`); on CPU tensors the
kernels' wrappers run their plain versions, so the Functions' forward is
the plain version and their backward the port's own formula.

Tolerances (float32 throughout):
- loss within rtol 1e-5 of the reference's; each gradient leaf within
  1e-5 of that leaf's largest reference entry (the two differ in the
  order of float32 sums: the online softmax, the SSD chunks);
- the Functions' gradients within 1e-5 of the largest entry of the
  reference's (jax.grad of `blockwise_attention` / `ssd_chunked`) and of
  autograd through the plain versions (`attention_ref`,
  `flash_attention_plain`, `ssd_scan_plain`; 1e-4 against the sequential
  `ssd_ref`, which sums in another order);
- remat none / full / dots: equal bit for bit (the recompute runs the
  same operations on the same inputs);
- the trainer's per-step losses within rtol 1e-4 of the reference's over
  6 steps (AdamW divides by sqrt(v), which amplifies float32 noise in the
  first steps), and its meter summary equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.energy.markets import MarketParams  # noqa: E402
from repro.energy.markets import generate_market as jgenerate  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.energy.stream import PriceStream  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention, model, ssm  # noqa: E402
from repro_torch.runtime.scheduler import (Action,  # noqa: E402
                                           EnergyAwareScheduler,
                                           SchedulerConfig)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

CPU = torch.device("cpu")
GRAD_TOL = 1e-5


def _port_cfg(jcfg):
    return base.ModelConfig(**dataclasses.asdict(jcfg))


def _leaf_err(got, want) -> float:
    """max |got - want| / max |want| (0 when both are 0)."""
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = float(np.abs(w).max())
    return float(np.abs(g - w).max()) / scale if scale else \
        float(np.abs(g).max())


def _walk(pt, jt=None, path=""):
    """(path, port leaf, reference leaf or None) over the port's tree."""
    if isinstance(pt, dict):
        for k in pt:
            yield from _walk(pt[k], None if jt is None else jt[k],
                             f"{path}/{k}")
    else:
        yield path, pt, jt


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


# ---------------------------------------------------------------------------
# loss_fn and its gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

LOSS_CASES = [
    # (arch, loss_mask, loss_chunk)
    ("qwen1.5-0.5b", True, 8),      # dense: QKV bias, tied embeddings
    ("qwen1.5-0.5b", False, 0),
    ("internvl2-76b", True, 8),     # vlm: patches and pmask
    ("mamba2-1.3b", False, 8),      # ssm
    ("zamba2-1.2b", True, 0),       # hybrid
]


def _loss_inputs(jcfg, with_mask: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)}
    if with_mask:
        batch["loss_mask"] = (rng.random((b, s)) > 0.25).astype(np.float32)
    if jcfg.frontend == "vision":
        batch["patches"] = rng.normal(
            size=(b, jcfg.vis_tokens, jcfg.d_model)).astype(np.float32)
    return batch


def _port_loss(tree, batch, cfg):
    params = _requiring_grad(model.params_from_numpy(tree, cfg, device=CPU))
    loss, metrics = model.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    loss.backward()
    return params, loss, metrics


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: str(c))
def test_loss_and_every_gradient_leaf_match_the_reference(case):
    arch, with_mask, chunk = case
    jcfg = jinputs.reduced_config(jbase.get_config(arch)).replace(
        loss_chunk=chunk)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _loss_inputs(jcfg, with_mask)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg),
        has_aux=True)(jp)
    cfg = _port_cfg(jcfg)
    params, loss, metrics = _port_loss(jax.tree.map(np.asarray, jp), batch,
                                       cfg)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    for k in ("ce", "moe_aux", "tokens"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                  abs=1e-7)
    n = 0
    for path, p, w in _walk(params, {k: jg[k] for k in params}):
        assert p.grad is not None, path
        assert _leaf_err(p.grad, w) <= GRAD_TOL, path
        n += 1
    assert n >= 10


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_remat_changes_no_value(arch):
    """remat none, full and dots give the same loss and gradients, bit
    for bit, with the loss chunked."""
    jcfg = jinputs.reduced_config(jbase.get_config(arch)).replace(
        loss_chunk=8)
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jax.random.PRNGKey(1), jcfg))
    batch = _loss_inputs(jcfg, True, seed=1)
    runs = {}
    for remat in ("none", "full", "dots"):
        params, loss, _ = _port_loss(tree, batch,
                                     _port_cfg(jcfg).replace(remat=remat))
        runs[remat] = (loss, params)
    loss0, p0 = runs["none"]
    for remat in ("full", "dots"):
        loss1, p1 = runs[remat]
        assert torch.equal(loss0, loss1), remat
        for (path, a, _), (_, b, _) in zip(_walk(p0), _walk(p1)):
            assert torch.equal(a.grad, b.grad), (remat, path)


def test_chunked_loss_equals_the_whole_one():
    """The chunked cross-entropy equals the whole one, with grad mode on
    (each chunk under checkpoint) and off (no checkpoint, nothing
    recorded)."""
    jcfg = jinputs.reduced_config(jbase.get_config("qwen1.5-0.5b"))
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jax.random.PRNGKey(2), jcfg))
    batch = {k: torch.from_numpy(v)
             for k, v in _loss_inputs(jcfg, True, seed=2).items()}
    cfg = _port_cfg(jcfg).replace(remat="full")
    params = model.params_from_numpy(tree, cfg, device=CPU)
    whole, _ = model.loss_fn(params, batch, cfg.replace(loss_chunk=0))
    chunked, _ = model.loss_fn(params, batch, cfg.replace(loss_chunk=4))
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)
    with torch.no_grad():
        served, _ = model.loss_fn(params, batch, cfg.replace(loss_chunk=4))
    assert not served.requires_grad and torch.equal(served, chunked)


# ---------------------------------------------------------------------------
# the two Functions' backward formulas
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (Sq, Skv, H, G, Dh, causal, window, q_offset)
    (40, 40, 4, 2, 16, True, 0, 0),       # causal, GQA
    (40, 40, 4, 4, 16, True, 8, 0),       # windowed, MHA
    (24, 40, 4, 1, 32, True, 0, 16),      # chunked prefill: q_offset
    (33, 33, 2, 2, 16, True, 12, 0),      # ragged S, window and causal
    (17, 29, 4, 2, 16, False, 0, 0),      # no mask, Sq != Skv
]


def _attn_case(case, seed=0):
    sq, skv, h, g, dh = case[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((2, sq, h, dh), (2, skv, g, dh), (2, skv, g, dh),
                      (2, sq, h, dh))]
    return arrs


def _jax_attn_grads(case, q, k, v, w):
    sq, skv, _, _, _, causal, window, q_offset = case
    jcfg = jinputs.reduced_config(jbase.get_config("qwen2.5-3b")).replace(
        attn_q_chunk=8, attn_kv_chunk=8)

    def f(q, k, v):
        out = jattn.blockwise_attention(q, k, v, jcfg, causal=causal,
                                        window=window, q_offset=q_offset)
        return jnp.sum(out * w)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: str(c))
def test_attention_function_gradients_match_the_reference(case):
    """`blockwise_attention` with inputs that require grad goes through
    `FlashAttention`; its dq, dk, dv equal jax.grad of the reference's
    blockwise attention and autograd through the plain dense and blocked
    versions;
    `attention_backward` gives the same at 16-row query tiles."""
    sq, skv, h, g, dh, causal, window, q_offset = case
    q, k, v, w = _attn_case(case)
    want = _jax_attn_grads(case, q, k, v, w)
    cfg = _port_cfg(jinputs.reduced_config(jbase.get_config("qwen2.5-3b")))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = attention.FlashAttention.backward_calls
    out = attention.blockwise_attention(*ts, cfg, causal=causal,
                                        window=window, q_offset=q_offset)
    (out * torch.from_numpy(w)).sum().backward()
    assert attention.FlashAttention.backward_calls == before + 1
    plain = {}
    for name, fn in (("dense", ref.attention_ref),
                     ("blocked", ref.flash_attention_plain)):
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*ins, causal=causal, window=window, q_offset=q_offset)
         * torch.from_numpy(w)).sum().backward()
        plain[name] = [t.grad.numpy() for t in ins]
    tiled = attention.attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v)), out.detach(),
        torch.from_numpy(w), causal, window, q_offset, tile=16)
    for i, (name, t, tl, jw) in enumerate(zip("qkv", ts, tiled, want)):
        assert _leaf_err(t.grad, jw) <= GRAD_TOL, name
        for route in plain:
            assert _leaf_err(t.grad, plain[route][i]) <= GRAD_TOL, \
                (name, route)
        assert _leaf_err(tl, jw) <= GRAD_TOL, name


SSD_CASES = [
    # (S, H, P, G, N, chunk, with h0)
    (16, 4, 8, 1, 8, 8, False),      # shared group, whole chunks
    (13, 4, 8, 4, 8, 8, True),       # one head a group, ragged S, h0
    (24, 2, 4, 2, 16, 8, True),      # three chunks, h0
]


def _ssd_case(case, seed=0):
    s, h, p, g, n = case[:5]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, h, p)).astype(np.float32)
    dt = (0.05 + 0.2 * rng.random((2, s, h))).astype(np.float32)
    a = -(0.5 + rng.random(h)).astype(np.float32)
    b = rng.normal(size=(2, s, g, n)).astype(np.float32)
    c = rng.normal(size=(2, s, g, n)).astype(np.float32)
    h0 = rng.normal(size=(2, h, p, n)).astype(np.float32)
    wy = rng.normal(size=(2, s, h, p)).astype(np.float32)
    wh = rng.normal(size=(2, h, p, n)).astype(np.float32)
    return [x, dt, a, b, c, h0], wy, wh


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: str(c))
def test_ssd_function_gradients_match_the_reference(case):
    """The model's `ssd_scan` with inputs that require grad goes through
    `SSDScan`; dx, ddt, da, db, dc (and dh0) equal jax.grad of the
    reference's `ssd_chunked` and autograd through `ssd_scan_plain` and
    the sequential `ssd_ref`."""
    chunk, with_h0 = case[5], case[6]
    ins, wy, wh = _ssd_case(case)
    n_in = 6 if with_h0 else 5

    def jf(*args):
        h0 = args[5] if with_h0 else None
        y, hl = jssm.ssd_chunked(*args[:5], chunk, h0)
        return jnp.sum(y * wy) + jnp.sum(hl * wh)
    want = jax.grad(jf, argnums=tuple(range(n_in)))(*ins[:n_in])
    ts = [torch.from_numpy(a).requires_grad_() for a in ins[:n_in]]
    before = ssm.SSDScan.backward_calls
    y, hl = ssm.ssd_scan(*ts[:5], chunk, ts[5] if with_h0 else None)
    ((y * torch.from_numpy(wy)).sum()
     + (hl * torch.from_numpy(wh)).sum()).backward()
    assert ssm.SSDScan.backward_calls == before + 1
    plain = {}
    for route, fn in (("sequential", lambda *a: ref.ssd_ref(*a[:5], a[6])),
                      ("chunked", ref.ssd_scan_plain)):
        d = [torch.from_numpy(a).requires_grad_() for a in ins[:n_in]]
        yd, hd = fn(*d[:5], chunk, d[5] if with_h0 else None)
        ((yd * torch.from_numpy(wy)).sum()
         + (hd * torch.from_numpy(wh)).sum()).backward()
        plain[route] = [t.grad.numpy() for t in d]
    for i, (name, t, jw) in enumerate(zip(("x", "dt", "a", "b", "c", "h0"),
                                          ts, want)):
        assert _leaf_err(t.grad, jw) <= GRAD_TOL, name
        # the sequential recurrence sums in another order than any chunked
        # form: 1e-4
        assert _leaf_err(t.grad, plain["sequential"][i]) \
            <= 10 * GRAD_TOL, name
        assert _leaf_err(t.grad, plain["chunked"][i]) <= GRAD_TOL, name


def test_functions_stay_out_of_serving():
    """Without grad the model calls the kernels' wrappers directly: no
    Function runs, as in serving."""
    cfg = _port_cfg(jinputs.reduced_config(jbase.get_config("qwen2.5-3b")))
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_case(ATTN_CASES[0]))
    before = attention.FlashAttention.calls
    attention.blockwise_attention(q.requires_grad_(), k, v, cfg,
                                  causal=True)
    assert attention.FlashAttention.calls == before + 1
    with torch.no_grad():
        attention.blockwise_attention(q, k, v, cfg, causal=True)
    attention.blockwise_attention(q.detach(), k, v, cfg, causal=True)
    assert attention.FlashAttention.calls == before + 1


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class _Injected:
    """The reference pipeline's batches as port tensors."""

    def __init__(self, data):
        self.data = data

    def batch_at(self, step, device=None):
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in self.data.batch_at(step).items()}


def _forcing(prices, cls_action):
    class Forcing:
        """Shutdown after every 3rd step (tests/test_runtime.py)."""

        def __init__(self):
            self.i = 0
            self.stream = PriceStream(np.asarray(prices))
            self.p_thresh = np.inf

        def step(self, hours=1.0):
            self.i += 1
            self.stream.advance(hours)
            return {4: cls_action.SHUTDOWN, 5: cls_action.STAY_DOWN,
                    6: cls_action.RESUME}.get(self.i % 7, cls_action.RUN)
    return Forcing()


@pytest.fixture(scope="module")
def market_prices():
    return np.asarray(jgenerate(MarketParams(n_hours=3000, seed=7)).prices)


def _qwen_smoke():
    jcfg = jinputs.reduced_config(jbase.get_config("qwen1.5-0.5b"))
    return jcfg, _port_cfg(jcfg)


def _mk(tmp_path, steps=12, scheduler=None, batch_size=2, **kw):
    _, cfg = _qwen_smoke()
    return Trainer(cfg, TrainerConfig(steps=steps, ckpt_dir=str(tmp_path),
                                      ckpt_every=4, **kw),
                   scheduler=scheduler, batch_size=batch_size, seq_len=16,
                   device=CPU)


def test_trainer_follows_the_reference(tmp_path, market_prices):
    """The reference's initial parameters and batches carried across, the
    same forced SHUTDOWN / STAY_DOWN / RESUME sequence: per-step losses
    within rtol 1e-4 over 6 steps, and the meter summaries equal."""
    jcfg, cfg = _qwen_smoke()
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(
        steps=6, ckpt_dir=str(tmp_path / "ref"), ckpt_every=4),
        scheduler=_forcing(market_prices, jsched.Action), batch_size=2,
        seq_len=16)
    init = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(jt.tcfg.seed), jcfg))
    pt = Trainer(cfg, TrainerConfig(steps=6, ckpt_dir=str(tmp_path / "port"),
                                    ckpt_every=4),
                 scheduler=_forcing(market_prices, Action),
                 data=_Injected(jt.data), batch_size=2, seq_len=16,
                 device=CPU)
    pt.params = model.params_from_numpy(init, cfg, device=CPU)
    jout = jt.run(log_every=0)
    pout = pt.run(log_every=0)
    assert [r["step"] for r in pt.history] == [r["step"]
                                               for r in jt.history]
    np.testing.assert_allclose([r["loss"] for r in pt.history],
                               [r["loss"] for r in jt.history], rtol=1e-4)
    assert pt.meter.summary() == jt.meter.summary()
    assert pout["restarts"] == jout["restarts"] > 0
    assert pout["lost_steps"] == jout["lost_steps"]


def test_pause_resume_bit_identical(tmp_path, market_prices):
    """A run interrupted by shutdowns lands on exactly the parameters of
    an uninterrupted run (tests/test_runtime.py, on the port)."""
    base_run = _mk(tmp_path / "a", steps=10)
    base_run.run(log_every=0)
    intr = _mk(tmp_path / "b", steps=10,
               scheduler=_forcing(market_prices, Action))
    out = intr.run(log_every=0)
    assert out["restarts"] > 0
    for (path, a, _), (_, b, _) in zip(_walk(base_run.params),
                                       _walk(intr.params)):
        assert torch.equal(a, b), path


def test_fault_injection_recovers_and_accounts(tmp_path):
    t = _mk(tmp_path, steps=10, fault_prob_per_step=0.4, seed=3)
    out = t.run(log_every=0)
    assert t.step == 10
    assert out["lost_steps"] > 0
    assert np.isfinite(out["final_loss"])


def test_straggler_mitigation_drops_and_renormalises(tmp_path):
    """Dropped microbatches are counted, and a step whose keep mask
    drops one microbatch equals the mean gradient of the kept ones."""
    t = _mk(tmp_path, steps=6, straggler_sigma=1.0, microbatches=4,
            n_hosts=4, seed=5, batch_size=4)
    out = t.run(log_every=0)
    assert out["dropped_microbatches"] > 0
    assert np.isfinite(out["final_loss"])

    def step(keep, micro, batch):
        tr = _mk(tmp_path / f"s{micro}", steps=1, microbatches=micro,
                 batch_size=len(keep))
        tr.opt = tr.opt._replace(clip_norm=0.0, weight_decay=0.0)
        tr.train_step(batch, 1e-3, np.asarray(keep, np.float32))
        return tr.params
    batch = t.data.batch_at(0, device=CPU)
    dropped = step([1, 0, 1, 1], 4, batch)
    kept = {k: v[[0, 2, 3]] for k, v in batch.items()}
    # the same three rows as three microbatches, none dropped
    three = step([1, 1, 1], 3, kept)
    for (path, a, _), (_, b, _) in zip(_walk(dropped), _walk(three)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=path)


def test_energy_aware_run_realises_the_planned_fraction(tmp_path,
                                                        market_prices):
    """hysteresis 1.0: the realised shutdown fraction equals the
    threshold policy's off-fraction over the covered hours
    (tests/test_runtime.py, on the port with the reference's market)."""
    sched = EnergyAwareScheduler(PriceStream(market_prices),
                                 SchedulerConfig(psi=0.5, hysteresis=1.0),
                                 device=CPU)
    t = _mk(tmp_path / "ws", steps=30, scheduler=sched)
    out = t.run(log_every=0)
    assert out["restarts"] > 0
    assert t.meter.energy_cost < t.meter.ao_energy_cost
    covered = int(round(out["hours"]
                        - out["restarts"] * t.tcfg.restart_time_h))
    want_x = float((market_prices[:covered] > sched.p_thresh).mean())
    assert out["x_realized"] == pytest.approx(want_x, abs=0.02)
    assert t.measured_restart_overhead_frac() > t.tcfg.restart_energy_mwh


def test_grad_compress_trains(tmp_path):
    t = _mk(tmp_path, steps=6, grad_compress=True)
    out = t.run(log_every=0)
    assert np.isfinite(out["final_loss"])
    assert any(float(e.abs().max()) > 0 for _, e, _ in _walk(t.err))


# ---------------------------------------------------------------------------
# the surfaces
# ---------------------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--steps", "4", "--seq", "16",
                       "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert '"final_loss"' in out and "scheduler:" in out


def test_training_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import energy_aware_training as ex
    out = ex.main(["--smoke", "--device", "cpu", "--steps", "60",
                   "--batch", "2", "--seq", "16"])
    assert np.isfinite(out["final_loss"]) and out["restarts"] > 0
    assert "=== outcome ===" in capsys.readouterr().out
