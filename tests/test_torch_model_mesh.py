"""The model mesh (`repro_torch.parallel.axes` placements, the port's
transport, `repro_torch.launch.{mesh,steps,hlo_analysis,dryrun}`,
tensor-parallel attention, the MoE expert-parallel branches, the sharding
specs, elastic restore) against the JAX reference's unsharded functions.

Four gloo ranks are spawned once for the module (``file://``
rendezvous); they run `tests/_model_mesh_ranks.py` on the CPU in the
background while the test process computes the reference's values, and
the dry run runs in a subprocess beside them. The inputs are numpy draws
from fixed seeds and the reference's own parameters, carried across.

Tolerances:
- the sharded loss of reduced qwen2.5-3b on (data 2, model 2) under
  TRAIN_RULES within 1e-5 of the reference's unsharded loss (the
  reference's own gate for its sharded loss is 5e-3,
  `tests/test_parallel.py:54`);
- the MoE expert-parallel branches and GQA alignment within 1e-5 of the
  reference's `moe_ffn_local` / `blockwise_attention` (its gates,
  `tests/test_parallel.py:80,111`);
- aligned-cache serving (`kv_cache_align=4`, bf16 and int8 caches) and
  reduced mamba2 / zamba2 / whisper serving through `build_step`'s prefill and
  serve steps within 1e-4 of the reference's unsharded prefill and
  decode (float32; the port's single device is held to 1e-4 against the
  same reference, `tests/test_torch_models.py`);
- a checkpoint restored with ``shardings=`` and resharded: bit for bit;
- the dry run's single-device FLOPs within 2% of the reference's dot
  FLOPs (its HLO analysis' ``dot`` instructions) of the same reduced
  train step: the port counts the attention plain version's and its
  backward's products, which skip no block, where XLA's fused einsums
  are counted once each; the reference's elementwise FLOPs are not
  counted by the port.
"""

import dataclasses
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _model_mesh_ranks  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.attention import blockwise_attention as jattn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import axes as jaxes  # noqa: E402
from repro_torch.checkpoint.manager import save_checkpoint  # noqa: E402
from repro_torch.configs import base, inputs  # noqa: E402
from repro_torch.data.pipeline import global_batch_sharding  # noqa: E402
from repro_torch.launch import hlo_analysis, steps  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel import axes  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
JOIN_TIMEOUT = 150.0
STEPS = 4
MOE_MESHES = [(2, 1, 4), (4, 2, 2), (4, 4, 1)]   # (E, data, model)
GQA = [(5, 1), (16, 2)]
FAMILY_ARCHS = ("mamba2-1.3b", "zamba2-1.2b", "whisper-large-v3",
                "internvl2-76b")


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _init(key: int, jcfg):
    return jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(key), jcfg)


def _qwen():
    jcfg = jinputs.reduced_config(jbase.get_config("qwen2.5-3b"))
    return jcfg, _init(0, jcfg)


def _moe_cfg(e):
    return jinputs.reduced_config(jbase.get_config("mixtral-8x22b")).replace(
        d_model=64, d_ff=128, n_experts=e, capacity_factor=8.0)


def _inputs():
    rng = np.random.default_rng(0)
    jcfg, jp = _qwen()
    spec = {"qwen": _np_tree(jp),
            "tokens": rng.integers(2, 250, (4, 32)),
            "serve_tokens": rng.integers(2, 250, (2, 16)), "steps": STEPS}
    spec["moe"] = {}
    for i, (e, dn, mn) in enumerate(MOE_MESHES):
        p = jmoe.init_moe(jax.random.PRNGKey(10 + i), _moe_cfg(e))
        spec["moe"][(e, dn, mn)] = (
            _np_tree(p), rng.normal(size=(8, 16, 64)).astype(np.float32),
            rng.normal(size=(8, 1, 64)).astype(np.float32))
    for i, arch in enumerate(FAMILY_ARCHS):
        jc = jinputs.reduced_config(jbase.get_config(arch))
        spec[arch] = _np_tree(_init(20 + i, jc))
    spec["families"] = FAMILY_ARCHS
    spec["frames"] = rng.normal(size=(2, 24, 64)).astype(np.float32)
    spec["patches"] = rng.normal(size=(2, 8, 64)).astype(np.float32)
    spec["gqa"] = {(h, g): tuple(
        rng.normal(size=(2, 32, n, 16)).astype(np.float32)
        for n in (h, g, g)) for h, g in GQA}
    return jcfg, jp, spec


class _Ranks:
    def __init__(self, world, spec, tmp):
        self.world, self.tmp = world, Path(tmp)
        torch.save(spec, self.tmp / "spec.pt")
        self._out = None
        self.ctx = torch.multiprocessing.start_processes(
            _model_mesh_ranks.main,
            args=(world, str(self.tmp / "rendezvous"),
                  str(self.tmp / "spec.pt"), str(self.tmp)),
            nprocs=world, join=False, start_method="spawn")

    def results(self):
        if self._out is None:
            deadline = time.monotonic() + JOIN_TIMEOUT
            while not self.ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    pytest.fail(f"ranks still running after "
                                f"{JOIN_TIMEOUT:.0f} s")
            self._out = [torch.load(self.tmp / f"rank{r}.pt",
                                    weights_only=False)
                         for r in range(self.world)]
        return self._out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_mesh")
    jcfg, jp, spec = _inputs()
    params = model.params_from_numpy(spec["qwen"], dataclasses.replace(
        base.get_config("qwen2.5-3b"), **{
            f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(jcfg)}), device=CPU)
    save_checkpoint(tmp / "ckpt", 7, params)
    spec["ckpt_dir"] = str(tmp / "ckpt")
    spec["jobs"] = ["loss", "moe", "gqa", "decode", "families",
                    "checkpoint", "sharded_init"]
    ranks = _Ranks(4, spec, tmp)
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "train_4k", "--mesh", "both", "--set",
         "n_layers=2", "--out", str(tmp / "dryrun")],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp), "OMP_NUM_THREADS": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield types.SimpleNamespace(ranks=ranks, dry=dry, tmp=tmp, spec=spec,
                                jcfg=jcfg, jp=jp, params=params)
    for p in ranks.ctx.processes:
        if p.is_alive():
            p.kill()
    if dry.poll() is None:
        dry.kill()


def test_sharded_loss_matches_the_reference(run):
    toks = jnp.asarray(run.spec["tokens"], jnp.int32)
    want, _ = jmodel.loss_fn(run.jp, {"tokens": toks, "labels": toks},
                             run.jcfg)
    outs = run.ranks.results()
    for o in outs:
        assert abs(o["loss"] - float(want)) < 1e-5
        assert o["dtensor_redistributions"] == 0


@pytest.mark.parametrize("mesh", MOE_MESHES,
                         ids=["dup2-e2-model4", "eloc2-e4-model2",
                              "model1"])
def test_moe_expert_parallel_branches_match_the_local_oracle(run, mesh):
    p, x, xd = run.spec["moe"][mesh]
    cfg = _moe_cfg(mesh[0])
    jp = jax.tree.map(jnp.asarray, p)
    y, yd = run.ranks.results()[0]["moe"][mesh]
    for got, xin in ((y, x), (yd, xd)):
        want, _ = jmoe.moe_ffn_local(jnp.asarray(xin).reshape(-1, 64), jp,
                                     cfg)
        np.testing.assert_allclose(got.reshape(-1, 64), np.asarray(want),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads", GQA, ids=["h5-g1", "h16-g2"])
def test_gqa_alignment_matches_unsharded_attention(run, heads):
    h, g = heads
    cfg = jinputs.reduced_config(jbase.get_config("qwen1.5-0.5b")).replace(
        n_heads=h, n_kv_heads=g, attn_q_chunk=8, attn_kv_chunk=16)
    q, k, v = (jnp.asarray(t) for t in run.spec["gqa"][heads])
    want = np.asarray(jattn(q, k, v, cfg, causal=True))
    got = run.ranks.results()[0]["gqa"][heads]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _reference_serve(jcfg, jp, toks, steps, extra=None):
    s0 = toks.shape[1] - steps
    logits, caches = jax.jit(jmodel.prefill, static_argnums=2,
                             static_argnames="max_seq")(
        jp, {"tokens": jnp.asarray(toks[:, :s0], jnp.int32),
             **(extra or {})}, jcfg, max_seq=toks.shape[1])
    decode = jax.jit(jmodel.decode_step, static_argnums=4)
    out = [np.asarray(logits)]
    for t in range(steps):
        pos = jnp.full((toks.shape[0],), s0 + t, jnp.int32)
        logits, caches = decode(
            jp, jnp.asarray(toks[:, s0 + t:s0 + t + 1], jnp.int32), caches,
            pos, jcfg)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("cache", ["aligned", "int8"])
def test_aligned_cache_serving_matches_the_reference(run, cache):
    jcfg = run.jcfg.replace(kv_cache_align=4)
    if cache == "int8":
        jcfg = jcfg.replace(kv_cache_dtype="int8")
    assert jcfg.cache_heads == 4
    want = _reference_serve(jcfg, run.jp, run.spec["serve_tokens"], STEPS)
    out = run.ranks.results()[0]["decode"]
    for got, w in zip(out[cache], want):
        np.testing.assert_allclose(got, w, atol=1e-4, rtol=0)
    assert out["serve_redistributions"] == 0
    assert out["decode_heads_over_model"]


def _extra_inputs(cfg) -> tuple:
    return ("frames",) if cfg.family == "audio" else \
        ("patches",) if cfg.frontend == "vision" else ()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_other_families_serve_like_the_reference(run, arch):
    """Mamba2 blocks tensor-parallel over their heads (their own checks
    are `tests/test_torch_ssm_mesh.py`); zamba2's shared attention block,
    whisper's self- and cross-attention and internvl2's dense backbone
    behind its patch embeddings tensor-parallel; on (2, 2)."""
    jcfg = jinputs.reduced_config(jbase.get_config(arch))
    jp = jax.tree.map(jnp.asarray, run.spec[arch])
    extra = {k: jnp.asarray(run.spec[k]) for k in _extra_inputs(jcfg)}
    want = _reference_serve(jcfg, jp, run.spec["serve_tokens"], STEPS,
                            extra)
    for got, w in zip(run.ranks.results()[0]["families"][arch], want):
        np.testing.assert_allclose(got, w, atol=1e-4, rtol=0)


def test_checkpoint_restores_onto_four_and_two_ranks(run):
    want = _model_mesh_ranks._flat(run.params)
    outs = run.ranks.results()
    for r, o in enumerate(outs):
        ck = o["checkpoint"]
        assert ck["four_step"] == ck["two_step"] == 7
        names = ("four", "two", "resharded") if r < 2 else ("four",)
        for name in names:
            assert ck[name].keys() == want.keys()
            for k in want:
                assert torch.equal(ck[name][k], want[k]), (name, k)
        if r >= 2:                       # outside the 2-rank mesh
            assert ck["two"] is None and ck["resharded"] is None


def test_sharded_init_equals_the_resharded_draw(run):
    for r, o in enumerate(run.ranks.results()):
        assert o["sharded_init"] == {f"{a}/{h}": True for a in ("qwen",
                                                                "moe")
                                     for h in ("seed", "generator")}, r


def test_transport_counts_its_collectives(run):
    comm = run.ranks.results()[0]["comm"]
    assert set(comm["counts"]) <= {"all_gather", "all_reduce",
                                   "reduce_scatter", "all_to_all"}
    assert comm["counts"]["all_to_all"] >= 4        # the MoE dispatch
    assert all(comm["bytes"][k] > 0 for k in comm["counts"])


@pytest.mark.parametrize("arch", jbase.list_archs())
def test_specs_equal_the_reference(arch):
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    jp = jsteps.abstract_params(jcfg)
    p = steps.abstract_params(cfg)
    assert model.param_specs(p) == jmodel.param_specs(jp)
    assert _shapes(p) == _shapes(jp)
    want_c = jmodel.cache_specs(jcfg)
    got_c = model.cache_specs(cfg)
    assert _axes(got_c) == _axes(want_c)
    for name, shape in jbase.SHAPES.items():
        if jbase.cell_skip_reason(jcfg, shape):
            continue
        got = inputs.input_specs(cfg, base.SHAPES[name])
        want = jinputs.input_specs(jcfg, shape)
        assert _shapes(got) == _shapes(want), name
        assert all(t.device.type == "meta" for _, t in _leaves(got))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            if v is not None:
                yield from _leaves(v, f"{prefix}/{f}")
    else:
        yield prefix, tree


def _shapes(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _leaves(tree)}


def _axes(tree):
    if isinstance(tree, dict):
        return {k: _axes(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: v for f, v in zip(tree._fields, tree) if v is not None}
    return tree


def test_global_batch_sharding_and_named_sharding():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4))
    sh = global_batch_sharding(mesh, axes.TRAIN_RULES)
    assert tuple(sh.spec) == tuple(jaxes.logical_to_spec(
        ("batch", None), jaxes.TRAIN_RULES,
        mesh=types.SimpleNamespace(shape={"data": 2, "model": 4})))
    ns = axes.named_sharding("heads", "batch", mesh=mesh,
                             rules=axes.TRAIN_RULES)
    assert tuple(ns.spec) == ("model", "data")


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the rule "
                    "where CUDA is missing")
@pytest.mark.parametrize("build", ["host", "production", "resize"])
def test_meshes_default_to_the_card_and_raise_without_it(build):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.runtime.elastic import resize_mesh

    call = {"host": lambda: make_host_mesh(data=1, model=2),
            "production": lambda: make_production_mesh(multi_pod=False),
            "resize": lambda: resize_mesh(4, 0.5, model_parallel=2)}[build]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_dry_run_on_both_production_meshes(run):
    out, _ = run.dry.communicate(timeout=240)
    assert run.dry.returncode == 0, out[-3000:]
    for mesh, n in (("pod16x16", 256), ("pod2x16x16", 512)):
        rec = json.loads((run.tmp / "dryrun" / mesh /
                          "qwen1.5-0.5b__train_4k.json").read_text())
        assert rec["ok"], rec.get("traceback")
        assert rec["memory"]["peak_bytes"] > 0 and rec["fits"]
        assert rec["memory"]["argument_bytes"] > 0
        assert np.prod(list(rec["mesh_shape"].values())) == n
        hlo = rec["hlo"]
        assert hlo["flops"] > 0 and hlo["total_collective_payload"] > 0
        assert hlo["collective_counts"]["all-gather"] > 0


def test_single_device_flops_match_the_reference_dots():
    jcfg = jinputs.reduced_config(jbase.get_config("qwen1.5-0.5b"))
    cfg = inputs.reduced_config(base.get_config("qwen1.5-0.5b"))
    b, s = 2, 16
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = jadamw.AdamWConfig(moment_dtype=jcfg.moment_dtype)
    batch = {"tokens": jnp.ones((b, s), jnp.int32),
             "labels": jnp.ones((b, s), jnp.int32)}
    text = jax.jit(jsteps.make_train_step(jcfg, jopt)).lower(
        jp, jadamw.adamw_init(jp, jopt), batch).compile().as_text()
    comps = jhlo.parse_module(text)
    mult = jhlo._call_multiplicities(comps)
    dots = sum(mult.get(c.name, 0.0) * jhlo._dot_flops(i, c.by_name())
               for c in comps.values() for i in c.instrs
               if i.opcode == "dot")
    p = model.init_params(0, cfg, device=CPU)
    opt = AdamWConfig(moment_dtype=cfg.moment_dtype)
    rep, _ = hlo_analysis.analyze(
        steps.make_train_step(cfg, opt), p, adamw_init(p, opt),
        {k: torch.ones((b, s), dtype=torch.int32) for k in batch})
    assert abs(rep.flops / dots - 1.0) < 0.02
    assert rep.flops < jhlo.analyze(text).flops
    assert rep.total_collective_payload == 0.0
