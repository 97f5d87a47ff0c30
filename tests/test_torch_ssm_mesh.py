"""The tensor-parallel Mamba2 block (`repro_torch.models.ssm` under a live
mesh: x, dt and the SSD scan on each rank's heads, the gated norm and
out_proj across ranks, the SSM state sharded over the heads) against the
JAX reference's unsharded functions.

Four gloo ranks are spawned once for the module (``file://``
rendezvous); they run `tests/_ssm_mesh_ranks.py` on the CPU in the
background while the test process computes the reference's values, and
the dry run of mamba2-1.3b's prefill on the (16, 16) mesh runs in a
subprocess beside them. The inputs are numpy draws from fixed seeds and
the reference's own parameters, carried across.

Tolerances:
- reduced mamba2-1.3b and zamba2-1.2b (8 SSD heads, float32) served
  through `build_step`'s prefill and serve steps on (1, 4) and (2, 2),
  and the 6-head variant on (1, 4), within 1e-4 of the reference's
  unsharded prefill and decode (the port's single device is held to
  1e-4 against the same reference, `tests/test_torch_ssm.py`);
- the sharded train loss of reduced mamba2 on (2, 2) under TRAIN_RULES
  within 1e-5 of the reference's unsharded loss, and the in_proj,
  out_proj, A_log and conv_w gradients within 1e-4 of `jax.grad`'s (the
  gate of the reference's own sharded-loss check is 5e-3,
  `tests/test_parallel.py:54`).
"""

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

import _ssm_mesh_ranks  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import base  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
JOIN_TIMEOUT = 150.0
STEPS = 4
ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
MESHES = [(1, 4), (2, 2)]
GRAD_LEAVES = ("in_proj", "out_proj", "A_log", "conv_w")
DRY_LAYERS = (2, 4)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _jcfg(arch, **kw):
    return jinputs.reduced_config(jbase.get_config(arch)).replace(**kw)


def _init(key: int, jcfg):
    return jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(key), jcfg)


def _inputs():
    rng = np.random.default_rng(31)
    spec = {"archs": ARCHS, "meshes": MESHES, "steps": STEPS,
            "serve_tokens": rng.integers(2, 250, (2, 16)),
            "train_tokens": rng.integers(2, 250, (4, 32)),
            "grad_leaves": GRAD_LEAVES,
            "block": tuple(rng.normal(size=(4, 32, 64)).astype(np.float32)
                           for _ in range(2)),
            "jobs": ["serve", "narrow", "train", "block_grad"]}
    for i, arch in enumerate(ARCHS):
        spec[arch] = _np_tree(_init(40 + i, _jcfg(arch)))
    spec["narrow"] = _np_tree(_init(42, _jcfg("mamba2-1.3b", d_model=48)))
    return spec


class _Ranks:
    def __init__(self, world, spec, tmp):
        self.world, self.tmp = world, Path(tmp)
        torch.save(spec, self.tmp / "spec.pt")
        self._out = None
        self.ctx = torch.multiprocessing.start_processes(
            _ssm_mesh_ranks.main,
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
    tmp = tmp_path_factory.mktemp("ssm_mesh")
    spec = _inputs()
    ranks = _Ranks(4, spec, tmp)
    dry = {n: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-1.3b", "--shape", "prefill_32k", "--mesh", "pod", "--set",
         f"n_layers={n}", "--out", str(tmp / f"dryrun{n}")],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp), "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in DRY_LAYERS}
    yield types.SimpleNamespace(ranks=ranks, dry=dry, tmp=tmp, spec=spec)
    for p in ranks.ctx.processes:
        if p.is_alive():
            p.kill()
    for p in dry.values():
        if p.poll() is None:
            p.kill()


def _reference_serve(jcfg, jp, toks, steps):
    s0 = toks.shape[1] - steps
    logits, caches = jax.jit(jmodel.prefill, static_argnums=2,
                             static_argnames="max_seq")(
        jp, {"tokens": jnp.asarray(toks[:, :s0], jnp.int32)}, jcfg,
        max_seq=toks.shape[1])
    decode = jax.jit(jmodel.decode_step, static_argnums=4)
    out = [np.asarray(logits)]
    for t in range(steps):
        pos = jnp.full((toks.shape[0],), s0 + t, jnp.int32)
        logits, caches = decode(
            jp, jnp.asarray(toks[:, s0 + t:s0 + t + 1], jnp.int32), caches,
            pos, jcfg)
        out.append(np.asarray(logits))
    return out


def _held(got, jcfg, tree, toks):
    want = _reference_serve(jcfg, jax.tree.map(jnp.asarray, tree), toks,
                            STEPS)
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=["d1-m4", "d2-m2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_the_reference(run, arch, mesh):
    """Prefill with cache and 4 decode steps through `build_step` on
    every rank, within 1e-4 of the reference's unsharded run, with no
    redistribution of DTensor's own."""
    for o in run.ranks.results():
        rec = o["serve"][(arch, mesh)]
        _held(rec["logits"], _jcfg(arch), run.spec[arch],
              run.spec["serve_tokens"])
        assert rec["redistributions"] == 0


@pytest.mark.parametrize("mesh", MESHES, ids=["d1-m4", "d2-m2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_scan_runs_on_each_ranks_heads(run, arch, mesh):
    """Every prefill SSD scan of a rank takes x [B / data, S, 8 / model,
    16]: the rank's rows and heads, never all 8."""
    jcfg = _jcfg(arch)
    dn, mn = mesh
    want = (2 // dn, 12, jcfg.ssm_heads // mn, jcfg.ssm_head_dim)
    for o in run.ranks.results():
        scans = o["serve"][(arch, mesh)]["scans"]
        assert scans == [want] * jcfg.n_layers


@pytest.mark.parametrize("mesh", MESHES, ids=["d1-m4", "d2-m2"])
def test_the_cache_stays_on_the_reference_axes(run, mesh):
    """After the prefill the state leaf is split over the heads on
    ``model`` and the conv leaf sits on `_SSM_CACHE_AXES`'s placements
    (x|B|C over ``model``)."""
    for o in run.ranks.results():
        for arch in ARCHS:
            pl = o["serve"][(arch, mesh)]["placements"]
            for name in ("conv", "state"):
                got, want = pl[name]
                assert got == want, (arch, name)
            assert pl["state"][0][1] == "S(2)"      # [L, B, H, P, N]
            assert pl["conv"][0][1] == "S(3)"      # [L, B, K-1, C]


def test_decode_moves_no_weight_and_no_state(run):
    """One decode step of reduced mamba2 on (1, 4): no collective carries
    as much as a layer's in_proj, out_proj or state (the data-parallel
    block gathered all three whole a layer); a layer issues 2 all-to-alls
    (the z|x|B|C|dt columns and the conv outputs, each rank its heads'
    and all of B|C), 2 all-reduces (the norm's sum of squares, out_proj's
    partial sums) and no all-gather."""
    jcfg = _jcfg("mamba2-1.3b")
    tree = run.spec["mamba2-1.3b"]["blocks"]["ssm"]
    state = 2 * jcfg.ssm_heads * jcfg.ssm_head_dim * jcfg.ssm_state * 4
    smallest = min(tree["in_proj"][0].nbytes, tree["out_proj"][0].nbytes,
                   state)
    for o in run.ranks.results():
        calls = o["serve"][("mamba2-1.3b", (1, 4))]["decode_calls"]
        assert max(b for _, b in calls) < smallest
        kinds = [k for k, _ in calls]
        assert kinds.count("all_to_all") == 2 * jcfg.n_layers
        # + 1: the vocabulary-parallel embedding's partial sums
        assert kinds.count("all_reduce") == 2 * jcfg.n_layers + 1
        assert kinds.count("all_gather") == 0


def test_undivided_heads_stay_whole(run):
    """6 heads (d_model 48) on model 4: the axis does not divide the
    heads, so every rank scans all 6 of its rows' heads and the state is
    replicated over ``model``; within 1e-4 of the reference."""
    jcfg = _jcfg("mamba2-1.3b", d_model=48)
    assert jcfg.ssm_heads == 6
    for o in run.ranks.results():
        rec = o["narrow"]
        _held(rec["logits"], jcfg, run.spec["narrow"],
              run.spec["serve_tokens"])
        assert rec["scans"] == [(2, 12, 6, 16)] * jcfg.n_layers
        assert rec["placements"]["state"][0] == ("R", "R")
        assert rec["redistributions"] == 0


def _leaf_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1.0)


def test_sharded_training_matches_the_reference(run):
    """Reduced mamba2 on (2, 2) under TRAIN_RULES (the sequence split over
    ``model`` between blocks, gathered inside): the loss within 1e-5 of
    the reference's unsharded loss, the Mamba2 weights' gradients within
    1e-4 of `jax.grad`'s (each leaf's worst error over max(its largest
    entry, 1))."""
    jcfg = _jcfg("mamba2-1.3b")
    toks = jnp.asarray(run.spec["train_tokens"], jnp.int32)
    jp = jax.tree.map(jnp.asarray, run.spec["mamba2-1.3b"])
    (want, _), grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {"tokens": toks, "labels": toks}, jcfg),
        has_aux=True)(jp)
    for o in run.ranks.results():
        tr = o["train"]
        assert abs(tr["loss"] - float(want)) < 1e-5
        for k in GRAD_LEAVES:
            assert _leaf_err(tr["grads"][k],
                             grads["blocks"]["ssm"][k]) < 1e-4, k


def test_block_gradient_matches_the_reference(run):
    """One block under TRAIN_RULES on (2, 2), its input split over the
    batch and the sequence: the output placed as the input, the output
    and the VJP for the input and every weight within 1e-5 / 1e-4 of
    `jax.vjp` of the reference's `ssm_block`, with no redistribution of
    DTensor's own in forward or backward."""
    from repro.models import ssm as jssm

    jcfg = _jcfg("mamba2-1.3b")
    x, cot = (jnp.asarray(t) for t in run.spec["block"])
    jp = {k: jnp.asarray(v[0])
          for k, v in run.spec["mamba2-1.3b"]["blocks"]["ssm"].items()}
    want, vjp = jax.vjp(lambda x, p: jssm.ssm_block(x, p, jcfg)[0], x, jp)
    dx, dp = vjp(cot)
    for o in run.ranks.results():
        rec = o["block_grad"]
        assert rec["redistributions"] == 0
        assert rec["out_placements"] == ("S(0)", "S(1)")
        np.testing.assert_allclose(rec["out"], want, atol=1e-5, rtol=0)
        assert _leaf_err(rec["grads"]["x"], dx) < 1e-4
        assert rec["grads"].keys() == {"x", *dp}
        for k, w in dp.items():
            assert _leaf_err(rec["grads"][k], w) < 1e-4, k


def test_dry_run_of_the_tensor_parallel_block(run):
    """mamba2-1.3b's 32k prefill on the (16, 16) mesh at 2 and 4 layers:
    both records ok, and a layer's all-gathers (the difference of the
    two, over 2) carry less than the data-parallel block gathered a
    layer on every rank (its in_proj and out_proj whole, bf16)."""
    gathered = {}
    for n, proc in run.dry.items():
        out, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, out[-3000:]
        rec = json.loads((run.tmp / f"dryrun{n}" / "pod16x16" /
                          "mamba2-1.3b__prefill_32k.json").read_text())
        assert rec["ok"], rec.get("traceback")
        assert rec["fits"] and rec["memory"]["peak_bytes"] > 0
        gathered[n] = rec["hlo"]["collective_payload_bytes"]["all-gather"]
    cfg = base.get_config("mamba2-1.3b")
    d_in, n = cfg.d_inner, cfg.ssm_state
    weights = 2 * (cfg.d_model * (2 * d_in + 2 * n + cfg.ssm_heads)
                   + d_in * cfg.d_model)
    lo, hi = DRY_LAYERS
    per_layer = (gathered[hi] - gathered[lo]) / (hi - lo)
    assert 0 < per_layer < weights
