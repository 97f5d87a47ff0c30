"""The tuner slice as a whole: the port's Adam update, tuning loop,
hard re-evaluation, `optimize`, checkpoints and bootstrap against the JAX
reference on the same grid (the reference's ``tune_policies --smoke``
grid, carried across with `grid_from_numpy`), plus the port's own plan,
resume and surface checks. Everything runs on the CPU, where the soft
scan runs its plain blocked versions.

Tolerances: the Adam update within rtol 1e-6 (the same float32 formula;
`pow` may differ by an ulp); the soft objective within rtol 1e-5 and its
gradients within rtol 1e-4 / atol 1e-5 max|g|; `tune_loop` after 10
steps: raw params within rtol 1e-4 (ten Adam steps amplify ulp-level
gradient differences), history loss within rtol 1e-5; hard CPC of one
set of params within rtol 1e-5 with start counts equal; `optimize`: mean
CPC within rtol 1e-3 and the same source wherever the candidates differ
by more than 1e-3 relative (Adam drift may move a threshold across a
price). The chunked plan and the resumed checkpointed run are held to
bit equality, as are checkpoints across the packages and the bootstrap.
"""

import dataclasses
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.energy.ensemble import block_bootstrap as jax_block_bootstrap  # noqa: E402
from repro.kernels.ref import fleet_scan_ref as jax_fleet_scan_ref  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.optim.adamw import adamw_update as jax_adamw_update  # noqa: E402
from repro.tune import TuneConfig as JaxTuneConfig  # noqa: E402
from repro.tune import hard_cpc as jax_hard_cpc  # noqa: E402
from repro.tune import init_from_grid as jax_init_from_grid  # noqa: E402
from repro.tune import optimize as jax_optimize  # noqa: E402
from repro.tune import problem_from_grid as jax_problem_from_grid  # noqa: E402
from repro.tune import soft_objective as jax_soft_objective  # noqa: E402
from repro.tune import transform as jax_transform  # noqa: E402
from repro.tune import tune_loop as jax_tune_loop  # noqa: E402
from repro.tune import tune_loop_checkpointed as jax_tune_loop_ckpt  # noqa: E402
from repro.tune.objective import PolicyParams as JaxPolicyParams  # noqa: E402
from repro.tune.optimizer import _ckpt_template as jax_ckpt_template  # noqa: E402
from repro.tune.optimizer import _init_carry as jax_init_carry  # noqa: E402
from repro.tune.optimizer import _tau_schedule as jax_tau_schedule  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.energy import block_bootstrap  # noqa: E402
from repro_torch.examples import tune_policies  # noqa: E402
from repro_torch.execution import Coupling, ExecutionPlan  # noqa: E402
from repro_torch.fleet import grid_from_numpy  # noqa: E402
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.kernels.ref import fleet_scan_ref  # noqa: E402
from repro_torch.optim import (AdamWConfig, AdamWState,  # noqa: E402
                               adamw_update)
from repro_torch.tune import (PhysicalPolicy, PolicyParams,  # noqa: E402
                              TuneConfig, hard_cpc, init_from_grid, optimize,
                              problem_from_grid, soft_dispatch_ratio,
                              soft_objective, transform, tune_loop,
                              tune_loop_checkpointed)
from repro_torch.tune.optimizer import (_ckpt_template,  # noqa: E402
                                        _init_carry, _tau_schedule)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "_reference_tune_policies", ROOT / "examples" / "tune_policies.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Smoke:
    smoke = True


@pytest.fixture(scope="module")
def jax_grid():
    """The reference's ``tune_policies --smoke`` grid: 2 German market
    draws x 1 system x 3 policies = 6 rows x 400 h."""
    return _reference_example().build(_Smoke)


@pytest.fixture(scope="module")
def grid(jax_grid):
    return grid_from_numpy(
        {f: np.asarray(getattr(jax_grid, f)) for f in TENSOR_FIELDS},
        market_names=jax_grid.market_names,
        system_names=jax_grid.system_names,
        policy_names=jax_grid.policy_names, device=CPU)


@pytest.fixture(scope="module")
def jax_result(jax_grid):
    return jax_optimize(jax_grid, JaxTuneConfig(steps=40))


@pytest.fixture(scope="module")
def result(grid):
    return optimize(grid, TuneConfig(steps=40), device=CPU)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# the problem, the seeds, the schedule
# ---------------------------------------------------------------------------

def test_problem_seeds_and_transform_match_reference(grid, jax_grid):
    prob, jprob = problem_from_grid(grid), jax_problem_from_grid(jax_grid)
    for name in prob._fields:
        np.testing.assert_allclose(_np(getattr(prob, name)),
                                   np.asarray(getattr(jprob, name)),
                                   rtol=1e-6, err_msg=name)
    raw, jraw = init_from_grid(grid), jax_init_from_grid(jax_grid)
    for a, b in zip(raw, jraw):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for a, b in zip(transform(raw), jax_transform(jraw)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


def test_tau_schedule_matches_reference():
    for steps in (1, 7, 200):
        cfg = TuneConfig(steps=steps)
        np.testing.assert_allclose(
            _np(_tau_schedule(cfg, CPU)),
            np.asarray(jax_tau_schedule(JaxTuneConfig(steps=steps))),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip_norm", [0.0, 0.5])
def test_adamw_update_per_row_matches_reference_under_vmap(clip_norm):
    rng = np.random.default_rng(3)
    b = 7

    def tree(scale=1.0, positive=False):
        arrs = [rng.normal(0, scale, b).astype(np.float32)
                for _ in range(3)]
        return [np.abs(a) if positive else a for a in arrs]

    params, grads, mu, nu = (tree(50.0), tree(2.0), tree(0.3),
                             tree(0.2, positive=True))
    kw = dict(lr=0.5, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
              clip_norm=clip_norm)
    state = AdamWState(step=torch.tensor(4, dtype=torch.int32),
                       mu=PolicyParams(*map(torch.tensor, mu)),
                       nu=PolicyParams(*map(torch.tensor, nu)))
    new_p, new_st, _ = adamw_update(PolicyParams(*map(torch.tensor, grads)),
                                    state,
                                    PolicyParams(*map(torch.tensor, params)),
                                    AdamWConfig(**kw), per_row=True)

    jopt = JaxAdamWConfig(**kw)

    def row_update(g, st, p):
        p2, st2, _ = jax_adamw_update(g, st, p, jopt)
        return p2, st2

    axes = JaxAdamWState(step=None, mu=0, nu=0)
    jp, jst = jax.vmap(row_update, in_axes=(0, axes, 0),
                       out_axes=(0, axes))(
        JaxPolicyParams(*map(jnp.asarray, grads)),
        JaxAdamWState(step=jnp.asarray(4, jnp.int32),
                      mu=JaxPolicyParams(*map(jnp.asarray, mu)),
                      nu=JaxPolicyParams(*map(jnp.asarray, nu))),
        JaxPolicyParams(*map(jnp.asarray, params)))
    assert int(new_st.step) == int(jst.step) == 5
    for got, want in ((new_p, jp), (new_st.mu, jst.mu),
                      (new_st.nu, jst.nu)):
        for a, b_ in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(b_), rtol=1e-6)
    # without stats (the tuner's call) the update is the same, bit for bit
    quiet_p, _, quiet = adamw_update(
        PolicyParams(*map(torch.tensor, grads)), state,
        PolicyParams(*map(torch.tensor, params)), AdamWConfig(**kw),
        per_row=True, stats=False)
    assert "grad_norm" not in quiet
    for a, b_ in zip(quiet_p, new_p):
        assert torch.equal(a, b_)


def test_adamw_update_whole_tree_matches_reference():
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [rng.normal(0, 3, s).astype(np.float32) for s in shapes]
    opt = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    zeros = [np.zeros(s, np.float32) for s in shapes]
    new_p, _, stats = adamw_update(
        list(map(torch.tensor, grads)),
        AdamWState(torch.tensor(0, dtype=torch.int32),
                   list(map(torch.tensor, zeros)),
                   list(map(torch.tensor, zeros))),
        list(map(torch.tensor, params)), AdamWConfig(**opt))
    jp, _, jstats = jax_adamw_update(
        list(map(jnp.asarray, grads)),
        JaxAdamWState(jnp.asarray(0, jnp.int32), list(map(jnp.asarray, zeros)),
                      list(map(jnp.asarray, zeros))),
        list(map(jnp.asarray, params)), JaxAdamWConfig(**opt))
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    for a, b_ in zip(new_p, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b_), rtol=1e-6)


# ---------------------------------------------------------------------------
# the objective and the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coupling", [
    {}, {"power_cap_mw": 2.5}, {"min_up_hours": 2400.0}],
    ids=["plain", "power_cap", "min_up"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_soft_objective_and_gradients_match_reference(grid, jax_grid,
                                                      coupling, reduction):
    raw, jraw = init_from_grid(grid), jax_init_from_grid(jax_grid)
    prob, jprob = problem_from_grid(grid), jax_problem_from_grid(jax_grid)
    tau = 4.0
    jval, jgrad = jax.value_and_grad(
        lambda r: jax_soft_objective(r, jprob, tau, reduction=reduction,
                                     **coupling)[0])(jraw)
    leaves = [x.clone().requires_grad_(True) for x in raw]
    loss, aux = soft_objective(PolicyParams(*leaves), prob, tau,
                               reduction=reduction, **coupling)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    for leaf, want in zip(leaves, jgrad):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(leaf.grad), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_tune_loop_matches_reference_after_10_steps(grid, jax_grid):
    cfg = TuneConfig(steps=10)
    raw_f, hist, cpc = tune_loop(init_from_grid(grid),
                                 problem_from_grid(grid), cfg=cfg)
    jraw_f, jhist, jcpc = jax_tune_loop(jax_init_from_grid(jax_grid),
                                        jax_problem_from_grid(jax_grid),
                                        cfg=JaxTuneConfig(steps=10))
    for a, b_ in zip(raw_f, jraw_f):
        np.testing.assert_allclose(_np(a), np.asarray(b_), rtol=1e-4)
    np.testing.assert_allclose(_np(hist["loss"]), np.asarray(jhist["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(hist["tau"]), np.asarray(jhist["tau"]),
                               rtol=1e-6)
    assert float(_np(hist["guard_rejects"]).sum()) == 0.0
    assert _np(hist["stage_cpc"]).shape == (4,)
    np.testing.assert_allclose(_np(cpc), np.asarray(jcpc), rtol=1e-5)


def test_hard_cpc_of_tuned_params_matches_reference(grid, jax_grid, result):
    """Both packages re-evaluate the port's own tuned params."""
    ph = transform(result.raw)
    prob, jprob = problem_from_grid(grid), jax_problem_from_grid(jax_grid)
    got = hard_cpc(ph.p_on, ph.p_off, ph.off_level, prob)
    want = jax_hard_cpc(*(jnp.asarray(_np(x)) for x in ph), jprob)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    rows = _np(prob.row_prices())
    scan = fleet_scan_ref(prob.row_prices(), ph.p_on, ph.p_off,
                          ph.off_level, prob.idle_frac)
    jscan = jax_fleet_scan_ref(rows, *(_np(x) for x in ph),
                               _np(prob.idle_frac))
    np.testing.assert_array_equal(_np(scan.n_starts),
                                  np.asarray(jscan.n_starts))


def test_optimize_matches_reference_and_keeps_the_guarantee(result,
                                                            jax_result):
    assert np.all(result.cpc <= result.cpc_swept_best * (1 + 1e-6))
    np.testing.assert_allclose(result.cpc.mean(), jax_result.cpc.mean(),
                               rtol=1e-3)
    np.testing.assert_allclose(result.cpc_swept, jax_result.cpc_swept,
                               rtol=1e-5)
    np.testing.assert_allclose(result.cpc_swept_best,
                               jax_result.cpc_swept_best, rtol=1e-5)
    cand = np.stack([jax_result.cpc_tuned, jax_result.cpc_swept,
                     jax_result.cpc_swept_best])
    srt = np.sort(cand, axis=0)
    decisive = (srt[1] - srt[0]) > 1e-3 * srt[0]
    np.testing.assert_array_equal(result.source[decisive],
                                  jax_result.source[decisive])
    assert result.guard_count == 0
    assert result.stage_cpc.shape == (4,)
    np.testing.assert_allclose(result.stage_cpc[-1],
                               result.cpc_tuned.mean(), rtol=1e-6)
    assert set(result.history) == set(jax_result.history)
    for k in result.history:
        assert result.history[k].shape == (40,)


# ---------------------------------------------------------------------------
# plans, checkpoints, warm starts
# ---------------------------------------------------------------------------

def test_chunked_plan_is_bitwise_equal_to_single(grid):
    cfg = TuneConfig(steps=12, plan=ExecutionPlan(mode="single"))
    one = optimize(grid, cfg, device=CPU)
    chunked = optimize(grid, cfg._replace(plan=ExecutionPlan(
        mode="chunked", chunk_rows=4, contract="bitwise")), device=CPU)
    for a, b_ in zip(one.raw, chunked.raw):
        assert torch.equal(a, b_)
    for name in ("cpc", "cpc_tuned", "cpc_swept", "cpc_swept_best",
                 "source"):
        np.testing.assert_array_equal(getattr(one, name),
                                      getattr(chunked, name), err_msg=name)


def test_checkpointed_run_resumed_is_bitwise_uninterrupted(grid, tmp_path):
    cfg = TuneConfig(steps=16)
    prob, raw0 = problem_from_grid(grid), init_from_grid(grid)
    raw_a, hist_a, cpc_a = tune_loop_checkpointed(
        raw0, prob, cfg=cfg, directory=tmp_path / "a", keep=8)
    tune_loop_checkpointed(raw0, prob, cfg=cfg, directory=tmp_path / "b",
                           keep=8)
    for step_dir in sorted((tmp_path / "b").glob("step_*"))[2:]:
        shutil.rmtree(step_dir)          # "killed" after stage 2
    raw_b, hist_b, cpc_b = tune_loop_checkpointed(
        raw0, prob, cfg=cfg, directory=tmp_path / "b", keep=8)
    for a, b_ in zip(raw_a, raw_b):
        assert torch.equal(a, b_)
    assert torch.equal(cpc_a, cpc_b)
    for k in hist_a:
        np.testing.assert_array_equal(hist_a[k], hist_b[k], err_msg=k)
    # the staged checkpointed run is the loop itself, bit for bit
    raw_c, hist_c, cpc_c = tune_loop(raw0, prob, cfg=cfg)
    for a, b_ in zip(raw_a, raw_c):
        assert torch.equal(a, b_)
    np.testing.assert_array_equal(hist_a["loss"], _np(hist_c["loss"]))


def test_port_checkpoint_loads_in_the_reference(grid, jax_grid, tmp_path):
    cfg = TuneConfig(steps=8, eval_stages=2)
    prob, raw0 = problem_from_grid(grid), init_from_grid(grid)
    tune_loop_checkpointed(raw0, prob, cfg=cfg, directory=tmp_path,
                           keep=8)
    saved, meta = load_checkpoint(tmp_path, _ckpt_template(
        _init_carry(raw0), 8, 2))
    jcarry = jax_init_carry(jax_init_from_grid(jax_grid))
    tree, jmeta = jax_load_checkpoint(tmp_path, jax_ckpt_template(
        jcarry, JaxTuneConfig(steps=8, eval_stages=2), 8, 2, grid.n_rows,
        False))
    assert jmeta["step"] == meta["step"] == 2
    got = jax.tree_util.tree_leaves(tree)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        _np, saved, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(got) == len(want) == 18
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b_)


def test_reference_checkpoint_loads_in_the_port(grid, jax_grid, tmp_path):
    jcfg = JaxTuneConfig(steps=8, eval_stages=2)
    jraw = jax_init_from_grid(jax_grid)
    jax_tune_loop_ckpt(jraw, jax_problem_from_grid(jax_grid), cfg=jcfg,
                       directory=tmp_path, keep=8)
    jtree, _ = jax_load_checkpoint(tmp_path, jax_ckpt_template(
        jax_init_carry(jraw), jcfg, 8, 2, grid.n_rows, False))
    tree, meta = load_checkpoint(tmp_path, _ckpt_template(
        _init_carry(init_from_grid(grid)), 8, 2))
    assert meta["step"] == 2 and meta["stage"] == 2
    (raw, st, lr), (jraw_f, jst, jlr) = tree["carry"], jtree["carry"]
    for a, b_ in zip((*raw, *st.mu, *st.nu, st.step, lr, tree["cpc_rows"]),
                     (*jraw_f, *jst.mu, *jst.nu, jst.step, jlr,
                      jtree["cpc_rows"])):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(_np(a), np.asarray(b_))
    assert st.step.dtype == torch.int32
    for k in tree["hist"]:
        np.testing.assert_array_equal(tree["hist"][k],
                                      np.asarray(jtree["hist"][k]))


def test_checkpoint_bfloat16_and_async_save_cross_load(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)
            .to(torch.bfloat16) / 7, "n": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(tmp_path, 5, tree, {"note": "x"}, blocking=False).wait()
    jtree, meta = jax_load_checkpoint(tmp_path, {
        "w": jnp.zeros((2, 3), jnp.bfloat16), "n": jnp.zeros((), jnp.int32)})
    assert meta == {"note": "x", "step": 5}
    np.testing.assert_array_equal(np.asarray(jtree["w"], np.float32),
                                  tree["w"].float().numpy())
    jax_save_checkpoint(tmp_path / "j", 1, jtree)
    back, _ = load_checkpoint(tmp_path / "j", tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert int(back["n"]) == 3


def test_warm_starts(grid, result):
    cfg = TuneConfig(steps=4)
    again = optimize(grid, cfg, warm_start=result, device=CPU)
    assert np.all(again.cpc <= again.cpc_swept_best * (1 + 1e-6))
    phys = PhysicalPolicy(*(_np(x) for x in result.params))
    from_phys = optimize(grid, cfg, warm_start=phys, device=CPU)
    assert np.all(np.isfinite(from_phys.cpc))
    raw_before = [x.clone() for x in result.raw]
    optimize(grid, cfg, warm_start=result.raw, device=CPU)
    for a, b_ in zip(raw_before, result.raw):
        assert torch.equal(a, b_)          # the caller's tensors untouched
    with pytest.raises(ValueError, match="warm_start"):
        optimize(grid, cfg, device=CPU, warm_start=PolicyParams(
            *(x[:3] for x in result.raw)))
    with pytest.raises(TypeError, match="warm_start"):
        optimize(grid, cfg, device=CPU, warm_start=object())


def test_coupling_penalties_keep_the_tuned_params(grid):
    res = optimize(grid, TuneConfig(steps=6, coupling=Coupling(
        power_cap_mw=2.5)), device=CPU)
    assert np.all(res.source == 0)
    np.testing.assert_array_equal(res.cpc, res.cpc_tuned)
    assert res.history["penalty"].shape == (6,)


def test_guard_holds_a_poisoned_row(grid):
    """A NaN in one market's prices poisons every loss and gradient that
    touches it: the guard rejects those row-steps (and counts them) and
    every row seeded finite ends finite."""
    prices = grid.prices.clone()
    prices[0, 5] = float("nan")
    bad = dataclasses.replace(grid, prices=prices)
    res = optimize(bad, TuneConfig(steps=10), device=CPU)
    assert res.guard_count > 0
    for seed, x in zip(init_from_grid(bad), res.raw):
        assert torch.equal(torch.isfinite(x), torch.isfinite(seed))


# ---------------------------------------------------------------------------
# the rest of the surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(circular=True), dict(circular=False),
    dict(series_hours=500, block_hours=24), dict(block_hours=1000)])
def test_block_bootstrap_is_bit_equal_to_reference(kw):
    trace = np.random.default_rng(8).lognormal(4.2, 0.6, 731)
    got = block_bootstrap(trace, 5, seed=17, **kw)
    want = jax_block_bootstrap(trace, 5, seed=17, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_later_slice_options_raise(grid):
    prob, raw = problem_from_grid(grid), init_from_grid(grid)
    with pytest.raises(NotImplementedError, match="the mesh slice"):
        optimize(grid, TuneConfig(steps=2, plan=ExecutionPlan(
            mode="sharded")), device=CPU)
    # the soft dispatch coupling (Coupling(dispatch=)) and the hard
    # re-scoring are ported (tests/test_torch_tune_dispatch.py,
    # tests/test_torch_dispatch.py); its sharded form is not
    with pytest.raises(NotImplementedError, match="the mesh slice"):
        soft_objective(raw, prob, 1.0, axis_name="rows")
    with pytest.raises(NotImplementedError, match="the mesh slice"):
        soft_dispatch_ratio(None, None, None, 1.0, axis_name="rows")
    # the legality rule of the pair stays a ValueError
    with pytest.raises(ValueError, match="chunk_rows"):
        TuneConfig(plan=ExecutionPlan(mode="chunked", chunk_rows=4),
                   coupling=Coupling(power_cap_mw=1.0))


def test_optimize_defaults_to_cuda(grid):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize(grid, TuneConfig(steps=2))


def test_example_smoke_exits_zero_on_the_cpu(capsys):
    assert tune_policies.main(["--smoke", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "6 rows x 400 h; tuning 40 steps" in text
    assert "held-out (3 block-bootstrap resamples/market)" in text
    assert "ERROR" not in text
