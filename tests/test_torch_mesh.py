"""The row mesh (`repro_torch.parallel`) and the sharded coupled tuner on
`torch.distributed`, against the JAX reference and the port's single
program. Ranks are spawned once for the module (two on gloo over a
``file://`` rendezvous, and three for the mesh over two of them); they
run `tests/_mesh_ranks.py` on the CPU in the background while the test
process computes the reference's values, and their results are read
from disk. One test runs the reference's own sharded objective in a
subprocess on two virtual XLA devices.

Tolerances (the reference's gates, `tests/test_execution.py:327-470`),
against the port's single program and the reference's alike:
- the sharded loss within 4 float32 ULP of the single program's
  ``reduction="sum"`` loss (and of the reference's sharded run), its
  gradients within rtol 1e-4 / atol 1e-6;
- float64 central differences within 1e-4 of max(1, |fd|);
- `optimize` after 6 steps: raw parameters within rtol 5e-5 / atol 5e-5;
- ``mode="sharded"`` without a process group, telemetry on against off,
  and the ranks' results against each other: bit for bit.
"""

import json
import os
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

import _mesh_ranks  # noqa: E402
from repro.core.tco import make_system as jax_make_system  # noqa: E402
from repro.dispatch import DispatchConfig as JaxDispatchConfig  # noqa: E402
from repro.energy.markets import MarketParams as JaxMarketParams  # noqa: E402
from repro.execution import Coupling as JaxCoupling  # noqa: E402
from repro.execution import ExecutionPlan as JaxExecutionPlan  # noqa: E402
from repro.fleet import PolicySpec as JaxPolicySpec  # noqa: E402
from repro.fleet import build_grid as jax_build_grid  # noqa: E402
from repro.optim.compress import quantize_int8 as jax_quantize_int8  # noqa: E402
from repro.parallel import axes as jax_axes  # noqa: E402
from repro.tune import TuneConfig as JaxTuneConfig  # noqa: E402
from repro.tune import dispatch_coupling_from_grid as jax_coupling  # noqa: E402
from repro.tune import init_from_grid as jax_init_from_grid  # noqa: E402
from repro.tune import optimize as jax_optimize  # noqa: E402
from repro.tune import problem_from_grid as jax_problem_from_grid  # noqa: E402
from repro.tune import soft_objective as jax_soft_objective  # noqa: E402
from repro_torch import parallel  # noqa: E402
from repro_torch.dispatch import DispatchConfig  # noqa: E402
from repro_torch.execution import Coupling, ExecutionPlan  # noqa: E402
from repro_torch.fleet import grid_from_numpy  # noqa: E402
from repro_torch.fleet.grid import TENSOR_FIELDS  # noqa: E402
from repro_torch.parallel import axes  # noqa: E402
from repro_torch.tune import (PolicyParams, TuneConfig,  # noqa: E402
                              dispatch_coupling_from_grid, init_from_grid,
                              optimize, problem_from_grid,
                              sharded_soft_objective, soft_objective)

CPU = "cpu"
T = 96
STEPS = 6
JOIN_TIMEOUT = 120.0
DCFG = _mesh_ranks.DCFG
TAU = _mesh_ranks.TAU
SRC = Path(__file__).resolve().parents[1] / "src"

# the reference's logical_to_spec cases (tests/test_parallel.py:20-35)
# and more rule sets
SPEC_CASES = [(("batch", "seq", None), "TRAIN_RULES"),
              (("seq", "heads", None), "TRAIN_RULES"),
              (("batch", "seq", "heads"), "SINGLE_DEVICE_RULES"),
              (("batch", "seq", "kv_heads", "head_dim"), "DECODE_RULES"),
              (("batch", "seq", "embed_p", "ffn"), "SSM_PREFILL_RULES"),
              (("cache_seq", "vocab", "embed_p"), "TRAIN_RULES")]
# shapes x logical axes for sanitized_spec on a 2-rank "data" mesh: the
# last dimension of each case does not divide by 2
SANITIZE_CASES = [((4, 6), ("batch", "embed_p")),
                  ((3, 4), ("batch", "embed_p")),
                  ((8, 5), ("embed_p", "batch"))]


def _jax_grid(n_markets, n_policies, t=T, off_level=0.3):
    """The reference's `tests/test_execution.py::_grid`."""
    markets = [JaxMarketParams(n_hours=t, seed=s) for s in range(n_markets)]
    sys_ = jax_make_system(0.6 * t * 80.0, 1.0, float(t))
    pols = [JaxPolicySpec("ao")] + [
        JaxPolicySpec(f"x{i}", x=0.03 * (i + 1), off_level=off_level)
        for i in range(n_policies - 1)]
    return jax_build_grid(markets, [sys_], pols)


def _fields(jgrid):
    return ({f: np.asarray(getattr(jgrid, f)) for f in TENSOR_FIELDS},
            (jgrid.market_names, jgrid.system_names, jgrid.policy_names))


def _port(jgrid):
    fields, names = _fields(jgrid)
    return grid_from_numpy(fields, market_names=names[0],
                           system_names=names[1], policy_names=names[2],
                           device=CPU)


# 9 rows (3 cells of 3): on 2 ranks they pad to 10, and cell 1 sits on
# both; 12 rows (3 cells of 4) split evenly, cell 1 on both ranks
JAX_GRIDS = {"odd": _jax_grid(3, 3), "even": _jax_grid(3, 4)}
# the acceptance test's cap (0.6 of the summed site ratings) and an
# up-time floor above what the shutdown policies deliver, so both
# penalties bind
_POWER = float(np.asarray(JAX_GRIDS["odd"].power)[0])
PENALTIES = dict(power_cap_mw=0.6 * 3 * _POWER,
                 min_up_hours=0.99 * 3 * T)


class _Ranks:
    """``world`` spawned ranks running ``jobs`` in the background;
    `results` joins them (``JOIN_TIMEOUT`` s) and loads what each saved."""

    def __init__(self, world, jobs, tmp):
        self.world, self.tmp = world, Path(tmp)
        spec = {"jobs": jobs, "grids": {k: _fields(g) for k, g in
                                        JAX_GRIDS.items()},
                "penalties": PENALTIES, "steps": STEPS,
                "spec_cases": SANITIZE_CASES, "out_dir": str(self.tmp)}
        torch.save(spec, self.tmp / "spec.pt")
        self._out = None
        self.ctx = torch.multiprocessing.start_processes(
            _mesh_ranks.main,
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
                    pytest.fail(f"{self.world} ranks still running after "
                                f"{JOIN_TIMEOUT:.0f} s")
            self._out = [torch.load(self.tmp / f"rank{r}.pt",
                                    weights_only=False)
                         for r in range(self.world)]
        return self._out


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    two = _Ranks(2, ["collectives", "objective", "sharded_loss", "optimize"],
                 tmp_path_factory.mktemp("mesh2"))
    three = _Ranks(3, ["subset"], tmp_path_factory.mktemp("mesh3"))
    yield types.SimpleNamespace(two=two, three=three)
    for r in (two, three):
        for p in r.ctx.processes:
            if p.is_alive():
                p.kill()


JAX_SHARDED = """
import json, sys
import jax, jax.numpy as jnp
import numpy as np
sys.path.insert(0, {src!r})
from repro.core.tco import make_system
from repro.dispatch import DispatchConfig
from repro.energy.markets import MarketParams
from repro.fleet import PolicySpec, build_grid
from repro.tune import (dispatch_coupling_from_grid, init_from_grid,
                        problem_from_grid, sharded_soft_objective)
t = {t}
grid = build_grid([MarketParams(n_hours=t, seed=s) for s in range(3)],
                  [make_system(0.6 * t * 80.0, 1.0, float(t))],
                  [PolicySpec("ao")] + [PolicySpec(f"x{{i}}", x=0.03 * (i + 1),
                                                   off_level=0.3)
                                        for i in range(3)])
problem = problem_from_grid(grid)
coupling = dispatch_coupling_from_grid(grid, DispatchConfig(**{dcfg!r}))
kw = dict(dispatch_min_dwell={dwell}, dispatch_fused=True, **{pen!r})
loss = lambda r: sharded_soft_objective(r, problem, {tau}, n_dev=2,
                                        coupling=coupling, **kw)
raw = init_from_grid(grid)
value, grad = jax.value_and_grad(loss)(raw)
print(json.dumps({{"devices": len(jax.devices()), "loss": float(value),
                  "grads": [np.asarray(g).tolist() for g in grad]}}))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_sharded():
    """The reference's `sharded_soft_objective` on the ``"even"`` grid over
    two virtual XLA CPU devices, in a subprocess started with the
    module."""
    prog = JAX_SHARDED.format(src=str(SRC), t=T, dcfg=DCFG,
                              dwell=DCFG["min_dwell_h"], pen=PENALTIES,
                              tau=TAU)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    box = {}

    def result():
        if "out" not in box:
            out, err = proc.communicate(timeout=JOIN_TIMEOUT)
            assert proc.returncode == 0, err[-3000:]
            box["out"] = json.loads(out.strip().splitlines()[-1])
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _ulp_close(got, want, n=4):
    assert abs(got - want) <= n * np.spacing(np.float32(abs(want))), \
        (got, want, (got - want) / np.spacing(np.float32(abs(want))))


def _single(name, *, dispatch=True, penalties=True):
    """The port's and the reference's single-program ``reduction="sum"``
    loss and gradient on grid ``name``."""
    jgrid = JAX_GRIDS[name]
    grid = _port(jgrid)
    kw = dict(dispatch_min_dwell=DCFG["min_dwell_h"], dispatch_fused=True,
              reduction="sum", **(PENALTIES if penalties else {}))
    leaves = [x.clone().requires_grad_(True) for x in init_from_grid(grid)]
    loss, _ = soft_objective(
        PolicyParams(*leaves), problem_from_grid(grid), TAU,
        dispatch=dispatch_coupling_from_grid(grid, DispatchConfig(**DCFG))
        if dispatch else None, **kw)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    jc = jax_coupling(jgrid, JaxDispatchConfig(**DCFG)) if dispatch else None
    jval, jgrad = jax.value_and_grad(lambda r: jax_soft_objective(
        r, jax_problem_from_grid(jgrid), TAU, dispatch=jc, **kw)[0])(
        jax_init_from_grid(jgrid))
    return (float(loss), [_np(g) for g in grads], float(jval),
            [np.asarray(g) for g in jgrad])


def _grads_close(got, want, rtol=1e-4, atol=1e-6):
    for name, g, w in zip(PolicyParams._fields, got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# parallel.axes in process: rules, specs, the surface without a mesh
# ---------------------------------------------------------------------------

def test_rule_sets_and_exports_equal_the_reference():
    for name in ("TRAIN_RULES", "SSM_PREFILL_RULES", "DECODE_RULES",
                 "SINGLE_DEVICE_RULES"):
        assert dict(getattr(axes, name)) == dict(getattr(jax_axes, name))
    from repro import parallel as jax_parallel
    assert parallel.__all__ == jax_parallel.__all__


@pytest.mark.parametrize("logical,rules", SPEC_CASES)
@pytest.mark.parametrize("mesh", [None, {"data": 2, "model": 4},
                                  {"pod": 2, "data": 2, "model": 2}],
                         ids=["none", "data-model", "pod-data-model"])
def test_logical_and_sanitized_specs_equal_the_reference(logical, rules,
                                                         mesh):
    """Against the reference with a stand-in of each package's mesh (the
    reference reads ``mesh.shape``, the port a `DeviceMesh`'s
    ``mesh_dim_names`` and ``shape``)."""
    jmesh = None if mesh is None else types.SimpleNamespace(shape=mesh)
    pmesh = None if mesh is None else types.SimpleNamespace(
        mesh_dim_names=tuple(mesh), shape=tuple(mesh.values()))
    r, jr = getattr(axes, rules), getattr(jax_axes, rules)
    got = axes.logical_to_spec(logical, r, mesh=pmesh)
    assert isinstance(got, axes.PartitionSpec)
    assert tuple(got) == tuple(jax_axes.logical_to_spec(logical, jr,
                                                        mesh=jmesh))
    for shape in ((8, 8, 8, 8), (6, 3, 4, 5), (2, 2, 2, 2)):
        shape = shape[:len(logical)]
        assert tuple(axes.sanitized_spec(shape, logical, r, mesh=pmesh)) \
            == tuple(jax_axes.sanitized_spec(shape, logical, jr,
                                             mesh=jmesh)), shape


def test_surface_without_a_mesh():
    x = torch.ones(3)
    assert axes.constrain(x, "batch") is x
    assert axes.current_mesh() is None and axes.axis_size("rows") == 1
    with pytest.raises(ValueError, match="no active mesh"):
        axes.named_sharding("batch")
    for fn in (axes.psum, axes.psum_id, axes.pmax, axes.all_gather):
        with pytest.raises(NameError, match="unbound axis name: rows"):
            fn(x, "rows")
    with pytest.raises(ValueError, match=r"row_mesh\(2\) but only 1"):
        axes.row_mesh(2)
    with axes.use_sharding(None, axes.DECODE_RULES):
        assert axes.current_rules() is axes.DECODE_RULES
    assert axes.current_rules() is axes.SINGLE_DEVICE_RULES


def test_sharded_without_a_process_group_is_the_single_program():
    grid = _port(JAX_GRIDS["odd"])
    coup = Coupling(dispatch=DispatchConfig(**DCFG))
    a, b = (optimize(grid, TuneConfig(steps=2, plan=ExecutionPlan(mode=m),
                                      coupling=coup), device=CPU)
            for m in ("sharded", "single"))
    for x, y in zip(a.raw, b.raw):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.cpc, b.cpc)
    for k in b.history:
        np.testing.assert_array_equal(a.history[k], b.history[k])


def test_sharded_soft_objective_refuses_uneven_rows():
    grid = _port(JAX_GRIDS["odd"])
    with pytest.raises(ValueError, match="do not split evenly"):
        sharded_soft_objective(init_from_grid(grid), problem_from_grid(grid),
                               TAU, n_dev=2)


# ---------------------------------------------------------------------------
# on two ranks: the collectives, the mesh surface, compressed_pmean
# ---------------------------------------------------------------------------

def test_collectives_values_and_backward(ranks):
    r0, r1 = (out["collectives"] for out in ranks.two.results())
    w = [np.array([1.0, 10.0]), np.array([2.0, 20.0])]
    for r, out in enumerate((r0, r1)):
        assert out["unbound"] == "unbound axis name: rows"
        y, g = out["psum_id"]
        np.testing.assert_array_equal(y, [3.0, 6.0])
        np.testing.assert_array_equal(g, w[r])            # the identity
        y, g = out["psum"]
        np.testing.assert_array_equal(y, [3.0, 6.0])
        np.testing.assert_array_equal(g, w[0] + w[1])     # summed
        y, needs_grad = out["pmax"]
        np.testing.assert_array_equal(y, [3.0, 1.0])
        assert needs_grad is False                        # none
        np.testing.assert_array_equal(out["gather"],
                                      [[0, 1, 2], [10, 11, 12]])
        assert out["gather"].dtype == np.int8
        assert out["axis_size"] == (2, 1)
        # the row mesh binds no axis of the batch rules: replicated
        assert out["constrain"] == ("DTensor", ["Replicate"])
        assert out["named_sharding"] == (None,)
        assert out["constrain_none"] == [1.0, 1.0]
        assert out["too_many"].startswith("row_mesh(3) but only 2")


def test_sanitized_spec_on_a_live_mesh_equals_the_reference(ranks):
    jmesh = types.SimpleNamespace(shape={"data": 2})
    want = [tuple(jax_axes.sanitized_spec(shape, logical,
                                          jax_axes.TRAIN_RULES, mesh=jmesh))
            for shape, logical in SANITIZE_CASES]
    assert want[1] == (None, None)          # 3 rows do not split over 2
    for out in ranks.two.results():
        assert out["collectives"]["spec"] == want


def test_compressed_pmean_matches_the_reference(ranks):
    """Each rank's leaf through the reference's `quantize_int8`, then the
    reference's de-quantised mean (leaf "b" is bf16, as the mean is)."""
    outs = [out["collectives"]["compress"] for out in ranks.two.results()]
    for leaf, dtype in (("a", jnp.float32), ("b", jnp.bfloat16)):
        parts = [jax_quantize_int8(jnp.asarray(o["grads"][leaf], dtype),
                                   o["err"][leaf]) for o in outs]
        qs = jnp.stack([q for q, _, _ in parts]).astype(jnp.float32)
        ss = jnp.stack([s for _, s, _ in parts])
        mean = (jnp.tensordot(ss, qs, axes=1) / 2).astype(dtype)
        for o, (_, _, e) in zip(outs, parts):
            np.testing.assert_allclose(o["mean"][leaf],
                                       np.asarray(mean, np.float32),
                                       rtol=1e-6)
            np.testing.assert_array_equal(o["new_err"][leaf], np.asarray(e))
    assert outs[0]["mean_dtype"] == "torch.bfloat16"


# ---------------------------------------------------------------------------
# the sharded objective against the single program and the reference
# ---------------------------------------------------------------------------

def test_sharded_objective_on_padded_shards_matches_single(ranks):
    """``soft_objective(axis_name="rows", scale_rows=B)`` on each rank's
    shard of the 9-row grid padded to 10 (cell 1 on both ranks): the
    reassembled loss against the single program's and the reference's,
    and the gradients against autograd's and `jax.grad`'s."""
    r0, r1 = (out["objective"] for out in ranks.two.results())
    assert r0["coupled"] == r1["coupled"]
    # the pad row (rank 1's last) pays its own separable term: leave it out
    loss = r0["base"] + (r1["base"] - 0.5 * float(r1["ratio"][-1])) \
        + r0["coupled"]
    grads = [np.concatenate([a, b])[:9]
             for a, b in zip(r0["grads"], r1["grads"])]
    single, sgrads, jval, jgrads = _single("odd")
    _ulp_close(loss, single)
    _grads_close(grads, sgrads)
    _ulp_close(loss, jval)
    _grads_close(grads, jgrads)


def test_sharded_soft_objective_matches_single_and_reference(ranks):
    outs = [out["sharded_loss"] for out in ranks.two.results()]
    assert outs[0]["loss"] == outs[1]["loss"]
    for a, b in zip(outs[0]["grads"], outs[1]["grads"]):
        np.testing.assert_array_equal(a, b)
    single, sgrads, jval, jgrads = _single("even")
    _ulp_close(outs[0]["loss"], single)
    _grads_close(outs[0]["grads"], sgrads)
    _ulp_close(outs[0]["loss"], jval)
    _grads_close(outs[0]["grads"], jgrads)


def test_sharded_soft_objective_fd_float64(ranks):
    for name, b, fd, ad in ranks.two.results()[0]["sharded_loss"]["fd"]:
        assert abs(fd - ad) <= 1e-4 * max(1.0, abs(fd)), (name, b, fd, ad)


def test_sharded_soft_objective_matches_the_references_sharded_run(
        ranks, jax_sharded):
    ref = jax_sharded()
    assert ref["devices"] == 2
    out = ranks.two.results()[0]["sharded_loss"]
    _ulp_close(out["loss"], ref["loss"])
    _grads_close(out["grads"], [np.asarray(g) for g in ref["grads"]])


# ---------------------------------------------------------------------------
# optimize under ExecutionPlan(mode="sharded") and "auto"
# ---------------------------------------------------------------------------

def _same_results(a, b):
    for x, y in zip(a["raw"], b["raw"]):
        np.testing.assert_array_equal(x, y)
    for k in ("cpc", "cpc_tuned", "source", "stage_cpc"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["history"].keys() == b["history"].keys()
    for k in a["history"]:
        np.testing.assert_array_equal(a["history"][k], b["history"][k])


@pytest.fixture(scope="module")
def jax_single_odd():
    return jax_optimize(JAX_GRIDS["odd"], JaxTuneConfig(
        steps=STEPS, plan=JaxExecutionPlan(mode="single"),
        coupling=JaxCoupling(dispatch=JaxDispatchConfig(**DCFG))))


def test_sharded_coupled_optimize_pads_and_matches_single(ranks,
                                                          jax_single_odd):
    r0, r1 = (out["optimize"] for out in ranks.two.results())
    _same_results(r0["sharded"], r1["sharded"])   # every rank, whole result
    sharded, single = r0["sharded"], r0["single"]
    assert sharded["raw"][0].shape == (9,)
    for name, a, b, c in zip(PolicyParams._fields, sharded["raw"],
                             single["raw"], jax_single_odd.raw):
        np.testing.assert_allclose(a, b, rtol=5e-5, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(c), rtol=5e-5, atol=5e-5,
                                   err_msg=name)
    np.testing.assert_allclose(sharded["cpc"], single["cpc"], rtol=1e-5)
    assert sharded["dispatch"] == single["dispatch"]


def test_sharded_warm_start_survives_the_padding(ranks):
    out = ranks.two.results()[0]["optimize"]
    single = out["single"]["raw"][0]
    drift_warm = float(np.max(np.abs(out["warm"]["raw"][0] - single)))
    drift_cold = float(np.max(np.abs(out["cold"]["raw"][0] - single)))
    assert drift_warm < drift_cold, (drift_warm, drift_cold)
    assert drift_warm < 2.1 * 0.5 * STEPS      # bounded by lr per step


def test_auto_plan_shards_an_uncoupled_loop_like_single(ranks):
    r0, r1 = (out["optimize"] for out in ranks.two.results())
    _same_results(r0["auto"], r1["auto"])
    single = optimize(_port(JAX_GRIDS["even"]), TuneConfig(
        steps=STEPS, plan=ExecutionPlan(mode="single")), device=CPU)
    for name, a, b in zip(PolicyParams._fields, r0["auto"]["raw"],
                          single.raw):
        np.testing.assert_allclose(a, _np(b), rtol=5e-5, atol=5e-5,
                                   err_msg=name)
    np.testing.assert_allclose(r0["auto"]["cpc"], single.cpc, rtol=1e-5)


def test_sharded_loop_with_telemetry_equals_without(ranks):
    out = ranks.two.results()[0]["optimize"]
    on, off = out["auto_telemetry"], out["auto"]
    for x, y in zip(on["raw"], off["raw"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(on["cpc"], off["cpc"])
    assert {"grad_norm", "clip_frac"} <= on["history"].keys()
    assert "grad_norm" not in off["history"]


def test_a_mesh_over_two_of_three_ranks_shares_its_result(ranks):
    outs = [out["subset"] for out in ranks.three.results()]
    _same_results(outs[0], outs[2])
    _same_results(outs[0], outs[1])
    single = optimize(_port(JAX_GRIDS["even"]), TuneConfig(
        steps=3, plan=ExecutionPlan(mode="single"),
        coupling=Coupling(dispatch=DispatchConfig(**DCFG))), device=CPU)
    for a, b in zip(outs[2]["raw"], single.raw):
        np.testing.assert_allclose(a, _np(b), rtol=5e-5, atol=5e-5)
