"""The port's fleet-scan wrapper and plain version against the JAX
reference: `repro_torch.kernels.ref.fleet_scan_ref` (what the CPU runs)
against `repro.kernels.ref.fleet_scan_ref` and the reference's Pallas
`fleet_scan` in interpret mode, on the same numpy inputs.

Tolerances: start counts are integral and must match exactly; sums match
within rtol 2e-5 / atol 1e-3, the reference's own kernel tolerance
(summation order, and possible FMA contraction in XLA:CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fleet_scan import fleet_scan as jax_fleet_scan  # noqa: E402
from repro.kernels.ref import fleet_scan_ref as jax_fleet_scan_ref  # noqa: E402
from repro.kernels.ref import hard_hour_step as jax_hard_hour_step  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fleet_scan import fleet_scan  # noqa: E402
from repro_torch.kernels.ref import fleet_scan_ref, hard_hour_step  # noqa: E402

FLEET_SCAN_CASES = [(1, 64), (5, 333), (128, 512), (130, 1000)]


def _inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(80, 40, (b, t)).astype(np.float32)
    p_off = rng.uniform(40, 160, b).astype(np.float32)
    p_on = (p_off * rng.uniform(0.7, 1.0, b)).astype(np.float32)
    lvl = rng.uniform(0.0, 0.6, b).astype(np.float32)
    idle = rng.uniform(0.0, 0.3, b).astype(np.float32)
    return p, p_on, p_off, lvl, idle


def _assert_scan_close(got, want, label):
    np.testing.assert_array_equal(got.n_starts.numpy(),
                                  np.asarray(want.n_starts),
                                  err_msg=f"{label} n_starts")
    for name in want._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=2e-5, atol=1e-3, err_msg=f"{label} {name}")


@pytest.mark.parametrize("case", FLEET_SCAN_CASES)
def test_fleet_scan_ref_matches_reference_ref(case):
    args = _inputs(*case, seed=sum(case))
    got = fleet_scan_ref(*(torch.as_tensor(a) for a in args))
    want = jax_fleet_scan_ref(*(jnp.asarray(a) for a in args))
    _assert_scan_close(got, want, f"{case}")


@pytest.mark.parametrize("case", FLEET_SCAN_CASES)
def test_fleet_scan_ref_matches_reference_pallas_interpret(case):
    args = _inputs(*case, seed=sum(case))
    got = fleet_scan(*(torch.as_tensor(a) for a in args))
    want = jax_fleet_scan(*(jnp.asarray(a) for a in args), interpret=True)
    _assert_scan_close(got, want, f"{case}")


def test_fleet_scan_exact_start_count():
    """Start counting is integral, including the initial-on convention
    (no start at t=0)."""
    p = torch.tensor([[50.0, 200.0, 200.0, 50.0, 200.0, 50.0, 50.0]])
    out = fleet_scan(p, torch.tensor([100.0]), torch.tensor([100.0]),
                     torch.tensor([0.0]), torch.tensor([0.0]))
    assert float(out.n_starts[0]) == 2.0
    assert float(out.up_units[0]) == 4.0
    want = jax_fleet_scan_ref(jnp.asarray(p.numpy()), jnp.asarray([100.0]),
                              jnp.asarray([100.0]), jnp.asarray([0.0]),
                              jnp.asarray([0.0]))
    for name in want._fields:
        assert float(getattr(out, name)[0]) == float(getattr(want, name)[0])


def test_hard_hour_step_matches_reference_elementwise():
    """The per-hour rule, including samples exactly at either threshold
    and the degenerate p_on == p_off band, is bit-identical."""
    rng = np.random.default_rng(3)
    n = 4096
    p_off = rng.uniform(40, 160, n).astype(np.float32)
    p_on = np.where(rng.random(n) < 0.3, p_off,
                    p_off * rng.uniform(0.7, 1.0, n)).astype(np.float32)
    pick = rng.integers(0, 3, n)
    p_t = np.where(pick == 0, p_on, np.where(
        pick == 1, p_off, rng.normal(100, 50, n))).astype(np.float32)
    on_prev = rng.integers(0, 2, n).astype(np.float32)
    lvl = rng.uniform(0, 0.9, n).astype(np.float32)
    idle = rng.uniform(0, 0.3, n).astype(np.float32)
    args = (on_prev, p_t, p_on, p_off, lvl, idle)
    got = hard_hour_step(*(torch.as_tensor(a) for a in args))
    want = jax_hard_hour_step(*(jnp.asarray(a) for a in args))
    for g, w, name in zip(got, want, ("on", "start", "cap", "draw")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_wrapper_on_cpu_runs_the_plain_version_exactly():
    args = [torch.as_tensor(a) for a in _inputs(7, 300, seed=5)]
    got = fleet_scan(*args)
    want = fleet_scan_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_the_kernel_for_cpu_tensors():
    args = [torch.as_tensor(a) for a in _inputs(3, 64, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        fleet_scan(*args, use_kernel=True)


def test_fleet_scan_ref_float64_follows_the_same_trajectory():
    """Float64 prices compute in float64: the same decisions, sums within
    the float32 run's accumulation error."""
    args = [torch.as_tensor(a) for a in _inputs(16, 1000, seed=9)]
    f32 = fleet_scan_ref(*args)
    f64 = fleet_scan_ref(args[0].double(), *args[1:])
    assert f64.draw_price_sum.dtype == torch.float64
    assert torch.equal(f32.n_starts.double(), f64.n_starts)
    for a, b in zip(f32, f64):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-3)


def test_build_reports_a_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_build_key_follows_the_source():
    path = build.library_path("fleet_scan")
    assert path == build.library_path("fleet_scan")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libfleet_scan-") and path.suffix == ".so"


def test_build_key_follows_the_included_headers(monkeypatch, tmp_path):
    """A changed csrc/ header rebuilds every source that includes it (and
    only those); the key does not name the checkout's path."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n// a\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "k.cu").write_text('  #include "a.cuh"\n#include <x.h>\n')
    (tmp_path / "plain.cu").write_text("// no header\n")
    keys = [build.library_path("k"), build.library_path("plain")]
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    changed = build.library_path("k")
    assert changed != keys[0]
    assert build.library_path("plain") == keys[1]
    assert str(tmp_path) in build.flags("k")
    (tmp_path / "elsewhere").mkdir()
    for f in ("a.cuh", "b.cuh", "k.cu"):
        (tmp_path / "elsewhere" / f).write_bytes((tmp_path / f).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path / "elsewhere")
    assert build.library_path("k") == changed


def test_scan_probe_variants_match_the_sources():
    """Every text substitution of `scan_probe.py` (each a variant of the
    SSD, dispatch or soft-scan kernel it times on the card) matches the
    sources, and the soft-scan variants' layouts read back."""
    import importlib.util
    root = build.CSRC.parents[3]
    spec = importlib.util.spec_from_file_location("scan_probe",
                                                  root / "scan_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = {lib: (build.CSRC / f"{lib}.cu").read_text()
           for lib in ("ssd_scan", "dispatch_scan", "soft_scan")}
    todo = probe.variants(src["ssd_scan"], src["dispatch_scan"],
                          src["soft_scan"])
    assert todo["ssd as built"] == ("ssd_scan", src["ssd_scan"])
    assert todo["dispatch as built"] == ("dispatch_scan",
                                         src["dispatch_scan"])
    assert todo["soft as built"] == ("soft_scan", src["soft_scan"])
    changed = [name for name, (lib, text) in todo.items()
               if text != src[lib]]
    assert len(changed) == len(todo) - 3
    empty = todo["soft, empty kernels"][1]
    assert empty.count("if (T > 0) return;") == 2
    layouts = {probe._soft_layout(text) for name, (lib, text) in todo.items()
               if lib == "soft_scan"}
    assert layouts == {(256, 12), (128, 12), (512, 12), (256, 8), (256, 16)}
