"""The port stands alone: importing every `repro_torch` module loads
neither JAX nor the reference package `repro`."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), ",".join(names), ",".join(bad))
"""


def test_no_module_of_the_port_imports_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    n_modules, names, bad = int(out[0]), out[1].split(","), out[2:]
    assert bad == []
    # the modules of the slices so far: package inits, core, energy,
    # runtime, kernels, fleet, optim, checkpoint, tune, dispatch, examples,
    # the device helper, the serving slice's configs, models, serving
    # engine and launcher, and the Mamba2 slice's ssm model, SSD kernel
    # and serving example, the hybrid slice's config and the two examples
    # of the paper model it brought, the training slice's data package,
    # schedules, compression, trainer, launcher, roofline and example, the
    # telemetry slice's obs package, the live slice's forecasts, SMARD
    # loader, window steps, live package and example, and the faults and
    # workload slice's two packages, ledger kernels and two examples
    assert n_modules == len(names) >= 107
    for name in ("repro_torch.configs.base", "repro_torch.configs.inputs",
                 "repro_torch.configs.qwen2_5_3b",
                 "repro_torch.models.layers", "repro_torch.models.attention",
                 "repro_torch.models.transformer", "repro_torch.models.model",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.decode_attention",
                 "repro_torch.kernels.ops", "repro_torch.energy.stream",
                 "repro_torch.runtime.accounting",
                 "repro_torch.runtime.scheduler",
                 "repro_torch.serving.engine", "repro_torch.launch.serve",
                 "repro_torch.dispatch", "repro_torch.dispatch.allocate",
                 "repro_torch.dispatch.schedule",
                 "repro_torch.kernels.dispatch_scan",
                 "repro_torch.kernels.soft_dispatch",
                 "repro_torch.examples.fleet_dispatch",
                 "repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
                 "repro_torch.configs.mamba2_1_3b",
                 "repro_torch.examples.price_aware_serving",
                 "repro_torch.configs.zamba2_1_2b",
                 "repro_torch.examples.combined_scenario",
                 "repro_torch.examples.regional_study",
                 "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.optim.schedule", "repro_torch.optim.compress",
                 "repro_torch.runtime.trainer", "repro_torch.launch.train",
                 "repro_torch.launch.roofline",
                 "repro_torch.examples.energy_aware_training",
                 "repro_torch.obs", "repro_torch.obs.registry",
                 "repro_torch.obs.schema", "repro_torch.obs.report",
                 "repro_torch.obs.profiling", "repro_torch.energy.forecast",
                 "repro_torch.energy.smard", "repro_torch.live",
                 "repro_torch.live.grid", "repro_torch.live.controller",
                 "repro_torch.live.report", "repro_torch.live.fleet",
                 "repro_torch.kernels.live_window",
                 "repro_torch.examples.live_operator",
                 "repro_torch.faults", "repro_torch.faults.trace",
                 "repro_torch.faults.inject", "repro_torch.workload",
                 "repro_torch.workload.queue", "repro_torch.workload.trace",
                 "repro_torch.workload.backtest",
                 "repro_torch.kernels.queue_scan",
                 "repro_torch.examples.chaos_fleet",
                 "repro_torch.examples.workload_fleet"):
        assert name in names


REF = SRC / "repro"


def _reference_exports():
    """(reference package, module, name) for each ``from <module> import
    <name>`` in a reference package ``__init__``, read with `ast` so the
    reference need not import."""
    import ast
    out = []
    for init in sorted(REF.rglob("__init__.py")):
        pkg = ".".join(init.parent.relative_to(SRC).parts)
        for node in ast.walk(ast.parse(init.read_text())):
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level:
                base = pkg.rsplit(".", node.level - 1)[0]
                module = f"{base}.{node.module}" if node.module else base
            else:
                module = node.module
            if module.split(".")[0] != "repro":
                continue
            out += [(pkg, module, a.name) for a in node.names]
    return out


def test_port_packages_export_what_the_reference_exports():
    """Wherever the port has the module a reference package re-exports a
    name from, and that module defines the name, the port's package
    exports it too. Names whose module is not ported yet, or does not
    define them yet, arrive with their slices."""
    import importlib
    import importlib.util

    def port(name):
        return "repro_torch" + name[len("repro"):]

    exports = _reference_exports()
    assert ("repro.runtime", "repro.runtime.accounting", "CostMeter") \
        in exports
    checked, missing = 0, []
    for pkg, module, name in exports:
        try:
            spec = importlib.util.find_spec(port(module))
        except ModuleNotFoundError:
            spec = None
        if spec is None:
            continue
        if not hasattr(importlib.import_module(port(module)), name):
            continue
        checked += 1
        if not hasattr(importlib.import_module(port(pkg)), name):
            missing.append(f"{port(pkg)}.{name}")
    assert missing == []
    assert checked >= 170
    # the training slice's names, each exported as the reference does
    for pkg, name in (("models", "loss_fn"), ("optim", "warmup_cosine"),
                      ("optim", "constant"), ("optim", "quantize_int8"),
                      ("optim", "dequantize"),
                      ("optim", "init_error_feedback"),
                      ("optim", "compressed_pmean"), ("data", "SyntheticLM"),
                      ("data", "batch_at"), ("data", "host_shard"),
                      ("data", "global_batch_sharding"),
                      ("runtime", "Trainer"), ("runtime", "TrainerConfig"),
                      # the telemetry and live slices' names
                      ("obs", "capture"), ("obs", "drain"),
                      ("obs", "run_metadata"), ("obs", "Histogram"),
                      ("energy", "seasonal_naive"),
                      ("energy", "similar_day_ar_batch"), ("energy", "mase"),
                      ("live", "LiveConfig"), ("live", "live_backtest"),
                      ("live", "live_fleet_dispatch"),
                      ("live", "summarize_live"), ("live", "FORECASTERS"),
                      # the faults and workload slice's names
                      ("faults", "FaultTrace"), ("faults", "random_storm"),
                      ("faults", "faulted_backtest"),
                      ("faults", "faulted_problem"),
                      ("faults", "resolve_masks"), ("faults", "FAULT_KINDS"),
                      ("workload", "Workload"),
                      ("workload", "workload_backtest"),
                      ("workload", "realized_cost"),
                      ("workload", "replay_ledger"),
                      ("workload", "LedgerReplay")):
        assert (f"repro.{pkg}", name) in {(p, n) for p, _, n in exports}
        assert hasattr(importlib.import_module(f"repro_torch.{pkg}"), name)
