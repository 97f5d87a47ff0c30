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
    # the 72 modules of the slices so far: package inits, core, energy,
    # runtime, kernels, fleet, optim, checkpoint, tune, dispatch, examples,
    # the device helper, the serving slice's configs, models, serving
    # engine and launcher, and the Mamba2 slice's ssm model, SSD kernel
    # and serving example
    assert n_modules == len(names) >= 72
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
                 "repro_torch.examples.price_aware_serving"):
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
    assert checked >= 100
