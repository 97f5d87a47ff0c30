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
