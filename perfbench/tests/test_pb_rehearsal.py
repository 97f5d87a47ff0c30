"""Every cell rehearsed on the CPU at a tiny size, on the port's plain
paths: the run completes, its result line keeps the contract and its
check passes; the bfloat16 control fails it."""

import json
import math

import pytest
import torch

import _tiny
from harness import report

CELLS = list(_tiny.TINY)


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal_is_correct(name):
    r, o = _tiny.run(name, seconds=0.2)
    assert o.attempted >= 1 and o.failed == 0
    assert o.checks and o.correct, o.checks
    line = report.result_line(r, o)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    e2e = {m["name"] for m in r.cell.end_to_end}
    assert set(line["metrics"]) == e2e and "setup_s" in e2e
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_reports_no_device_numbers_on_the_cpu(name):
    r, o = _tiny.run(name, seconds=0.0, trace=True)
    line = report.result_line(r, o)
    assert line["correct"] is True
    assert "busy_s" not in line["device"] and "breakdown" not in line
    # a reader that finds no device trace returns nothing, never 0
    assert not any("_roofline" in k or k.startswith("device_")
                   for k in line["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    from harness import inputs
    c = _tiny.cell(name)
    a = inputs.prices(c.config, c.mix, 2 ** 31 + 17, "cpu")
    b = inputs.prices(c.config, c.mix, 2 ** 31 + 17, "cpu")
    d = inputs.prices(c.config, c.mix, 2 ** 31 + 18, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, d)
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_the_check(name):
    import control
    from harness import entries
    r = entries.make_run(_tiny.cell(name), seed=4242424242, seconds=0.0,
                         trace=False, device="cpu")
    checks = control.control_checks(r, torch.bfloat16)
    assert any(v > lim for v, lim in checks.values()), checks
