"""Each cell at its own size on the card, one short run each, untraced
and traced: exit 0, a result line that keeps the contract, ``correct``
true. Run on a machine with a card:

    python3 -m pytest -q -m gpu perfbench/tests/test_pb_card.py
"""

import json
import subprocess
import sys

import pytest

import _tiny


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", list(_tiny.TINY))
def test_cell_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        name, "--seed", "3141592653", "--seconds", "1",
                        "--trace", str(trace)], cwd=_tiny.ROOT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    want = {m["name"] for m in (_tiny.bench()["per_layer"] if trace
                                else _tiny.bench()["end_to_end"])
            if name in m.get("workloads", [name])}
    assert set(line["metrics"]) <= want and line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
