"""The port's `combined_scenario` and `regional_study` examples against
the reference's (`examples/combined_scenario.py`,
`examples/regional_study.py`), on the same markets: the reference draws
each market's random tensors with `jax.random` from its seed, and the
port's example takes those draws (``draws=``). An uncalibrated region's
seed is the port's in both (the reference salts it per process).

What must agree: the printed tables line by line, their text exactly and
each number within two units of its last printed digit. The tolerances
behind that are `tests/test_torch_core.py`'s: shutdown fractions within
one sample (1/8760, 1.1 units of a percentage printed to 0.01), CPC
reductions within rel 1e-4, prices and Psi within float32 rounding; two
values that close can round to neighbouring printed digits. A threshold
is printed to 0.1 EUR/MWh and is the same sorted price where the two
shutdown fractions are equal (they are, on these markets). One more
allowance: the two generators' prices agree within rel 1e-5
(`tests/test_torch_markets.py`), not bit for bit, and where CPC(x) is
flat around its minimum that moves the argmin by a few samples: a
partition plan's ``x_opt=`` (20.4% for the cheapest partition) is held
within five units (0.05 points, 4.4 samples), its CPC reduction on the
same line within two.
"""

import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.energy import presets as jpresets  # noqa: E402
from repro_torch.energy.presets import region_params  # noqa: E402
from repro_torch.examples import (combined_scenario,  # noqa: E402
                                  regional_study)
from test_torch_markets import reference_draws  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+\.\d+")
FLAT_ARGMIN = re.compile(r"x_opt=(-?\d+\.\d+)")


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draws(mp):
    """The reference's draws for the market ``mp`` describes."""
    return reference_draws(mp.seed, mp.n_hours)


def _same_table(got: str, want: str) -> None:
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        flat = FLAT_ARGMIN.findall(g)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            unit = 10.0 ** -len(a.split(".")[1])
            units = 5 if a in flat else 2
            assert abs(float(a) - float(b)) <= units * unit + 1e-9, (g, w)


@pytest.mark.parametrize("name", ["combined_scenario", "regional_study"])
def test_example_prints_the_reference_table(name, capsys, monkeypatch):
    ref = _reference_example(name)
    monkeypatch.setattr(ref, "region_params", lambda r: jpresets.
                        region_params(r, seed=region_params(r).seed))
    ref.main()
    want = capsys.readouterr().out
    port = {"combined_scenario": combined_scenario,
            "regional_study": regional_study}[name]
    port.main(["--device", "cpu"], draws=_draws)
    got = capsys.readouterr().out
    assert got.count("\n") > 5
    _same_table(got, want)
