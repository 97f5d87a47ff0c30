"""The benchmark's contract: the shape of ``BENCHMARK.json`` and the
files it names, how ``run.py`` refuses to run, the check for forbidden
modules, and the roofline arithmetic against hand-worked shapes."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import _tiny
from harness import cells, cli, roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_shape():
    b = _tiny.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and not re.search(r"[\n\t]", text)
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (_tiny.ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
    # two deployments of one paper name the part of it that defines each
    assert len({c["source"] for c in b["configs"]}) == len(b["configs"])
    cfg_names = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfg_names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (_tiny.BENCH_DIR / "mixes" / f"{w['traffic']}.json").exists()
        assert (_tiny.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert (_tiny.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        cell = cells.load(_tiny.ROOT, b, w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got
    assert len(json.dumps(b)) < 64 * 1024


def test_run_refuses_without_a_card_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "de-mc-sweep", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=_tiny.ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_run_refuses_outside_a_checkout_of_the_port(tmp_path, monkeypatch):
    """In a directory with only BENCHMARK.json and perfbench/ the run
    stops before any work, even where a card is found."""
    shutil.copy(_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_tiny.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    import torch
    monkeypatch.setattr(cli, "ROOT", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["--workload", "de-mc-sweep", "--seed", "1",
                     "--seconds", "1"]) == 4


def test_unknown_workload_refused():
    assert cli.main(["--workload", "nope", "--seed", "1",
                     "--seconds", "1"]) == 2


def test_forbidden_modules_compare_whole_top_level_names():
    assert cli.forbidden_modules({"repro_torch", "repro_torch.fleet",
                                  "torch", "reproducible"}) == []
    assert cli.forbidden_modules({"repro.core", "jaxlib.xla", "flax",
                                  "benchmarks.run", "jax"}) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]


def test_a_rehearsed_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, 'perfbench/tests'); import _tiny;"
            " [_tiny.run(n) for n in _tiny.TINY];"
            " from harness import cli; bad = cli.forbidden_modules();"
            " print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=_tiny.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr


def test_harness_reads_nothing_of_the_jax_benchmarks():
    for path in _tiny.BENCH_DIR.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro"
                             r"|benchmarks)\b(?!_)", text, re.M), path
        if path.parent.name != "tests":
            assert "benchmarks/" not in text, path


def test_roofline_against_hand_worked_shapes():
    # fleet scan at 8 rows of 2 markets x 100 h: 800 + 8 * (8 + 16) + 8 * 16
    # bytes (1120 B, 0.334 ns) against 8000 operations (0.119 ns)
    assert roofline.fleet_scan(8, 100, 2) == pytest.approx(1120 / 3.35e12)
    # 524,288 rows over 8192 x 8760: 10 * 4.59e9 operations -> 0.6856 ms
    assert roofline.fleet_scan(524288, 8760, 8192) * 1e3 == pytest.approx(
        10 * 524288 * 8760 / 67e12 * 1e3)
    # soft scan forward at 1024 x 8760, block 256: 2 * 4 * 8,970,240 bytes
    # + 4 * 1024 * 35 + 4 * 2048 + 4 -> bytes bound
    nbytes = 8 * 1024 * 8760 + 4 * 1024 * 35 + 8 * 1024 + 4
    assert roofline.soft_scan_fwd(1024, 8760, 256) == pytest.approx(
        nbytes / 3.35e12)
    nbytes = 8 * 1024 * 8760 + 4 * 1024 * 35 + 20 * 1024 + 4
    assert roofline.soft_scan_bwd(1024, 8760, 256) == pytest.approx(
        nbytes / 3.35e12)
    # soft dispatch forward at 40 sites x 2190 h, 30 levels: 12 * 120 * 2190
    # * 32 = 100,915,200 operations (1.506 us) over 3,171,120 bytes (0.947 us)
    assert roofline.soft_dispatch_fwd(40, 2190, 30) == pytest.approx(
        100_915_200 / 67e12)
    assert roofline.soft_dispatch_bwd(40, 2190) == pytest.approx(
        (32 * 40 * 2190 + 12 * 2190) / 3.35e12)
    shape = {"rows": 1024, "hours": 8760, "block_t": 256, "sites": None}
    assert roofline.tune_step(shape) == pytest.approx(
        roofline.soft_scan_fwd(1024, 8760, 256)
        + roofline.soft_scan_bwd(1024, 8760, 256))


def test_metric_readers_find_nothing_without_a_trace():
    class Empty:
        trace, spans, shape = None, {}, {}
    for m in _tiny.bench()["per_layer"]:
        assert cells.metric_reader(m["name"])(Empty()) is None


def test_entries_are_found_by_file_name():
    from harness import entries
    for w in _tiny.bench()["workloads"]:
        mix = json.loads((_tiny.BENCH_DIR / "mixes"
                          / f"{w['traffic']}.json").read_text())
        mod = entries.entry_module(mix["entry"])
        assert callable(mod.run) and set(mix) <= mod.MIX_KEYS
    for bad in ("nope", "../cli", "Tune"):
        with pytest.raises(ValueError):
            entries.entry_module(bad)


def test_a_mix_key_the_entry_does_not_read_is_refused():
    c = _tiny.cell("de-mc-sweep")
    c.mix["clients"] = 8
    with pytest.raises(ValueError, match="clients"):
        _tiny.run("de-mc-sweep", c=c)
