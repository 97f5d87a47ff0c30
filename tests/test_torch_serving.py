"""The port's serving path against the JAX reference: the price-gated
`ServingEngine` over the dense model, the price stream, the cost meter
and the energy-aware scheduler. The reference's parameters are carried
across with `params_from_numpy`; everything runs on the CPU at float32,
where the attention wrappers run their plain versions.

What must agree: every request's greedy tokens, exactly (at float32 a
tie between two logits is improbable, and the logits agree within 1e-4:
`tests/test_torch_models.py`); ``completed``, ``tokens_served``,
``queued`` and ``mean_queue_h`` exactly; ``eur_per_1k_tokens`` within
rel 1e-9 (the same host float64 arithmetic in the same order). The
scheduler's threshold: the price at x_opt, which may sit one sample away
from the reference's where two fractions' CPC ratios agree to float32
rounding (`tests/test_torch_core.py`), so its x_opt is held within 1/n
and its price equal where x_opt is. The stream and meter are host numpy
and must agree exactly. The reference's engine tests
(`tests/test_serving_optim.py`) are repeated on the port.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.energy import stream as jstream  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import accounting as jacc  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.inputs import reduced_config  # noqa: E402
from repro_torch.energy import stream  # noqa: E402
from repro_torch.examples import price_aware_serving  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.runtime import accounting, scheduler  # noqa: E402
from repro_torch.serving.engine import (Request, ServeConfig,  # noqa: E402
                                        ServingEngine)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _configs():
    q3 = jinputs.reduced_config(jbase.get_config("qwen2.5-3b"))
    return {
        "qwen1.5-0.5b-smoke": jinputs.reduced_config(
            jbase.get_config("qwen1.5-0.5b")),
        "qwen2.5-3b-smoke": q3,
        "gqa-16-2": q3.replace(name="gqa-16-2", n_heads=16, n_kv_heads=2,
                               head_dim=16),
        # the ssm family: chunk 8, so prompts of 5, 8 and 13 tokens take a
        # padded chunk, a whole one and a whole and a padded one
        "mamba2-1.3b-smoke": jinputs.reduced_config(
            jbase.get_config("mamba2-1.3b")),
        # the hybrid family: 4 Mamba2 layers, the shared attention block
        # after every 2 (two applications, each with its own K/V cache in
        # the pool beside the SSM cache)
        "zamba2-1.2b-smoke": jinputs.reduced_config(
            jbase.get_config("zamba2-1.2b")),
    }


CONFIGS = _configs()


def _carry(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = base.ModelConfig(**dataclasses.asdict(jcfg))
    params = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     device=CPU)
    return jp, cfg, params


@pytest.fixture(scope="module")
def small_model():
    """The reference tests' model: reduced qwen1.5-0.5b, carried across."""
    return _carry(CONFIGS["qwen1.5-0.5b-smoke"])[1:]


def _prices(n=24 * 60, seed=0):
    """A spiky hourly series: a diurnal shape, noise, and 4% spikes."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    p = 80 + 25 * np.sin(2 * np.pi * (t % 24) / 24) + rng.normal(0, 12, n)
    spikes = rng.random(n) < 0.04
    p[spikes] *= rng.uniform(2.0, 5.0, spikes.sum())
    return p


def _requests(cls, vocab, n, seed=0, max_new=6, lens=(8,)):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(2, vocab - 1,
                                    size=int(rng.choice(lens))
                                    ).astype(np.int32),
                max_new=max_new) for i in range(n)]


# ---------------------------------------------------------------------------
# the engine against the reference's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_reference_engine(name):
    """Same parameters, requests and price gate: the same tokens per
    request and the same summary. The gate is the real scheduler over one
    price series (oracle mode), 0.25 h per tick, so admissions stop and
    resume during the run."""
    jcfg = CONFIGS[name]
    jp, cfg, params = _carry(jcfg, seed=1)
    prices = _prices()
    kw = dict(slots=4, min_slots=1, max_seq=40, hours_per_tick=0.25)
    ref_eng = jengine.ServingEngine(
        jp, jcfg, jengine.ServeConfig(**kw),
        scheduler=jsched.EnergyAwareScheduler(
            jstream.PriceStream(prices, start=330),
            jsched.SchedulerConfig(psi=2.0, mode="oracle")))
    eng = ServingEngine(
        params, cfg, ServeConfig(**kw),
        scheduler=scheduler.EnergyAwareScheduler(
            stream.PriceStream(prices, start=330),
            scheduler.SchedulerConfig(psi=2.0, mode="oracle"), device=CPU),
        device=CPU)
    assert eng.scheduler.p_thresh == ref_eng.scheduler.p_thresh
    # the 15 hours served hold three prices above the threshold
    assert (prices[330:345] > eng.scheduler.p_thresh).sum() == 3
    for r in _requests(jengine.Request, jcfg.vocab, 10, lens=(5, 8, 13)):
        ref_eng.submit(r)
    for r in _requests(Request, jcfg.vocab, 10, lens=(5, 8, 13)):
        eng.submit(r)
    want = ref_eng.run(ticks=60)
    got = eng.run(ticks=60)
    assert [r.rid for r in eng.completed] == \
        [r.rid for r in ref_eng.completed]
    for a, b in zip(eng.completed, ref_eng.completed):
        assert a.output == b.output, f"request {a.rid}"
        assert (a.started_h, a.done_h) == (b.started_h, b.done_h)
    for key in ("completed", "tokens_served", "queued", "mean_queue_h",
                "hours", "uptime_hours", "energy_mwh"):
        assert got[key] == want[key], key
    assert got["eur_per_1k_tokens"] == pytest.approx(
        want["eur_per_1k_tokens"], rel=1e-9)
    assert set(got) == set(want)


# ---------------------------------------------------------------------------
# the reference's engine tests, on the port (tests/test_serving_optim.py)
# ---------------------------------------------------------------------------

def test_engine_completes_all_requests(small_model):
    cfg, params = small_model
    eng = ServingEngine(params, cfg, ServeConfig(slots=4, max_seq=32),
                        device=CPU)
    for r in _requests(Request, cfg.vocab, 10):
        eng.submit(r)
    out = eng.run(ticks=40)
    assert out["completed"] == 10
    assert out["tokens_served"] == 10 * 6
    assert all(len(r.output) == 6 for r in eng.completed)


def test_engine_greedy_matches_model(small_model):
    """Slot decoding must equal a straight prefill + decode_step loop."""
    cfg, params = small_model
    req = _requests(Request, cfg.vocab, 1, seed=3, max_new=4)[0]
    eng = ServingEngine(params, cfg, ServeConfig(slots=2, max_seq=32),
                        device=CPU)
    eng.submit(req)
    eng.run(ticks=10)
    got = eng.completed[0].output

    batch = {"tokens": torch.as_tensor(req.prompt[None].astype(np.int64))}
    logits, caches = model.prefill(params, batch, cfg, max_seq=32)
    want = [int(torch.argmax(logits, -1)[0])]
    pos = len(req.prompt)
    for _ in range(3):
        logits, caches = model.decode_step(
            params, torch.tensor([[want[-1]]]), caches, torch.tensor([pos]),
            cfg)
        want.append(int(torch.argmax(logits, -1)[0]))
        pos += 1
    assert got == want


class _PriceStream:
    def __init__(self, price):
        self.price = price

    def current(self):
        return self.price


class _MutableSched:
    """Stub scheduler whose price can be flipped mid-run."""

    def __init__(self, price, thresh=100.0):
        self.stream = _PriceStream(price)
        self.p_thresh = thresh

    def step(self, hours):
        return None


def test_price_gate_blocks_admission(small_model):
    cfg, params = small_model
    eng = ServingEngine(params, cfg,
                        ServeConfig(slots=4, min_slots=0, max_seq=32),
                        scheduler=_MutableSched(price=500.0), device=CPU)
    for r in _requests(Request, cfg.vocab, 4):
        eng.submit(r)
    out = eng.run(ticks=10)
    assert out["completed"] == 0 and out["queued"] == 4


def test_min_slots_keeps_service_during_high_price(small_model):
    cfg, params = small_model
    eng = ServingEngine(params, cfg,
                        ServeConfig(slots=4, min_slots=2, max_seq=32),
                        scheduler=_MutableSched(price=500.0), device=CPU)
    for r in _requests(Request, cfg.vocab, 4):
        eng.submit(r)
    out = eng.run(ticks=30)
    assert out["completed"] == 4           # trickles through 2 slots


def test_admission_width_shrinks_and_recovers(small_model):
    cfg, params = small_model
    sched = _MutableSched(price=500.0)
    eng = ServingEngine(params, cfg,
                        ServeConfig(slots=4, min_slots=1, max_seq=32),
                        scheduler=sched, device=CPU)
    for r in _requests(Request, cfg.vocab, 6, max_new=6):
        eng.submit(r)
    assert eng._admission_width() == 1
    for _ in range(3):
        eng.tick()
    assert int(eng.live.sum()) == 1       # only the SLO floor while high
    sched.stream.price = 50.0             # price relief
    assert eng._admission_width() == 4
    eng.tick()
    assert int(eng.live.sum()) == 4       # full width recovered
    out = eng.run(ticks=20)
    assert out["completed"] == 6 and out["queued"] == 0


def test_eur_per_1k_tokens_matches_tick_accounting(small_model):
    cfg, params = small_model
    price = 60.0
    scfg = ServeConfig(slots=2, max_seq=32, hours_per_tick=0.05,
                       power_mw=0.4, fixed_cost_per_hour=10.0)
    eng = ServingEngine(params, cfg, scfg,
                        scheduler=_MutableSched(price=price), device=CPU)
    for r in _requests(Request, cfg.vocab, 3, max_new=5):
        eng.submit(r)
    ticks = 12
    out = eng.run(ticks=ticks)
    assert out["tokens_served"] == 3 * 5
    hours = ticks * scfg.hours_per_tick
    assert out["hours"] == pytest.approx(hours)
    assert out["fixed_cost"] == pytest.approx(
        scfg.fixed_cost_per_hour * hours)
    assert out["energy_cost"] == pytest.approx(out["energy_mwh"] * price)
    assert out["energy_mwh"] <= scfg.power_mw * hours + 1e-9
    tco = out["fixed_cost"] + out["energy_cost"]
    assert out["tco"] == pytest.approx(tco)
    assert out["eur_per_1k_tokens"] == pytest.approx(
        tco / out["tokens_served"] * 1000.0)
    assert eng.meter.tco == pytest.approx(tco)


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "_reference_price_aware_serving",
        ROOT / "examples" / "price_aware_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_price_aware_serving_example_matches_reference(capsys):
    """`repro_torch.examples.price_aware_serving` against the reference's
    example on the same prices (the reference's south_australia market)
    and parameters, both engines, at 30 requests over 100 ticks of 0.5 h
    from 20 h before the year's highest price: the same table (tokens,
    queue and x exactly; costs within rel 1e-9, host float64 in the same
    order)."""
    ref_ex = _reference_example()
    jcfg = CONFIGS["qwen1.5-0.5b-smoke"]
    jp, cfg, params = _carry(jcfg, seed=0)
    prices = np.asarray(ref_ex.generate_market(
        ref_ex.region_params("south_australia")).prices)
    rows = []
    for gated in (False, True):
        want = ref_ex.run(gated, prices, jp, jcfg, n_requests=30, ticks=100)
        got = price_aware_serving.run(gated, prices, params, cfg,
                                      n_requests=30, ticks=100, device=CPU)
        for key in ("tokens_served", "completed", "queued", "mean_queue_h",
                    "x_realized", "energy_mwh"):
            assert got[key] == want[key], (gated, key)
        for key in ("eur_per_1k_tokens", "energy_cost", "tco"):
            assert got[key] == pytest.approx(want[key], rel=1e-9), key
        rows.append(("price-gated" if gated else "always-on", got))
    assert rows[0][1]["completed"] > 0
    price_aware_serving.report(rows)
    assert "price-gated" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# stream, meter and scheduler against the reference
# ---------------------------------------------------------------------------

def test_price_stream_matches_reference():
    prices = _prices(24 * 10, seed=2)
    prices[[5, 6, 50]] = np.nan
    a = stream.PriceStream(prices, window=48, start=3, fill="ffill")
    b = jstream.PriceStream(prices, window=48, start=3, fill="ffill")
    np.testing.assert_array_equal(a.staleness, b.staleness)
    for hours in (0.02, 0.5, 1.0, 7.3, 13.0):
        a.advance(hours)
        b.advance(hours)
        assert a.current() == b.current() and a.pos == b.pos
        np.testing.assert_array_equal(a.trailing(), b.trailing())
        np.testing.assert_array_equal(a.peek(30), b.peek(30))
        assert a.available_lookahead == b.available_lookahead
    filled, stale = stream.ffill_with_staleness(prices)
    want = jstream.ffill_with_staleness(prices)
    np.testing.assert_array_equal(filled, want[0])
    np.testing.assert_array_equal(stale, want[1])
    with pytest.raises(ValueError, match="non-finite"):
        stream.PriceStream(prices)


def test_cost_meter_matches_reference():
    a = accounting.CostMeter(power_mw=0.7, fixed_cost_per_hour=55.0,
                             idle_power_frac=0.1)
    b = jacc.CostMeter(power_mw=0.7, fixed_cost_per_hour=55.0,
                       idle_power_frac=0.1)
    rng = np.random.default_rng(3)
    for i in range(200):
        price, running = float(rng.uniform(20, 300)), bool(i % 7)
        for m in (a, b):
            m.tick(0.02, price, running=running, load=0.5 + (i % 3) / 4)
        if i % 50 == 10:
            for m in (a, b):
                m.restart_event(price, 0.3, 0.25)
                m.shutdown_event()
    assert a.summary() == b.summary()


@pytest.mark.parametrize("mode", ["oracle", "rolling"])
def test_scheduler_matches_reference(mode):
    prices = _prices(24 * 40, seed=4)
    cfg_kw = dict(psi=1.5, mode=mode, refit_hours=24, lookahead_hours=6,
                  min_off_hours=2.0)
    a = scheduler.EnergyAwareScheduler(
        stream.PriceStream(prices, window=24 * 14),
        scheduler.SchedulerConfig(**cfg_kw), device=CPU)
    b = jsched.EnergyAwareScheduler(
        jstream.PriceStream(prices, window=24 * 14),
        jsched.SchedulerConfig(**cfg_kw))
    n = len(prices)
    for i in range(24 * 30):
        act_a, act_b = a.step(1.0), b.step(1.0)
        assert a.viable == b.viable
        assert abs(a.planned_x - b.planned_x) <= 1.0 / n + 1e-7
        if a.planned_x == b.planned_x:
            assert a.p_thresh == b.p_thresh
            assert act_a.value == act_b.value, f"hour {i}"
    sa, sb = a.stats_snapshot(), b.stats_snapshot()
    assert sa["viable"] == sb["viable"]
    assert sa["p_avg"] == pytest.approx(sb["p_avg"], rel=1e-6)
    parts = [scheduler.Partition("a", 1.0, 60.0),
             scheduler.Partition("b", 2.0, 40.0)]
    jparts = [jsched.Partition("a", 1.0, 60.0),
              jsched.Partition("b", 2.0, 40.0)]
    pa = scheduler.partition_plans(parts, prices, device=CPU)
    pb = jsched.partition_plans(jparts, prices)
    for k in pa:
        assert pa[k]["viable"] == pb[k]["viable"]
        assert pa[k]["psi"] == pb[k]["psi"]
        assert pa[k]["cpc_reduction"] == pytest.approx(
            pb[k]["cpc_reduction"], rel=1e-4, abs=1e-7)


def test_launcher_runs_on_the_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "4", "--ticks",
                       "40", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert '"completed": 4' in out and '"eur_per_1k_tokens"' in out


def test_launcher_and_example_serve_zamba2_on_the_cpu(capsys):
    """``--arch zamba2-1.2b`` (reduced) through the launcher, and the
    price-aware serving example's engines on it against the reference's
    example on the same prices and parameters (6 requests over 40 ticks;
    the same table as `test_price_aware_serving_example_matches_reference`
    holds)."""
    assert serve.main(["--device", "cpu", "--arch", "zamba2-1.2b",
                       "--requests", "4", "--ticks", "40"]) == 0
    out = capsys.readouterr().out
    assert '"completed": 4' in out and '"tokens_served": 64' in out
    ref_ex = _reference_example()
    jp, cfg, params = _carry(CONFIGS["zamba2-1.2b-smoke"], seed=2)
    prices = _prices(24 * 60, seed=6)
    for gated in (False, True):
        want = ref_ex.run(gated, prices, jp, CONFIGS["zamba2-1.2b-smoke"],
                          n_requests=6, ticks=40)
        got = price_aware_serving.run(gated, prices, params, cfg,
                                      n_requests=6, ticks=40, device=CPU)
        for key in ("tokens_served", "completed", "queued", "mean_queue_h",
                    "x_realized", "energy_mwh"):
            assert got[key] == want[key], (gated, key)
        assert got["eur_per_1k_tokens"] == pytest.approx(
            want["eur_per_1k_tokens"], rel=1e-9)
        assert got["completed"] > 0
