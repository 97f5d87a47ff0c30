"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the port's own functions, on the
CPU at a tiny size. (No cell spans chips, so no exchange can be left
out.)"""

import pytest
import torch

import _tiny


def _run(name, monkeypatch, target, wrap, seconds=0.0):
    import importlib
    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    _, o = _tiny.run(name, seconds=seconds)
    return o


TUNE_CELLS = ["table2-aware-tune", "de-mc-tune"]


@pytest.mark.parametrize("name", TUNE_CELLS)
def test_tune_step_that_keeps_its_state(name, monkeypatch):
    def wrap(fn):
        def update(grads, state, params, opt, *a, **kw):
            _, new_state, out = fn(grads, state, params, opt, *a, **kw)
            return params, new_state, out
        return update
    o = _run(name, monkeypatch, "repro_torch.tune.optimizer.adamw_update",
             wrap)
    assert not o.correct and o.checks["loss_gap"][0] > \
        o.checks["loss_gap"][1]


@pytest.mark.parametrize("name", TUNE_CELLS)
def test_tune_half_the_batch_left_out(name, monkeypatch):
    def wrap(fn):
        def objective(raw, problem, tau, **kw):
            loss, aux = fn(raw, problem, tau, **kw)
            b = aux["ratio"].shape[0]
            half = aux["ratio"][: b // 2]
            return half.sum() * (b / half.shape[0]), aux
        return objective
    o = _run(name, monkeypatch, "repro_torch.tune.optimizer.soft_objective",
             wrap)
    assert not o.correct


@pytest.mark.parametrize("name", TUNE_CELLS)
def test_tune_answer_altered_where_produced(name, monkeypatch):
    def wrap(fn):
        def hard(*a, **kw):
            cpc = fn(*a, **kw).clone()
            cpc[-1] *= 1.001
            return cpc
        return hard
    o = _run(name, monkeypatch, "repro_torch.tune.optimizer._hard_cpc_rows",
             wrap)
    assert not o.correct and o.checks["cpc_gap"][0] > o.checks["cpc_gap"][1]


def test_sweep_answer_altered_where_produced(monkeypatch):
    def wrap(fn):
        def scan(*a, **kw):
            out = fn(*a, **kw)
            starts = out.n_starts.clone()
            starts[0] += 1.0
            return out._replace(n_starts=starts)
        return scan
    o = _run("de-mc-sweep", monkeypatch, "repro_torch.fleet.engine.fleet_scan",
             wrap)
    assert not o.correct
    assert o.checks["start_mismatches"][0] > 0


def test_sweep_half_the_batch_left_out(monkeypatch):
    def wrap(fn):
        def scan(prices, p_on, p_off, off_level, idle_frac, *, market_idx,
                 **kw):
            h = market_idx.shape[0] // 2
            part = fn(prices, p_on[:h], p_off[:h], off_level[:h],
                      idle_frac[:h], market_idx=market_idx[:h], **kw)
            return type(part)(*(torch.cat([x, x.mean().expand(
                market_idx.shape[0] - h)]) for x in part))
        return scan
    o = _run("de-mc-sweep", monkeypatch, "repro_torch.fleet.engine.fleet_scan",
             wrap)
    assert not o.correct and o.checks["cpc_gap"][0] > o.checks["cpc_gap"][1]


def test_sweep_stale_grid(monkeypatch):
    """The request's state left as it was: every request after the first
    is answered from the first request's grid."""
    def wrap(fn):
        first = []

        def build(*a, **kw):
            g = fn(*a, **kw)
            if not first:
                first.append(g)
            return first[0]
        return build
    import harness.entry_sweep  # noqa: F401  (it imports build_grid late)
    o = _run("de-mc-sweep", monkeypatch, "repro_torch.fleet.build_grid",
             wrap, seconds=0.3)
    assert o.attempted > 1 and not o.correct
    assert o.checks["threshold_mismatches"][0] > 0


def test_mc_tune_fault_after_the_compared_losses(monkeypatch):
    """A fault past the steps whose losses are compared (the last step
    returns its state unchanged): the full replay of the sampled rows
    sees it, the compared losses do not."""
    def wrap(fn):
        def update(grads, state, params, opt, *a, **kw):
            new_p, new_state, out = fn(grads, state, params, opt, *a, **kw)
            return (params if int(state.step) >= 3 else new_p), new_state, out
        return update
    o = _run("de-mc-tune", monkeypatch,
             "repro_torch.tune.optimizer.adamw_update", wrap)
    assert o.checks["loss_gap"][0] <= o.checks["loss_gap"][1]
    assert not o.correct
    assert o.checks["change_gap"][0] > o.checks["change_gap"][1]


@pytest.mark.parametrize("name", TUNE_CELLS)
def test_tune_guard_rejects_a_row(name, monkeypatch):
    """A row whose ratio is not finite at every step: the finite-step
    guard holds it, and the guard's count makes the run not correct."""
    def wrap(fn):
        def objective(raw, problem, tau, **kw):
            loss, aux = fn(raw, problem, tau, **kw)
            ratio = aux["ratio"].clone()
            ratio[0] = float("nan")
            return loss, {**aux, "ratio": ratio}
        return objective
    o = _run(name, monkeypatch, "repro_torch.tune.optimizer.soft_objective",
             wrap)
    assert not o.correct
    assert o.checks["guard_rejects"][0] > o.checks["guard_rejects"][1]
