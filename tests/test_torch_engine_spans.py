"""The engines' phase spans on the CPU: the span's profiler bridge
(``obs/spans.py``) and the phases each engine opens.

- Disarmed and unprofiled, ``span()`` is the shared no-op and never
  enters a profiler range.
- Under ``torch.profiler``, one call of each engine opens exactly its
  phase ranges, once each, in order, each a direct child of the caller's
  range.  Disarmed, nothing is emitted; armed, the JSON-lines records
  come too.
- Armed, a call emits one record a phase, parented to the caller's span,
  with the shape attributes; armed to a file, the records of phases
  inside a caller's span are written with the caller's, in one write.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from csmom_tpu_torch.backtest import event, grid
from csmom_tpu_torch.obs import spans

torch.set_num_threads(2)

GRID = ["grid.signal", "grid.ranking", "grid.cohorts", "grid.stats"]
EVENT = ["event.decide", "event.fill", "event.settle"]
CALLER = "caller"


@pytest.fixture(autouse=True)
def disarmed(monkeypatch):
    """Every test starts disarmed, whatever an earlier test left."""
    monkeypatch.setattr(spans, "_COLLECTOR", None)


def _panel(A=30, M=48, seed=0):
    rng = np.random.default_rng(seed)
    prices = 100 * np.exp(np.cumsum(rng.normal(0.004, 0.06, (A, M)), axis=1))
    prices[: A // 6, : M // 5] = np.nan
    return torch.from_numpy(prices), torch.from_numpy(np.isfinite(prices))


def _minute(A=6, T=96, seed=1):
    rng = np.random.default_rng(seed)
    price = 100 * np.exp(np.cumsum(rng.normal(0, 1e-3, (A, T)), axis=1))
    valid = rng.random((A, T)) > 0.25
    price = np.where(valid, price, np.nan)
    score = np.where(valid, rng.normal(0, 1e-4, (A, T)), np.nan)
    return (torch.from_numpy(price), torch.from_numpy(valid), torch.from_numpy(score),
            torch.full((A,), 1e6, dtype=torch.float64),
            torch.full((A,), 0.02, dtype=torch.float64))


def _grid_call():
    p, m = _panel()
    return lambda: grid.jk_grid_backtest(p, m, [3, 6], [3, 6], n_bins=5,
                                         mode="rank", impl="plain")


def _event_call(latency=0):
    args = _minute()
    return lambda: event.event_backtest(*args, threshold=2e-5, latency_bars=latency)


def _hysteresis_call():
    args = _minute()
    return lambda: event.hysteresis_event_backtest(*args, threshold_hi=1e-4,
                                                   threshold_lo=2e-5)


def _costs_call():
    price, valid, score, adv, vol = _minute()
    r = event.event_backtest(price, valid, score, adv, vol, threshold=2e-5)
    return lambda: event.cost_attribution(r, price)


CALLS = {
    "grid": (_grid_call, GRID),
    "threshold": (_event_call, EVENT),
    "threshold_latency": (lambda: _event_call(latency=2), EVENT),
    "hysteresis": (_hysteresis_call, EVENT),
    "costs": (_costs_call, ["event.costs"]),
}


def _phase_ranges(fn):
    """``(name, parent's name)`` of every grid or event range of one call of
    ``fn`` under the profiler, inside the range ``CALLER``, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            fn()
    evs = sorted((e for e in prof.events() if e.name.startswith(("grid.", "event."))),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None) for e in evs]


def _no_range(name, *args):
    raise AssertionError(f"profiler range {name!r} entered with no profiler")


def _forbid_ranges(monkeypatch):
    """Make entering a profiler range, by either of torch's entry points,
    fail the test."""
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", _no_range)


def test_disarmed_unprofiled_span_is_the_shared_no_op(monkeypatch):
    _forbid_ranges(monkeypatch)
    sp = spans.span("grid.signal", nJ=4)
    assert sp is spans._NULL_SPAN
    with sp as entered:
        assert entered.set(x=1) is entered


@pytest.mark.parametrize("engine", sorted(CALLS))
def test_disarmed_unprofiled_engines_never_enter_record_function(monkeypatch, engine):
    fn = CALLS[engine][0]()
    _forbid_ranges(monkeypatch)
    fn()


@pytest.mark.parametrize("engine", sorted(CALLS))
def test_profiled_call_opens_exactly_its_phase_ranges(engine):
    make, phases = CALLS[engine]
    fn = make()
    assert _phase_ranges(fn) == [(p, CALLER) for p in phases]
    assert spans.current_collector() is None


def test_profiled_and_disarmed_span_emits_nothing():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("grid.signal", nJ=4) as sp:
            assert sp is not spans._NULL_SPAN
            sp.set(x=1).event("inside")
    assert [e.name for e in prof.events() if e.name == "grid.signal"] == ["grid.signal"]
    assert spans.span("grid.signal") is spans._NULL_SPAN


def test_a_spans_range_is_a_user_annotation_like_record_functions():
    """The bridge's range is what ``record_function`` opens: a user
    annotation (the kind the profiler gives a device-side twin), holding
    the operations run inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("grid.signal"):
            torch.ones(3).add(1)
        with record_function("grid.ranking"):
            torch.ones(3).add(1)
    evs = {e.name: e for e in prof.events() if e.name in ("grid.signal", "grid.ranking")}
    assert evs["grid.signal"].is_user_annotation == evs["grid.ranking"].is_user_annotation
    assert evs["grid.signal"].is_user_annotation
    assert [c.name for c in evs["grid.signal"].cpu_children] == \
        [c.name for c in evs["grid.ranking"].cpu_children]


def test_profiled_and_armed_span_gives_the_range_and_the_record():
    col = spans.arm(None)
    try:
        fn = _grid_call()
        assert _phase_ranges(fn) == [(p, CALLER) for p in GRID]
    finally:
        spans.disarm()
    assert [r["name"] for r in col.events] == GRID


def _armed_records(fn):
    col = spans.arm(None)
    try:
        with spans.span("caller") as sp:
            fn()
    finally:
        spans.disarm()
    recs = [r for r in col.events if r["name"] != "caller"]
    return recs, sp.seq


def test_armed_grid_call_emits_four_records_under_the_callers_span():
    recs, parent = _armed_records(_grid_call())
    assert [r["name"] for r in recs] == GRID
    assert all(r["parent"] == parent and r["kind"] == "span" for r in recs)
    assert all(r["attrs"] == {"nJ": 2, "A": 30, "M": 48, "mode": "rank",
                              "impl": "plain"} for r in recs)
    assert all("device_s" not in r for r in recs)
    # flat, one after another: each starts once the one before has ended
    assert all(a["t1_s"] <= b["t0_s"] for a, b in zip(recs, recs[1:]))


@pytest.mark.parametrize("engine", ["threshold", "hysteresis"])
def test_armed_event_call_names_its_engine_and_shape(engine):
    recs, parent = _armed_records(CALLS[engine][0]())
    assert [r["name"] for r in recs] == EVENT
    assert all(r["parent"] == parent for r in recs)
    assert all(r["attrs"] == {"A": 6, "T": 96, "engine": engine} for r in recs)


def test_armed_cost_attribution_emits_one_record():
    recs, parent = _armed_records(_costs_call())
    assert [(r["name"], r["parent"], r["attrs"]) for r in recs] == [
        ("event.costs", parent, {"A": 6, "T": 96, "latency_bars": 0})]


def test_a_phase_that_raises_closes_its_span_with_the_error():
    p, m = _panel()
    col = spans.arm(None)
    try:
        with pytest.raises(ValueError, match="max_hold"):
            grid.jk_grid_backtest(p, m, [3], [6], max_hold=3, impl="plain")
    finally:
        spans.disarm()
    (rec,) = col.events
    assert rec["name"] == "grid.signal" and rec["error"].startswith("ValueError")
    assert spans._stack() == []


def test_the_spans_leave_the_results_as_they_were():
    """A profiled and armed call computes what a plain one does."""
    fn = _grid_call()
    plain = fn()
    col = spans.arm(None)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            traced = fn()
    finally:
        spans.disarm()
    assert len(col.events) == 4
    for f in ("spreads", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        np.testing.assert_array_equal(getattr(traced, f).numpy(),
                                      getattr(plain, f).numpy())
    assert torch.equal(traced.spread_valid, plain.spread_valid)
    assert int(traced.skip) == 1


# ---- armed to a file: nested spans are written with their caller's --------

class _CountingFile:
    """A stream that counts its writes."""

    def __init__(self, fh):
        self.fh, self.writes = fh, 0

    def write(self, text):
        self.writes += 1
        return self.fh.write(text)

    def flush(self):
        self.fh.flush()

    def close(self):
        self.fh.close()


def _arm_file(path):
    col = spans.arm(str(path), run_id="unit", proc="t")
    col._fh = _CountingFile(col._fh)
    return col


def _names(path):
    return [json.loads(line)["name"] for line in path.read_text().splitlines()]


def test_phases_inside_a_callers_span_are_written_with_it_in_one_write(tmp_path):
    path = tmp_path / "s.jsonl"
    col = _arm_file(path)
    try:
        with spans.span("run", root=True):
            with spans.span("caller"):
                _grid_call()()
                assert path.read_text() == ""     # held while the caller is open
            assert _names(path) == GRID + ["caller"]
            assert col._fh.writes == 1
    finally:
        spans.disarm()


@pytest.mark.parametrize("engine", ["grid", "threshold"])
def test_a_call_with_no_caller_span_writes_each_phase_at_once(tmp_path, engine):
    """Directly under a root span (or none), each phase is its own write, as
    every span was before."""
    make, phases = CALLS[engine]
    fn = make()
    path = tmp_path / "s.jsonl"
    col = _arm_file(path)
    try:
        with spans.span("run", root=True):
            fn()
            assert _names(path) == phases
            assert col._fh.writes == len(phases)
    finally:
        spans.disarm()


def test_a_point_inside_a_callers_span_is_written_at_once(tmp_path):
    path = tmp_path / "s.jsonl"
    _arm_file(path)
    try:
        with spans.span("caller"):
            with spans.span("inner"):
                pass
            spans.point("breadcrumb")
            assert _names(path) == ["breadcrumb"]
        assert _names(path) == ["breadcrumb", "inner", "caller"]
    finally:
        spans.disarm()


def test_a_held_phase_keeps_its_error_and_parent(tmp_path):
    p, m = _panel()
    path = tmp_path / "s.jsonl"
    _arm_file(path)
    try:
        with spans.span("caller") as caller:
            with pytest.raises(ValueError, match="max_hold"):
                grid.jk_grid_backtest(p, m, [3], [6], max_hold=3, impl="plain")
    finally:
        spans.disarm()
    held, outer = [json.loads(line) for line in path.read_text().splitlines()]
    assert (held["name"], held["parent"]) == ("grid.signal", caller.seq)
    assert held["error"].startswith("ValueError") and "error" not in outer
