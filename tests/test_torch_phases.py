"""``phases.time_kernels`` on the CPU, with the profiler's trace stubbed.

A trace that lost kernel records (a count of matching kernels that is
not the same for every call) is taken again; a trace that is whole on
the first try is used as it is; one that stays lossy raises.
"""

import pytest

from csmom_tpu_torch import phases


def _trace(per_call, drop=0, us=10.0):
    """Spans of ``REPS`` calls, ``per_call`` kernels each (``k1`` then
    ``k2``), the last ``drop`` of them lost."""
    spans = [(10 * i + j, us * (j + 1), f"void k{j + 1}<float>()")
             for i in range(phases.REPS) for j in range(per_call)]
    return spans[:len(spans) - drop]


def _stub(monkeypatch, traces):
    calls = []

    def spans(fn, names, clean):
        calls.append((names, clean))
        return traces[len(calls) - 1]

    monkeypatch.setattr(phases, "_matching_spans", spans)
    return calls


@pytest.mark.parametrize("lost", [0, 1, phases.TRACE_ATTEMPTS - 1])
def test_time_kernels_retraces_a_lossy_trace(monkeypatch, capsys, lost):
    traces = [_trace(1, drop=14)] * lost + [_trace(1)]
    calls = _stub(monkeypatch, traces)
    warm = []
    ms, per_call = phases.time_kernels(lambda: warm.append(1), ("k1",))
    assert (ms, per_call) == (0.01, 1)
    assert len(warm) == 3 and len(calls) == lost + 1
    err = capsys.readouterr().err
    assert err.count("tracing again") == lost
    if lost:
        assert f"{phases.REPS - 14} kernels matching ['k1'] in {phases.REPS} calls" in err


def test_time_kernels_raises_when_every_trace_is_lossy(monkeypatch):
    calls = _stub(monkeypatch, [_trace(1, drop=14)] * phases.TRACE_ATTEMPTS)
    with pytest.raises(RuntimeError, match=f"trace {phases.TRACE_ATTEMPTS} of "
                                           f"{phases.TRACE_ATTEMPTS}"):
        phases.time_kernels(lambda: None, ("k1",))
    assert len(calls) == phases.TRACE_ATTEMPTS


def test_time_kernels_splits_a_whole_trace_by_name(monkeypatch):
    calls = _stub(monkeypatch, [_trace(2, drop=1), _trace(2)])
    ms, per_call, by_name = phases.time_kernels(lambda: None, ("k1", "k2"),
                                                split=True, clean=True)
    assert per_call == 2
    assert ms == pytest.approx(0.03)
    assert by_name == pytest.approx({"k1": 0.01, "k2": 0.02})
    assert calls == [(("k1", "k2"), True)] * 2


# ---- the grid's phases, read from its spans (span_phases, grid_phases) ----

RANGES = [("grid.signal", 0.0, 100.0), ("grid.ranking", 110.0, 200.0),
          ("grid.cohorts", 210.0, 300.0), ("grid.stats", 310.0, 400.0)]
# device-side ranges of the same spans, later than the host's
ANNOTATIONS = [(n, s + 50.0, e + 50.0) for n, s, e in RANGES]


def _op(name, start, us):
    return (name, start, start + us)


def test_span_phases_places_each_operation_by_the_device_side_range():
    ops = [_op("void k<float>()", 60.0, 10.0),
           _op("Memcpy HtoD (Pageable -> Device)", 75.0, 2.0),
           _op("void sort()", 170.0, 30.0),
           _op("void k2()", 260.0, 40.0),
           _op("void lag()", 400.0, 5.0),
           _op("void lag()", 410.0, 5.0)]
    out = phases.span_phases(RANGES, ANNOTATIONS[::-1], ops, phases.GRID_SPANS)
    assert {n: out[n]["launches"] for n in phases.GRID_SPANS} == {
        "grid.signal": 1, "grid.ranking": 1, "grid.cohorts": 1, "grid.stats": 2}
    assert out["grid.signal"]["device_ms"] == pytest.approx(0.012)
    assert out["grid.stats"]["device_ms"] == pytest.approx(0.010)
    assert [out[n]["host_ms"] for n in phases.GRID_SPANS] == pytest.approx(
        [0.1, 0.09, 0.09, 0.09])
    assert out["whole"]["unplaced"] == 0
    assert out["whole"]["launches"] == 5 == sum(out[n]["launches"]
                                                for n in phases.GRID_SPANS)
    assert out["whole"]["device_ms"] == pytest.approx(
        sum(out[n]["device_ms"] for n in phases.GRID_SPANS))


def test_span_phases_counts_what_lies_in_no_range():
    """An operation before the first range, between two or after the last
    stays in ``whole`` only."""
    ops = [_op("void a()", 10.0, 5.0),       # before signal's device range
           _op("void b()", 155.0, 2.0),      # between signal and ranking
           _op("void c()", 10_000.0, 10.0),  # after stats
           _op("void d()", 400.0, 10.0)]     # stats
    out = phases.span_phases(RANGES, ANNOTATIONS, ops, phases.GRID_SPANS)
    assert [out[n]["launches"] for n in phases.GRID_SPANS] == [0, 0, 0, 1]
    assert out["whole"] == {"device_ms": pytest.approx(0.027), "launches": 4,
                            "unplaced": 3}


def test_phase_events_reads_the_grid_spans_of_a_cpu_call(monkeypatch):
    """The trace's parsing on the CPU (no device operation there): the four
    host ranges, flat and in order."""
    import warnings

    import numpy as np
    import torch

    from csmom_tpu_torch.backtest.grid import jk_grid_backtest

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rng = np.random.default_rng(0)
    p = torch.from_numpy(100 * np.exp(np.cumsum(rng.normal(0, 0.05, (24, 48)), 1)))
    m = torch.ones(24, 48, dtype=torch.bool)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # CUDA activity asked without a card
        ranges, annotations, ops, wall = phases._phase_events(
            lambda: jk_grid_backtest(p, m, [3, 6], [3, 6], n_bins=5, mode="rank",
                                     impl="plain"), phases.GRID_SPANS)
    assert [r[0] for r in ranges] == list(phases.GRID_SPANS)
    assert all(a[2] <= b[1] for a, b in zip(ranges, ranges[1:]))
    assert annotations == [] and ops == []
    assert wall > 0.0


def test_phase_events_times_the_traced_call_without_the_margins(monkeypatch):
    """The wall is the call's: the idle margins around it stay out."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(phases, "_TRACE_MARGIN_S", 0.5)
    *_, wall = phases._phase_events(lambda: None, phases.GRID_SPANS)
    assert 0.0 <= wall < 400.0


def test_grid_phases_reports_the_whole_call_and_its_spans(monkeypatch):
    """One timed and one traced call: the split's ``whole`` is the traced
    call's device time and launches, and nothing is traced twice."""
    ops = [_op("void k()", 60.0, 10.0), _op("void s()", 400.0, 10.0)]
    calls, traced = [], []
    monkeypatch.setattr(phases, "time_call", lambda fn: (calls.append(fn) or (7.0, 7.5)))
    monkeypatch.setattr(phases, "_trace", lambda fn: pytest.fail("traced twice"))
    monkeypatch.setattr(phases, "_phase_events", lambda fn, names: (
        traced.append(fn) or (RANGES, ANNOTATIONS, ops, 9.0)))
    import torch

    pm = torch.zeros(5, 9)
    out = phases.grid_phases(pm, pm.bool(), "rank")
    assert out["whole"] == {"device_ms": 7.0, "host_ms": 7.5, "traced_wall_ms": 9.0}
    assert out["spans"]["whole"] == {"device_ms": pytest.approx(0.02), "launches": 2,
                                     "unplaced": 0}
    assert out["spans"]["grid.stats"]["launches"] == 1
    assert len(calls) == 1 and traced == calls
    # K3's counters of one call: a CPU panel launches nothing
    assert out["counts"] == {"rank_labels.launches": 0, "rank_labels.wide_rows": 0}


def test_trace_counts_device_work_and_not_the_ranges_device_twins(monkeypatch):
    """``_trace``'s busy time and activity count: kernels and copies; the
    device-side twin of a profiler range spans them and is neither."""
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, device, us, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(elapsed_us=lambda: us))

    events = [ev("grid.signal", cpu, 900.0, True), ev("grid.signal", cuda, 800.0, True),
              ev("void k()", cuda, 300.0), ev("Memcpy HtoD", cuda, 100.0),
              ev("aten::add", cpu, 50.0)]

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    out = phases._trace(lambda: None)
    assert out["device_activities"] == 2
    assert out["device_busy_ms"] == pytest.approx(0.4)


# ---- the intraday pipeline's phases (intraday_phases, intraday_counts) ----

INTRADAY_RANGES = [(n, 100.0 * i, 100.0 * i + 90.0)
                   for i, n in enumerate(phases.INTRADAY_SPANS)]
INTRADAY_ANNOTATIONS = [(n, s + 20.0, e + 20.0) for n, s, e in INTRADAY_RANGES]


def test_intraday_phases_reports_the_whole_call_its_spans_and_counters(monkeypatch):
    """One timed, one armed and one traced call of the device body: the
    split covers the three intraday spans and the engine's, and the
    counters are the armed call's span attributes, ridge solves and K4's
    counts (none on the CPU, where the fit runs K4's plain version)."""
    from csmom_tpu_torch.obs import spans
    from csmom_tpu_torch.workloads import minute_panels

    ops = [_op("void feats()", 30.0, 10.0), _op("void gemv()", 130.0, 40.0),
           _op("void gemv()", 180.0, 20.0), _op("void scatter()", 230.0, 5.0),
           _op("void cummax()", 560.0, 8.0)]
    calls, traced = [], []
    monkeypatch.setattr(phases, "time_call", lambda fn: (calls.append(fn) or (15.0, 16.0)))
    monkeypatch.setattr(phases, "_phase_events", lambda fn, names: (
        traced.append((fn, names)) or (INTRADAY_RANGES, INTRADAY_ANNOTATIONS, ops, 18.0)))
    out = phases.intraday_phases(minute_panels(3, 1, device="cpu"))
    assert out["whole"] == {"device_ms": 15.0, "host_ms": 16.0, "traced_wall_ms": 18.0}
    assert traced == [(calls[0], phases.INTRADAY_SPANS)]
    sp = out["spans"]
    assert [sp[n]["launches"] for n in phases.INTRADAY_SPANS] == [1, 2, 1, 0, 0, 1]
    assert sp["intraday.fit"]["device_ms"] == pytest.approx(0.06)
    assert sp["whole"]["unplaced"] == 0
    rows = 3 * 390
    assert out["counts"] == {
        "intraday.features.rows": rows, "intraday.features.features": 5,
        "intraday.fit.rows": rows, "intraday.fit.features": 5, "intraday.fit.solves": 4,
        "intraday.fit.model": "ridge", "intraday.scatter.rows": rows,
        "intraday.scatter.features": 5, "ridge.solves": 4,
        "ridge_moments.launches": 0, "ridge_moments.rows": 0}
    assert spans.current_collector() is None
