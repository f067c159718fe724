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
