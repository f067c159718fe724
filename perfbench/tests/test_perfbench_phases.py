"""The phase readers (``metrics/idle_ms.<phase>.py`` over ``_phases.py``) on
stub traces, and the engines' phase spans in the harness's own host-ops
capture on the CPU."""

from __future__ import annotations

import inspect
import json
import types

import pytest
from conftest import ROOT, TINY

from perfbench import load
from perfbench.metrics._phases import TOP
from perfbench.run import load_reader, resolve, run_cell
from perfbench.trace import BETWEEN_CALLS, CALL_SPAN, Trace, capture, named_stretch

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PHASES = {m["name"]: m for m in BENCH["per_layer"] if m["name"].startswith("idle_ms.")}
GRID = ["grid.signal", "grid.ranking", "grid.cohorts", "grid.stats"]
EVENT = ["event.decide", "event.fill", "event.settle", "event.costs"]


def _span(metric: str) -> str:
    """``idle_ms.grid_signal`` -> ``grid.signal``."""
    return metric.split(".", 1)[1].replace("_", ".", 1)


# 4 ms of device work in 4 calls of 5 ms untraced: 4 ms idle a call
BUSY = (("k", 0.0, 4000.0),)


def _ctx(idle_gaps, n_calls=4, device_ops=BUSY, call_s=0.005):
    return types.SimpleNamespace(call_s=call_s,
                                 trace=Trace(n_calls=n_calls, wall_us=1e4,
                                             device_ops=list(device_ops),
                                             idle_gaps=idle_gaps))


def test_the_eight_phase_metrics_and_their_layers():
    assert sorted(_span(n) for n in PHASES) == sorted(GRID + EVENT)
    for name, m in PHASES.items():
        span = _span(name)
        engine = span.split(".")[0]
        assert m["layer"] == (f"{engine} phase {span.split('.')[1]}: span {span} "
                              f"in backtest/{engine if engine == 'grid' else 'event'}.py")
        assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "program_span")
        if engine == "grid":
            assert (m["moves"], m["workloads"]) == ("engine_call_ms", ["jt93_crsp.grid_rank"])
        else:
            assert m["moves"] == "event_call_ms"
            assert m["workloads"] == ["sp500_minutes.event_threshold",
                                      "sp500_minutes.event_hysteresis"]


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_a_reader_gives_its_phases_idle_ms_a_call(metric):
    """The phase's share of the stretch's idle (10 of 16 ms) times the idle
    of an untraced call (4 ms)."""
    span = _span(metric)
    gaps = [["aten::stack", 0.004], [span, 0.010], [BETWEEN_CALLS, 0.002]]
    assert load_reader(metric).read(_ctx(gaps)) == pytest.approx(2.5)


@pytest.mark.parametrize("engine,phases", [("grid", GRID), ("event", EVENT)])
def test_the_phases_and_the_other_owners_add_up_to_the_idle_a_call(engine, phases):
    gaps = [[n, 0.001 * (i + 1)] for i, n in enumerate(phases)] + [["aten::to", 0.002]]
    read = [load_reader(m).read(_ctx(gaps)) for m in PHASES if m.startswith(f"idle_ms.{engine}")]
    assert sum(read) == pytest.approx(4.0 * 10 / 12)


def test_the_reading_follows_the_untraced_wall_and_not_the_stretchs():
    """Twice the host-ops stretch's idle with the same shares reads the
    same; a slower untraced call reads more."""
    gaps = [["grid.stats", 0.010], ["grid.signal", 0.010]]
    read = load_reader("idle_ms.grid_stats").read
    assert read(_ctx(gaps)) == read(_ctx([[n, 2 * s] for n, s in gaps])) == pytest.approx(2.0)
    assert read(_ctx(gaps, call_s=0.007)) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_a_phase_missing_from_a_short_list_reads_zero(metric):
    gaps = [[n, 0.001] for n in GRID + EVENT if n != _span(metric)][:TOP - 1]
    assert load_reader(metric).read(_ctx(gaps)) == 0.0


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_a_reader_reads_nothing_it_cannot_tell(metric):
    read = load_reader(metric).read
    full = [[f"aten::op{i}", 0.001] for i in range(TOP)]
    assert read(_ctx(full)) is None                          # cut from a full list
    assert read(types.SimpleNamespace(trace=None)) is None   # no trace
    assert read(_ctx([[_span(metric), 0.01]], device_ops=())) is None   # a CPU run
    assert read(_ctx([[_span(metric), 0.01]], call_s=None)) is None     # no untraced wall


def test_the_limit_is_the_traces_own():
    """The owners a trace keeps, both where it names them and where the
    result line lists them."""
    assert TOP == inspect.signature(Trace.breakdown).parameters["top"].default == 10


def _host_ops(workload):
    """The host operations directly under each ``perfbench.call`` of two
    calls of the cell's entry on the CPU, captured as the harness captures
    its named stretch."""
    parts = resolve(BENCH, workload)
    cfg = dict(parts["config"], **TINY[parts["workload"]["config"]])
    cell = load("entries", parts["traffic"]["entry"]).Cell(cfg, parts["traffic"], 7, "cpu")
    cell.call()
    _, prof, _ = capture(cell.call, 2, False, True)
    named = named_stretch(prof.events())
    assert len(named.calls) == 2
    return [n for n, _, _ in named.host_ops]


@pytest.mark.parametrize("workload,phases", [
    ("jt93_crsp.grid_rank", GRID),
    ("sp500_minutes.event_threshold", EVENT),
    ("sp500_minutes.event_hysteresis", EVENT),
])
def test_the_phases_are_direct_children_of_the_call(workload, phases):
    """Each phase once a call, in order, directly under the call's
    annotation; the engine's own operations sit inside the phases, so none
    of them is a direct child (the entry's stack, cat and fetch are)."""
    names = _host_ops(workload)
    assert [n for n in names if n.split(".")[0] in ("grid", "event")] == phases * 2
    assert not {"aten::where", "aten::cumsum", "aten::cummax"} & set(names)
    assert CALL_SPAN not in names


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_cpu_run_still_completes(tiny_root, workload):
    res, _ = run_cell(workload, 2**31 + 5, 0.3, True, device="cpu", root=tiny_root)
    assert res["correct"], res
    # no device operation on the CPU: no phase reads
    assert not set(res["metrics"]) & set(PHASES)
