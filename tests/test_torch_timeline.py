"""The port's telemetry timeline against the reference's.

``csmom_tpu_torch.obs.timeline`` assembles a run's event stream into the
sidecar ``GPU_TELEMETRY_<run>.json`` and renders it; ``timeline`` is its
CLI.  On one seeded stream (nested spans over two processes, every
phase, gaps between spans) both packages assemble equal sidecars and
render and print equal text; the reference's own timeline cases give the
same verdicts through the port; the ``telemetry`` validators agree on
good and damaged sidecars.  A telemetry-armed ``warmup`` writes its
sidecar where it is told and nothing at the repository root.
"""

import glob
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from csmom_tpu import obs as ref_obs
from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.cli import timeline as ref_cli
from csmom_tpu.obs import metrics as ref_metrics
from csmom_tpu.obs import timeline as ref_tl
from csmom_tpu_torch import obs
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.cli import timeline as cli
from csmom_tpu_torch.obs import metrics
from csmom_tpu_torch.obs import timeline as tl

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = types.SimpleNamespace(obs=obs, inv=inv, cli=cli, metrics=metrics, tl=tl,
                             prefix="GPU_TELEMETRY_")
REF = types.SimpleNamespace(obs=ref_obs, inv=ref_inv, cli=ref_cli,
                            metrics=ref_metrics, tl=ref_tl, prefix="TELEMETRY_")
BOTH = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "reference"])


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Every case starts and ends disarmed with empty registries, and the
    env contract never leaks into other tests' subprocesses."""
    monkeypatch.delenv("CSMOM_TELEMETRY", raising=False)
    monkeypatch.delenv("CSMOM_TELEMETRY_RUN", raising=False)
    monkeypatch.delenv("CSMOM_TELEMETRY_DIR", raising=False)
    for p in (PORT, REF):
        p.obs.disarm()
        p.metrics.reset()
    yield
    for p in (PORT, REF):
        p.obs.disarm()
        p.metrics.reset()


def _stream(seed=18):
    """A seeded event stream: a root span, nested spans of every phase
    over two pids (a child's spans inside the parent's), gaps between
    them, points, a foreign run's events and a metrics event."""
    rng = np.random.default_rng(seed)
    names = ["warmup.entry", "bench.probe", "aot.compile", "rehearse.row",
             "land.artifact", "serve.dispatch", "replay.run"]
    events, seq, t = [], 0, 100.0
    root = {"kind": "span", "name": "rehearse.run", "t0_s": t, "seq": 0,
            "attrs": {"root": True}, "run": "synt", "proc": "p", "pid": 1}
    for i in range(40):
        t += float(rng.uniform(0.0, 0.3))          # a gap, maybe empty
        d = float(rng.uniform(0.01, 0.5))
        name = names[int(rng.integers(len(names)))]
        pid = int(rng.integers(1, 3))
        seq += 1
        attrs = {"i": i}
        if rng.random() < 0.2:
            attrs["phase"] = ["row", "land", "compile"][int(rng.integers(3))]
        ev = {"kind": "span", "name": name, "seq": seq, "parent": 0,
              "thread": pid, "t0_s": t, "t1_s": t + d, "dur_s": d,
              "attrs": attrs, "run": "synt", "proc": f"p{pid}", "pid": pid}
        if rng.random() < 0.3:
            ev["device_s"] = d / 2
        if rng.random() < 0.1:
            ev["error"] = "RuntimeError: injected"
        events.append(ev)
        if rng.random() < 0.4:  # a nested span inside this one
            seq += 1
            a = t + d * float(rng.uniform(0, 0.5))
            events.append({**ev, "name": names[int(rng.integers(len(names)))],
                           "seq": seq, "parent": seq - 1, "t0_s": a,
                           "t1_s": a + d / 3, "dur_s": d / 3, "attrs": {}})
        if rng.random() < 0.3:
            events.append({"kind": "point", "name": "chaos.serve.dispatch",
                           "t_s": t + d / 2, "attrs": {}, "run": "synt",
                           "pid": pid})
        t += d
    root.update(t1_s=t + 0.25, dur_s=t + 0.25 - root["t0_s"])
    events.append(root)
    events.append({"kind": "span", "name": "rehearse.row", "t0_s": 0.0,
                   "t1_s": 1.0, "run": "yesterday", "pid": 9, "attrs": {}})
    events.append({"kind": "metrics", "run": "synt", "t_s": t, "pid": 1,
                   "data": {"counters": {"rehearse.scenarios": 13},
                            "gauges": {"g": 1.5}}})
    return events


def _same(a, b):
    a, b = dict(a), dict(b)
    a.pop("generated_utc")
    b.pop("generated_utc")
    return a == b


def test_assemble_equals_the_references_on_a_seeded_stream(tmp_path):
    ev = _stream()
    mine, theirs = tl.assemble(ev, run_id="synt"), ref_tl.assemble(ev, run_id="synt")
    assert _same(mine, theirs)
    assert mine["n_processes"] == 2 and mine["n_spans"] > 40
    assert {p["name"] for p in mine["phases"] if p["dur_s"] > 0} == {
        "warmup", "probe", "compile", "row", "land", "other"}
    assert inv.validate(mine) == [] and ref_inv.validate(mine) == []
    # without a run id: the envelope of every event, the first run named
    assert _same(tl.assemble(ev), ref_tl.assemble(ev))
    # the written sidecars differ by their file names only
    a = tl.write_sidecar(str(tmp_path), "synt", events=ev)
    b = ref_tl.write_sidecar(str(tmp_path), "synt", events=ev)
    assert (a, b) == ("GPU_TELEMETRY_synt.json", "TELEMETRY_synt.json")
    assert _same(tl.load_sidecar(str(tmp_path / a)),
                 ref_tl.load_sidecar(str(tmp_path / b)))


def test_render_and_the_cli_print_the_references_text(tmp_path, capsys):
    ev = _stream(7)
    obj = tl.assemble(ev, run_id="synt")
    for top in (3, 12):
        assert tl.render(obj, top=top) == ref_tl.render(obj, top=top)
    path = tmp_path / "sidecar.json"
    path.write_text(json.dumps(obj))
    for as_json in (False, True):
        outs = []
        for mod in (cli, ref_cli):
            args = types.SimpleNamespace(run=str(path), top=5, json=as_json)
            assert mod.cmd_timeline(args) == 0
            outs.append(capsys.readouterr())
        assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    # a raw event stream is assembled on the fly, the latest run rendered
    stream = tmp_path / "events.jsonl"
    stream.write_text("\n".join(json.dumps(e) for e in ev) + "\n{torn")
    outs = []
    for mod in (cli, ref_cli):
        args = types.SimpleNamespace(run=str(stream), top=5, json=True)
        assert mod.cmd_timeline(args) == 0
        outs.append(capsys.readouterr())
    got, want = (json.loads(o.out) for o in outs)
    assert _same(got, want) and outs[0].err == outs[1].err


def _span_ev(name, t0, t1, seq, parent=None, attrs=None):
    return {"kind": "span", "name": name, "seq": seq, "parent": parent,
            "thread": 1, "t0_s": t0, "t1_s": t1, "dur_s": t1 - t0,
            "attrs": attrs or {}, "run": "synt", "proc": "t", "pid": 1}


@BOTH
def test_timeline_phase_partition_priority_and_exact_sum(pkg):
    events = [
        _span_ev("root", 0.0, 5.0, 1, attrs={"root": True}),
        _span_ev("bench.probe", 0.0, 2.0, 2),
        _span_ev("bench.compile", 1.0, 3.0, 3),   # overlaps probe: wins 1..2
        _span_ev("bench.row", 2.5, 4.0, 4),       # overlaps compile: wins
    ]
    obj = pkg.tl.assemble(events, run_id="synt")
    durs = {p["name"]: p["dur_s"] for p in obj["phases"]}
    assert durs == pytest.approx({
        "warmup": 0.0, "probe": 1.0, "compile": 1.5, "row": 1.5,
        "land": 0.0, "other": 1.0,
    })
    assert sum(durs.values()) == pytest.approx(obj["wall_s"])
    assert obj["wall_s"] == pytest.approx(5.0)
    assert pkg.inv.detect_kind(obj) == "telemetry"
    assert pkg.inv.validate(obj) == []


@BOTH
def test_timeline_envelope_fallback_without_root_span(pkg):
    obj = pkg.tl.assemble([_span_ev("bench.row", 1.0, 2.0, 1)], run_id="synt")
    assert obj["wall_s"] == pytest.approx(1.0)
    assert "no root span" in obj["root"]
    assert pkg.inv.validate(obj) == []


@BOTH
def test_assemble_filters_foreign_run_events(pkg):
    events = [
        _span_ev("root", 0.0, 1.0, 1, attrs={"root": True}),
        dict(_span_ev("bench.row", 0.0, 0.5, 2), run="yesterdays-run"),
    ]
    obj = pkg.tl.assemble(events, run_id="synt")
    assert obj["n_spans"] == 1
    assert {p["name"]: p["dur_s"] for p in obj["phases"]}["row"] == 0.0


@BOTH
def test_cli_timeline_damaged_sidecar_still_reports_violations(pkg, tmp_path,
                                                               capsys):
    bad = {"kind": "telemetry", "schema_version": 1, "run_id": "x",
           "wall_s": 1.0,
           "phases": [{"dur_s": 1.0}, "not-a-dict"], "spans": ["junk"]}
    p = tmp_path / f"{pkg.prefix}bad.json"
    p.write_text(json.dumps(bad))
    args = types.SimpleNamespace(run=str(p), top=5, json=False)
    assert pkg.cli.cmd_timeline(args) == 1  # render survives, violations reported
    assert "schema violations" in capsys.readouterr().err


_SIDECARS = [
    {"kind": "telemetry", "schema_version": 1, "run_id": "x", "wall_s": 10.0,
     "phases": [{"name": "row", "dur_s": 1.0}]},
    {"kind": "telemetry", "schema_version": 1, "run_id": "x", "wall_s": 10.0,
     "phases": [{"name": "row", "dur_s": 1.0}, {"name": "other", "dur_s": 9.0}]},
    {"kind": "telemetry", "schema_version": 1, "run_id": "x", "wall_s": 10.0,
     "phases": [{"name": "row", "dur_s": 1.0}, {"name": "other", "dur_s": 9.0},
                {"name": "other", "dur_s": 0.0}]},
    {"kind": "telemetry", "schema_version": 2, "run_id": 3, "wall_s": "x",
     "phases": "no", "spans": {}},
    {"kind": "telemetry", "schema_version": 1, "run_id": "x", "wall_s": 0.01,
     "phases": [{"name": "row", "dur_s": 0.025}, {"dur_s": "a"}, 7]},
    {"kind": "telemetry", "schema_version": 1, "run_id": "x", "wall_s": 1.0,
     "phases": [{"name": "row", "dur_s": 1.0}],
     "metrics": {"memory": {"a": "not captured", "b": [1],
                            "c": {"peak_bytes": 1.5, "x_in_bytes": True},
                            "d": {"peak_bytes": 8, "platform": "gpu"}}}},
    {"kind": "telemetry", "schema_version": 1, "run_id": "x", "wall_s": 1.0,
     "phases": [{"name": "row", "dur_s": 1.0}], "metrics": {"memory": 3}},
    {"run_id": "x", "wall_s": 1.0, "phases": []},
]


@pytest.mark.parametrize("i", range(len(_SIDECARS)))
def test_telemetry_verdicts_equal_the_references(i):
    obj = _SIDECARS[i]
    assert inv.detect_kind(obj) == ref_inv.detect_kind(obj) == "telemetry"
    assert inv.validate(obj) == ref_inv.validate(obj)
    assert inv.validate(obj, "telemetry") == ref_inv.validate(obj, "telemetry")
    assert (inv.validate(obj) == []) == (i == 1)


@BOTH
def test_sidecar_write_validate_render_and_cli(pkg, tmp_path, capsys):
    col = pkg.obs.arm(None, run_id="unit-run", proc="t")
    with pkg.obs.span("run.root", root=True):
        with pkg.obs.span("bench.row", row="leg0"):
            time.sleep(0.005)
        pkg.metrics.counter("bench.rows_landed").inc()
    name = pkg.tl.write_sidecar(str(tmp_path), "unit-run",
                                events=list(col.events),
                                metrics=pkg.metrics.snapshot(include_compile=False))
    path = tmp_path / name
    assert name == f"{pkg.prefix}unit-run.json"
    assert pkg.inv.validate_file(str(path)) == []
    rendered = pkg.tl.render(pkg.tl.load_sidecar(str(path)))
    assert "unit-run" in rendered and "row" in rendered
    args = types.SimpleNamespace(run=str(path), top=5, json=False)
    assert pkg.cli.cmd_timeline(args) == 0
    out = capsys.readouterr().out
    assert "phase" in out and "bench.rows_landed=1" in out
    args = types.SimpleNamespace(run=str(path), top=5, json=True)
    assert pkg.cli.cmd_timeline(args) == 0
    assert json.loads(capsys.readouterr().out)["run_id"] == "unit-run"


@BOTH
def test_cli_timeline_missing_run_fails_cleanly(pkg, tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = types.SimpleNamespace(run="no-such-run-id", top=5, json=False)
    assert pkg.cli.cmd_timeline(args) == 2
    assert "sidecar matches 'no-such-run-id'" in capsys.readouterr().err


@BOTH
def test_finish_and_write_lands_disarms_and_reports_failures(pkg, tmp_path):
    pkg.obs.arm(None, run_id="fw", proc="t")
    with pkg.obs.span("run.root", root=True):
        pass
    name = pkg.tl.finish_and_write(str(tmp_path))
    assert name == f"{pkg.prefix}fw.json"
    assert not pkg.obs.armed()
    assert pkg.inv.validate_file(str(tmp_path / name)) == []
    assert "disarmed" in pkg.tl.finish_and_write(str(tmp_path))
    pkg.obs.arm(None, run_id="fw2", proc="t")
    with pkg.obs.span("x"):
        pass
    assert "unwritable" in pkg.tl.finish_and_write(str(tmp_path / "no" / "dir"))
    assert not pkg.obs.armed()


@BOTH
def test_write_sidecar_no_overwrite_protects_existing_name(pkg, tmp_path):
    existing = tmp_path / f"{pkg.prefix}r99.json"
    existing.write_text("{}")
    name = pkg.tl.write_sidecar(str(tmp_path), "r99", events=[],
                                overwrite=False)
    assert name == f"{pkg.prefix}r99-{os.getpid()}.json"
    assert existing.read_text() == "{}"
    assert pkg.tl.write_sidecar(str(tmp_path), "r99", events=[]) == \
        f"{pkg.prefix}r99.json"
    assert existing.read_text() != "{}"


@BOTH
def test_finish_and_write_run_scopes_the_stream_metrics_check(pkg, tmp_path):
    stream = tmp_path / "s.jsonl"
    stream.write_text(json.dumps(
        {"kind": "metrics", "run": "old-run", "t_s": 0.0,
         "data": {"counters": {"stale": 9}}}) + "\n")
    pkg.obs.arm(str(stream), run_id="new-run", proc="t")
    with pkg.obs.span("run.root", root=True):
        pass
    name = pkg.tl.finish_and_write(str(tmp_path),
                                   fallback_metrics={"counters": {"live": 1}})
    assert pkg.tl.load_sidecar(str(tmp_path / name))["metrics"] == {
        "counters": {"live": 1}}


def test_search_roots_equal_the_references_and_are_shared(tmp_path,
                                                         monkeypatch):
    from csmom_tpu_torch.cli import fleet, trace

    monkeypatch.chdir(tmp_path)
    assert tl.sidecar_search_roots() == ref_tl.sidecar_search_roots()
    monkeypatch.setenv("CSMOM_TELEMETRY_DIR", str(tmp_path / "tel"))
    roots = tl.sidecar_search_roots()
    assert roots == ref_tl.sidecar_search_roots()
    assert roots[0] == str(tmp_path / "tel")
    assert tl.sidecar_search_roots("x") == ["x"]
    assert tl.scratch_dir() == str(tmp_path / "tel")
    # trace and fleet find their artifacts in a scratch directory too
    scratch = tmp_path / ".csmom_scratch"
    scratch.mkdir()
    for mod, name in ((trace, "GPU_TRACE_r1.json"), (fleet, "GPU_FLEET_r1.json")):
        (scratch / name).write_text("{}")
        monkeypatch.delenv("CSMOM_TELEMETRY_DIR")
        assert mod._locate("r1", None) == str(scratch / name)
        monkeypatch.setenv("CSMOM_TELEMETRY_DIR", str(tmp_path / "tel"))


def test_committable_sidecar_holds_on_the_ports_names():
    for name in ("GPU_TELEMETRY_r18.json", "GPU_SERVE_r10.json",
                 "GPU_SERVE_POOL_r11.json", "GPU_SERVE_MESH_r15.json",
                 "GPU_SERVE_FABRIC_r20.json", "GPU_REPLAY_r12.json",
                 "GPU_TRACE_r17.json", "GPU_FLEET_r21.json", "PERF.md",
                 "TELEMETRY_rehearse.json"):
        assert inv.committable_sidecar(name), name
    for name in ("GPU_TELEMETRY_rehearse_fast.json", "GPU_TELEMETRY_r18-77.json",
                 "GPU_SERVE_smoke.json", "GPU_SERVE_POOL_rehearse_x.json",
                 "GPU_TRACE_smoke.json", "GPU_FLEET_rehearse_y.json",
                 "GPU_REPLAY_smoke.json"):
        assert not inv.committable_sidecar(name), name
    # the reference's rule on its own names is the same rule
    for name in ("TELEMETRY_r05.json", "TELEMETRY_rehearse_fast.json"):
        assert inv.committable_sidecar("GPU_" + name) == \
            ref_inv.committable_sidecar(name)
    # and no regenerated telemetry sidecar sits in the tree
    stray = [os.path.basename(p)
             for p in glob.glob(os.path.join(_REPO, "GPU_TELEMETRY_*.json"))
             if not inv.committable_sidecar(os.path.basename(p))]
    assert stray == []


def test_armed_warmup_writes_its_sidecar_where_it_is_told(tmp_path):
    before = set(os.listdir(_REPO))
    env = {**os.environ, "PYTHONPATH": _REPO,
           "CSMOM_TELEMETRY": str(tmp_path / "events.jsonl"),
           "CSMOM_TELEMETRY_RUN": "wu18",
           "CSMOM_JIT_CACHE": str(tmp_path / "jit-cache")}
    env.pop("CSMOM_TELEMETRY_DIR", None)
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "warmup", "--profiles",
         "smoke", "--device", "cpu", "--strict"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "telemetry: GPU_TELEMETRY_wu18.json" in p.stdout
    obj = tl.load_sidecar(str(tmp_path / "GPU_TELEMETRY_wu18.json"))
    assert inv.validate(obj) == [] and obj["run_id"] == "wu18"
    assert {a["name"] for a in obj["spans"]} >= {"warmup.cli", "warmup.entry",
                                                 "aot.compile"}
    # the report followed the build directory, and the root got nothing
    assert (tmp_path / "jit-cache" / "warmup" / "bench" /
            "warmup_report.json").exists()
    new = set(os.listdir(_REPO)) - before
    assert not [n for n in new if "TELEMETRY" in n], new
    # a second run of the same operator id keeps the first sidecar
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "warmup", "--profiles",
         "smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert p.returncode == 0
    assert "telemetry: GPU_TELEMETRY_wu18-" in p.stdout
