"""The port's bench record: the headline survives a capture's 2,000-char
tail, and the capture validators equal the reference's.

``csmom_tpu_torch/bench.py`` against the reference's root ``bench.py``
(imported by file path; importing either initializes no device):

- the headline is hard-capped (``HEADLINE_MAX_CHARS``), always
  parseable, and always points at the full record; both packages'
  ``_headline`` give the same text on the same records once the names
  are mapped (``tpu_probes`` -> ``probes``; the port keeps no session
  cache, so ``tpu_last_verified`` and ``tpu_provenance`` have no
  counterpart: ROADMAP.md known differences 63 and 69);
- the reference's ``test_partial_capture_never_clobbers_full_tpu_cache``
  has no counterpart (no session cache, known difference 63): in its
  place a failed probe prints the last-resort line and exits 1;
- both packages' ``validate`` agree violation for violation on every
  committed ``BENCH_*``, ``MULTICHIP_*`` and ``PHASES_*`` record, on
  mutations of each, and on session captures built in the test;
  ``validate_headline_text`` agrees on the same stdout texts;
- the port's child in smoke mode on the CPU reproduces the reference's
  golden trade count, grid model and workload strings, and the timed
  ``grid.jk`` entry's scalar (f64, ``rtol=1e-10, atol=1e-13``).
"""

import copy
import glob
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu_torch import bench
from csmom_tpu_torch.chaos import invariants as inv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-10, 1e-13   # tests/test_pallas.py:42, f64


@pytest.fixture(scope="module")
def ref_bench():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_under_test", os.path.join(_REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSMOM_BENCH", "CSMOM_FAULT", "CSMOM_TELEMETRY"))}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _bench(args, tmp_path, **extra):
    return subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.bench", *args],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=_env(CSMOM_BENCH_FULL_DIR=str(tmp_path), **extra))


def _bloated_record(probes_key="probes"):
    """A record strictly larger than anything a real run produces (~40k
    chars)."""
    probes = [
        {"utc": f"2026-07-30T21:{i:02d}:00+00:00", "stage": "loop",
         "ok": False,
         "info": "probe timeout after 120s (cuda hung at init) " + "x" * 200}
        for i in range(60)
    ]
    return {
        "metric": "intraday_event_backtest_bar_groups_per_sec",
        "value": 12345.6,
        "unit": "bar_groups/s",
        "vs_baseline": 83.2,
        "extra": {
            "platform": "cpu",
            "device_kind": "cpu",
            "north_star_met": False,
            "grid16_rank_s": 1.2345,
            "grid_workload": "16 cells, 512 stocks x 3780 days (180 months)",
            "golden_ok": True,
            "event_backtest_wall_s": 0.0123,
            probes_key: probes,
            "attempt_errors": ["cuda child attempt 1: " + "e" * 500] * 10,
            "histrank_vs_allgather": {"note": "n" * 800},
        },
    }


# ---------------------------------------------------------------- headline --

def test_headline_is_capped_and_parseable():
    rec = _bloated_record()
    assert len(json.dumps(rec)) > 10_000  # the input really is oversized
    line = bench._headline(rec, "GPU_BENCH_FULL_r05.json")
    assert len(line) <= bench.HEADLINE_MAX_CHARS
    assert bench.HEADLINE_MAX_CHARS <= 1800  # comfortably inside the tail
    assert bench.HEADLINE_MAX_CHARS < inv.DRIVER_TAIL_CHARS
    obj = json.loads(line)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert obj[key] == rec[key]
    assert obj["extra"]["full_record"] == "GPU_BENCH_FULL_r05.json"
    # probe spam is digested, not embedded
    assert "probes" not in obj["extra"]
    assert obj["extra"]["probes_summary"] == "0/60 ok"
    assert inv.validate_headline_text("noise\n" + line + "\n") == []


def test_headline_degrade_path_still_capped(monkeypatch):
    """Even if the digest itself exceeds the cap, the degrade line (four
    fields + pointer) is what goes out, never a long line."""
    monkeypatch.setattr(bench, "HEADLINE_MAX_CHARS", 300)
    line = bench._headline(_bloated_record(), "GPU_BENCH_FULL_r05.json")
    assert len(line) <= 400
    obj = json.loads(line)
    assert obj["extra"]["full_record"] == "GPU_BENCH_FULL_r05.json"
    assert obj["value"] == 12345.6


def test_headline_carries_no_session_cache_fields():
    """The reference's provenance round trip (its headline digests
    ``tpu_last_verified`` to the provenance class) has no counterpart:
    the port keeps no session cache, so a record carrying one gives a
    headline without it, capped, and the record keeps it verbatim."""
    rec = _bloated_record()
    long_prov = ("session-cached (originally: live (an earlier session; "
                 "walls are dispatch-inclusive upper bounds))")
    rec["extra"]["tpu_last_verified"] = {"provenance": long_prov,
                                         "extra": {"huge": "z" * 5000}}
    rec["extra"]["tpu_provenance"] = "live"
    line = bench._headline(rec, "GPU_BENCH_FULL_r05.json")
    assert len(line) <= bench.HEADLINE_MAX_CHARS
    got = json.loads(line)["extra"]
    assert "tpu_last_verified" not in got and "tpu_provenance" not in got
    assert rec["extra"]["tpu_last_verified"]["provenance"] == long_prov


def _port_record(ref_rec):
    """A reference record in the port's names: ``tpu_probes`` ->
    ``probes``, the session-cache fields dropped."""
    rec = copy.deepcopy(ref_rec)
    ex = rec.get("extra") or {}
    if "tpu_probes" in ex:
        ex["probes"] = ex.pop("tpu_probes")
    for k in ("tpu_last_verified", "tpu_provenance"):
        ex.pop(k, None)
    return rec


def _port_headline_of(ref_line):
    """The reference's headline text in the port's names."""
    obj = json.loads(ref_line)
    ex = obj["extra"]
    out = {}
    for k, v in ex.items():
        if k in ("tpu_last_verified", "tpu_provenance"):
            continue
        if k == "tpu_probes_summary":
            k = "probes_summary"
        if k == "full_record_note":
            v = ("complete extra (probes, every grid leg, histrank) lives "
                 "in the full_record file")
        out[k] = v
    obj["extra"] = out
    return json.dumps(obj)


def _records():
    with open(os.path.join(_REPO, "BENCH_FULL_r05.json")) as f:
        committed = json.load(f)
    failed = {"metric": "intraday_event_backtest_bar_groups_per_sec",
              "value": 0.0, "unit": "bar_groups/s", "vs_baseline": 0.0,
              "extra": {"error": "all benchmark attempts failed " + "e" * 300,
                        "attempts": [], "tpu_probes": [{"ok": False}] * 3}}
    partial = copy.deepcopy(committed)
    partial["extra"]["partial"] = "child deadline hit " + "p" * 400
    partial["extra"].pop("tpu_last_verified", None)
    return {"committed": committed, "bloated": _bloated_record("tpu_probes"),
            "failed": failed, "partial": partial}


@pytest.mark.parametrize("cap", [None, 300])
def test_headline_equals_the_references_once_names_are_mapped(ref_bench,
                                                              monkeypatch, cap):
    """Same records, same cap: the same line, or the same degraded line
    (the port digests without the session-cache fields, so with the
    reference's cap its line only degrades where the port's does)."""
    if cap is not None:
        monkeypatch.setattr(bench, "HEADLINE_MAX_CHARS", cap)
        monkeypatch.setattr(ref_bench, "HEADLINE_MAX_CHARS", cap)
    for name, rec in _records().items():
        theirs = ref_bench._headline(copy.deepcopy(rec), "F.json")
        mine = bench._headline(_port_record(rec), "F.json")
        assert mine == _port_headline_of(theirs), name
        assert len(mine) <= bench.HEADLINE_MAX_CHARS


# ----------------------------------------------------------- the supervisor --

def test_failed_probe_prints_the_last_resort_line_and_exits_1(tmp_path):
    """In place of the reference's session-cache test: every probe fails
    (a chaos plan at ``bench.probe``), nothing is measured on another
    device, and the one line on stdout is the last-resort record naming
    the failed probe; the full record and its telemetry land."""
    plan = tmp_path / "plan.toml"
    plan.write_text('name = "probe-outage"\nseed = 13\n\n[[fault]]\n'
                    'point = "bench.probe"\naction = "fail"\n'
                    'role = "supervisor"\nmax_fires = 0\n')
    p = _bench(["--device", "cpu"], tmp_path, CSMOM_ROUND="rtest",
               CSMOM_FAULT_PLAN=str(plan),
               CSMOM_FAULT_STATE=str(tmp_path / "state"))
    assert p.returncode == 1, p.stderr[-2000:]
    lines = [ln for ln in p.stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    obj = json.loads(lines[0])
    assert obj["value"] == 0.0
    assert "cpu probe failed" in obj["extra"]["error"]
    assert obj["extra"]["probes_summary"] == "0/1 ok"
    assert inv.validate_headline_text(p.stdout) == []
    full = json.loads((tmp_path / "GPU_BENCH_FULL_rtest.json").read_text())
    assert [pr["ok"] for pr in full["extra"]["probes"]] == [False]
    assert full["extra"]["telemetry_sidecar"] == "GPU_TELEMETRY_rtest.json"
    side = json.loads((tmp_path / "GPU_TELEMETRY_rtest.json").read_text())
    assert inv.validate(side) == []


def test_total_failure_never_clobbers_a_measured_round_record(tmp_path, monkeypatch):
    """An all-attempts-failed run must not erase the round's measured full
    record: the failure lands under a _failed sibling and the headline
    points there.  With no measured record to protect, the failure claims
    the main name."""
    monkeypatch.setenv("CSMOM_BENCH_FULL_DIR", str(tmp_path))
    good = {"metric": "m", "value": 123.4, "unit": "u", "vs_baseline": 1.0,
            "extra": {"platform": "cpu"}}
    failed = {"metric": "m", "value": 0.0, "unit": "u", "vs_baseline": 0.0,
              "extra": {"error": "all benchmark attempts failed"}}

    ref = bench._write_full_record(dict(failed))
    assert ref == bench.FULL_RECORD_NAME

    (tmp_path / bench.FULL_RECORD_NAME).write_text(json.dumps(good))
    ref = bench._write_full_record(dict(failed))
    assert ref == bench.FULL_RECORD_NAME.replace(".json", "_failed.json")
    kept = json.loads((tmp_path / bench.FULL_RECORD_NAME).read_text())
    assert kept["value"] == 123.4
    assert json.loads((tmp_path / ref).read_text())["value"] == 0.0

    ref = bench._write_full_record(dict(good, value=555.5))
    assert ref == bench.FULL_RECORD_NAME
    assert json.loads(
        (tmp_path / bench.FULL_RECORD_NAME).read_text())["value"] == 555.5


def test_exhausted_budget_still_prints_valid_headline(tmp_path):
    """A budget of 1 s leaves no room for the probe: one parseable, capped
    headline line, the full record written, and, unlike the reference
    (which exits 0 here), exit 1: the line is the last-resort record
    (known difference 68)."""
    p = _bench([], tmp_path, CSMOM_BENCH_BUDGET="1", CSMOM_ROUND="rtest")
    assert p.returncode == 1, p.stderr[-2000:]
    lines = [ln for ln in p.stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    assert len(lines[0]) <= 1800
    obj = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in obj
    assert obj["extra"]["full_record"] == "GPU_BENCH_FULL_rtest.json"
    full = json.loads((tmp_path / "GPU_BENCH_FULL_rtest.json").read_text())
    assert full["metric"] == obj["metric"]
    assert full["extra"]["probes"][0]["info"] == "no budget left for a probe"


def test_the_supervisor_imports_no_torch(tmp_path):
    """The supervisor decides without torch: its probe and children are
    processes of their own."""
    p = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "csmom_tpu_torch.bench"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=_env(CSMOM_BENCH_FULL_DIR=str(tmp_path), CSMOM_BENCH_BUDGET="1",
                 CSMOM_TELEMETRY="0"))
    assert p.returncode == 1
    mods = {ln.split("|")[-1].strip() for ln in p.stderr.splitlines()
            if ln.startswith("import time:")}
    assert "torch" not in mods and "csmom_tpu" not in mods
    assert not any(m.startswith(("jax", "csmom_tpu.")) for m in mods)


@pytest.mark.slow
def test_child_deadline_dumps_partial_record(tmp_path):
    """A child whose device hangs mid-run must still print one parseable
    line before its budget expires.  The stall hook hangs right after the
    headline; the deadline watchdog dumps an explicitly-partial record
    and exits 0 well before the 600 s stall ends."""
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.bench"],
        capture_output=True, text=True, timeout=170, cwd=str(tmp_path),
        env=_env(CSMOM_BENCH_CHILD="1", CSMOM_BENCH_FORCE_CPU="1",
                 CSMOM_BENCH_CHILD_BUDGET="150", CSMOM_BENCH_STALL_S="600"))
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [ln for ln in p.stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    obj = json.loads(lines[0])
    assert obj["extra"]["partial"].startswith("child deadline hit")
    assert obj["value"] > 0
    assert obj["extra"]["platform"] == "cpu"
    assert obj["extra"]["golden_ok"] is True
    assert "grid16_rank_s" not in obj["extra"]


# -------------------------------------------------------------- validators --

def _mapped(violations):
    """The reference's violation texts in the port's words (its round
    labels become what they describe)."""
    return [re.sub(r"\(the \w+ failure mode\)",
                   "(a headline longer than the tail)", v)
            for v in violations]


def _outcome(validate, obj):
    """``validate(obj)``'s violations, or the exception it raises (both
    packages raise alike where a contract field has the wrong type)."""
    try:
        return _mapped(validate(obj))
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return ("raises", type(e).__name__)


def _mutations(obj):
    """Each record, and copies with one contract broken at a time."""
    yield obj
    for k in list(obj)[:6]:
        m = copy.deepcopy(obj)
        del m[k]
        yield m
        m = copy.deepcopy(obj)
        m[k] = None if not isinstance(obj[k], str) else 7
        yield m
    if isinstance(obj.get("extra"), dict):
        m = copy.deepcopy(obj)
        m["extra"]["partial"] = " "
        m["extra"]["rows"] = 3
        m["extra"]["samples"] = {"leg": [1, "x"]}
        yield m
    if isinstance(obj.get("parsed"), dict):
        m = copy.deepcopy(obj)
        m["parsed"]["value"] = -1.0
        yield m
        m = copy.deepcopy(obj)
        m["parsed"] = None
        m["rc"] = 0
        yield m
    if "ok" in obj:
        m = copy.deepcopy(obj)
        m["ok"], m["rc"] = True, 3
        yield m
    if isinstance(obj.get("phases"), list):
        m = copy.deepcopy(obj)
        m["phases"] = [1, {"name": "x"}]
        yield m


def _committed():
    out = {}
    for pat in ("BENCH_*.json", "MULTICHIP_*.json", "PHASES_*.json"):
        for path in sorted(glob.glob(os.path.join(_REPO, pat))):
            with open(path) as f:
                out[os.path.basename(path)] = json.load(f)
    return out


def test_validators_agree_on_every_committed_capture_and_its_mutations():
    recs = _committed()
    kinds = {ref_inv.detect_kind(o) for o in recs.values()}
    assert {"driver_capture", "multichip", "phases", "record"} <= kinds
    n = 0
    for name, obj in recs.items():
        assert inv.detect_kind(obj) == ref_inv.detect_kind(obj), name
        for m in _mutations(obj):
            assert _outcome(inv.validate, m) == _outcome(ref_inv.validate, m), name
            n += 1
    assert n > 100


def _session_capture(record):
    """The shape the reference's supervisor writes as its session cache
    (``{captured_utc, provenance, record}``, ``bench.py:1231-1252``)."""
    return {"captured_utc": "2026-07-16T01:02:03+00:00", "provenance": "live",
            "record": record}


def test_validators_agree_on_session_captures():
    with open(os.path.join(_REPO, "BENCH_FULL_r05.json")) as f:
        rec = json.load(f)
    cases = [_session_capture(rec), _session_capture({"metric": "m"}),
             {**_session_capture(rec), "provenance": 3},
             {"captured_utc": "t", "record": "not a record"},
             {"captured_utc": 1, "provenance": "live", "record": {}}]
    for obj in cases:
        assert ref_inv.detect_kind(obj) == inv.detect_kind(obj) == "tpu_cache"
        assert inv.validate(obj) == ref_inv.validate(obj)
    assert inv.validate(cases[0]) == []
    assert inv.validate(cases[1]) != []


def test_validate_headline_text_agrees():
    head = bench._headline(_records()["committed"], "F.json")
    long = json.dumps({"metric": "m", "value": 1.0, "unit": "u",
                       "vs_baseline": 1.0, "extra": {"x": "y" * 2100}})
    texts = ["", "no json here\n", f"progress\n{head}\n", f"{head}\ntrailing\n",
             f"{long}\n", '{"metric": 1, "value": "x"}\n',
             f'{head}\n{{"broken": \n']
    words = ((r"\(the \w+ failure mode: measurements existed but no line "
              r"landed\)", "(measurements may have existed, but no line landed)"),
             (r"longer than the \S+ 2000-char tail window \(the \w+ failure "
              r"mode\)", "longer than a capture's 2000-char tail (its JSON "
              "would be cut)"))

    def mapped(v):
        for pat, repl in words:
            v = re.sub(pat, repl, v)
        return v

    for text in texts:
        assert inv.validate_headline_text(text) == [
            mapped(v) for v in ref_inv.validate_headline_text(text)], text
    assert inv.DRIVER_TAIL_CHARS == ref_inv.DRIVER_TAIL_CHARS


def test_validate_tree_sweeps_the_ten_families(tmp_path):
    assert inv.validate_tree.__defaults__[0] == tuple(
        f"GPU_{p}" for p in ref_inv.validate_tree.__defaults__[0])
    with open(os.path.join(_REPO, "BENCH_FULL_r05.json")) as f:
        rec = json.load(f)
    (tmp_path / "GPU_BENCH_FULL_r05.json").write_text(json.dumps(rec))
    (tmp_path / "GPU_MULTICHIP_r05.json").write_text(
        json.dumps({"n_devices": 4, "ok": True, "rc": 0, "tail": "",
                    "skipped": False}))
    (tmp_path / "BENCH_FULL_r05.json").write_text(json.dumps(rec))
    assert inv.validate_tree(str(tmp_path)) == {
        "GPU_BENCH_FULL_r05.json": [], "GPU_MULTICHIP_r05.json": []}


# ---------------------------------------------------------------- numbers --

@pytest.fixture(scope="module")
def smoke_child(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench_child")
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.bench"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp),
        env=_env(CSMOM_BENCH_CHILD="1", CSMOM_BENCH_FORCE_CPU="1",
                 CSMOM_BENCH_SMOKE="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    return inv.trailing_json(p.stdout)


def test_smoke_child_record_is_valid_and_reduced(smoke_child):
    ex = smoke_child["extra"]
    assert inv.validate(smoke_child) == [] and not inv.is_partial(smoke_child)
    assert ex["platform"] == "cpu" and ex["device_kind"] == "cpu"
    assert ex["smoke"].startswith("smoke-mode record")
    assert ex["grid16_rank_pallas_s"].startswith("skipped: cpu platform")
    assert ex["grid16_qcut_s"] == bench.SMOKE_REASON
    assert ex["kernel_launches"] == {"decile_partial_sums": 0,
                                     "cohort_partial_sums": 0}
    assert len(ex["samples"]["event_backtest_wall_s"]) == 20
    assert len(ex["samples"]["grid16_rank_s"]) == 5


def test_smoke_child_numbers_equal_the_references(smoke_child):
    from csmom_tpu.compile import workloads as ref_wl

    ex = smoke_child["extra"]
    *_, ref_trades = ref_wl.golden_event_inputs(np.float64)
    assert ex["golden_trades"] == ref_trades == bench.GOLDEN_TRADES
    assert ex["golden_ok"] is True
    A, T = ref_wl.REDUCED_GRID
    M = ref_wl.months_in_days(T)
    nJ, H = len(ref_wl.GRID_JS), max(ref_wl.GRID_KS)
    assert ex["grid_workload"] == f"16 cells, {A} stocks x {T} days ({M} months)"
    assert ex["grid_model_gbytes"] == round(nJ * H * 3 * A * M * 8 / 1e9, 3)
    assert ex["workload"] == (f"golden 20x2728 minute panel, {ref_trades} "
                              "trades (float64)")


def test_the_timed_grid_entry_equals_the_references():
    """The scalar the child times (registry ``grid.jk``, ``rank``) on the
    reduced grid's pack, against the reference's entry on its own pack of
    the same synthetic panel."""
    import torch

    from csmom_tpu.compile import entries as ref_entries
    from csmom_tpu.compile import workloads as ref_wl
    from csmom_tpu_torch.compile import workloads as wl
    from csmom_tpu_torch.registry import entry_factory

    A, T = wl.REDUCED_GRID
    pm, mm, M, _ = wl.grid_month_inputs(A, T, torch.float64, device="cpu")
    mine = entry_factory("grid.jk")(wl.GRID_JS, wl.GRID_KS, wl.GRID_SKIP,
                                    "rank", "plain")(pm, mm)
    rpm, rmm, rM, _ = ref_wl.grid_month_inputs(A, T, np.float64)
    theirs = ref_entries.grid_scalar_fn(ref_wl.GRID_JS, ref_wl.GRID_KS,
                                        ref_wl.GRID_SKIP, "rank", "xla")(rpm, rmm)
    assert M == rM
    np.testing.assert_allclose(float(mine), float(theirs), rtol=RTOL, atol=ATOL)
