"""The port's perf ledger against the reference's: ``obs/ledger.py``,
``obs/regress.py``, ``cli/ledger.py`` and the ledger's helpers in
``chaos/invariants.py``.  Everything runs on the CPU (``device="cpu"``,
``--device cpu``).

Parity with ``csmom_tpu`` on the same evidence:

- (i) rows: every committed JAX round artifact at the repository root,
  copied under its ``GPU_``-prefixed name, loads into the rows and
  problems ``csmom_tpu.obs.ledger.load`` gives over the originals, field
  for field, only ``source`` differing by its prefix;
- (ii) regress: the bootstrap CIs of both packages agree within the
  repo's f64 tolerance (``rtol=1e-10, atol=1e-13``,
  ``tests/test_pallas.py:42``) with ``n``, ``block_len`` and verdicts
  exact; the point, memory and block-length rules are equal;
- (iii) the CLI: ``ledger diff`` and ``ledger gate --offline`` of both
  print the same text, once the ``GPU_`` prefix is mapped, with the same
  exit codes;
- (iv) ``is_partial``, ``measured_rows``, ``upgrade_ok`` and
  ``detect_kind`` agree on a table of cases.

The reference's ``tests/test_ledger.py`` cases follow on the port's
names (``GPU_BENCH_FULL_rNN.json`` and so on); those over the committed
history run over the renamed copy.  Its three ``timeline`` cases are
ported in ``test_torch_timeline.py`` (the reference's timeline cases,
through both packages), and its memstats case, which probes an XLA
compiled object, by ``test_torch_utils.py``'s memstats case (a CPU call
reports "not available", never a zero).  Then the port's own cases:
``diff`` and ``gate`` without ``--device cpu`` give the no-card error
here, ``roadmap`` refuses ROADMAP.md and leaves it unchanged, and the
port never reads a JAX-named file.
"""

import dataclasses
import glob
import json
import os
import shutil

import pytest
import torch

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.cli.main import main as ref_main
from csmom_tpu.obs import ledger as ref_ld
from csmom_tpu.obs import regress as ref_regress
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.cli.main import PROG
from csmom_tpu_torch.cli.main import main as cli_main
from csmom_tpu_torch.obs import ledger as ld
from csmom_tpu_torch.obs import regress

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the repo's f64 tolerance between kernel forms (tests/test_pallas.py:42)
F64_TOL = dict(rtol=1e-10, atol=1e-13)

# tight/loose sample sets around two well-separated means: the injected
# regression (REF -> 3x) must confirm, and REF-vs-REF_B must not
REF_SAMPLES = [0.100, 0.101, 0.099, 0.1002, 0.0998, 0.1005, 0.0995, 0.1001]
REF_SAMPLES_B = [0.1003, 0.0997, 0.1004, 0.0999, 0.1, 0.1002, 0.0996, 0.1]
BAD_SAMPLES = [3 * s for s in REF_SAMPLES_B]

_WORKLOADS = {
    "workload": "golden 20x2728 minute panel, 28020 trades (float64)",
    "grid_workload": "16 cells, 512 stocks x 3780 days (174 months)",
}

# every committed JAX round artifact at the repository root
COMMITTED = sorted({os.path.basename(p) for pat in ref_ld.DEFAULT_PATTERNS
                    for p in glob.glob(os.path.join(_REPO, pat))})


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The bootstraps are thousands of tiny tensor ops: intra-op threads
    only contend on them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def gpu_tree(tmp_path_factory):
    """The committed history under the port's names."""
    root = tmp_path_factory.mktemp("gpu_tree")
    for name in COMMITTED:
        shutil.copy(os.path.join(_REPO, name), root / f"GPU_{name}")
    return str(root)


def _full_record(rank_samples, value=1.5e6, platform="cpu", **extra_over):
    mean = sum(rank_samples) / len(rank_samples)
    extra = {
        "platform": platform,
        "device_kind": platform,
        **_WORKLOADS,
        "grid16_rank_s": round(mean, 6),
        "samples": {"grid16_rank_s": list(rank_samples)},
        **extra_over,
    }
    return {
        "metric": "intraday_event_backtest_bar_groups_per_sec",
        "value": value, "unit": "bar_groups/s", "vs_baseline": 1.0,
        "extra": extra,
    }


def _telemetry(run, peak_bytes):
    return {
        "kind": "telemetry", "schema_version": 1, "run_id": run,
        "wall_s": 1.0, "t0_s": 0.0, "t1_s": 1.0,
        "phases": [{"name": "row", "dur_s": 1.0}],
        "metrics": {"memory": {"grid.jk16.rank.kernel@512x3780": {
            "argument_size_in_bytes": 100, "temp_size_in_bytes": 50,
            "peak_bytes": int(peak_bytes), "platform": "cpu",
        }}},
    }


def _write(root, name, obj):
    with open(os.path.join(root, name), "w") as f:
        json.dump(obj, f)


@pytest.fixture
def clean_pair(tmp_path):
    """Two runs, statistically identical grid samples."""
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", _full_record(REF_SAMPLES))
    _write(tmp_path, "GPU_BENCH_FULL_r02.json", _full_record(REF_SAMPLES_B))
    return tmp_path


@pytest.fixture
def regressed_pair(tmp_path):
    """Candidate run r02 with grid samples degraded 3x over r01."""
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", _full_record(REF_SAMPLES))
    _write(tmp_path, "GPU_BENCH_FULL_r02.json", _full_record(BAD_SAMPLES))
    return tmp_path


def _cpu(argv):
    """``ledger`` argv with ``--device cpu`` where the subcommand takes it."""
    return argv + ["--device", "cpu"] if argv[1] in ("diff", "gate") else argv


# =================================================== (i) rows, field by field

def _asdict_mapped(row) -> dict:
    d = dataclasses.asdict(row)
    d["source"] = f"GPU_{d['source']}"
    return d


def test_rows_and_problems_equal_the_references_over_the_renamed_history(
        gpu_tree):
    ref, port = ref_ld.load(_REPO), ld.load(gpu_tree)
    assert len(COMMITTED) >= 30 and ref.rows
    assert [dataclasses.asdict(r) for r in port.rows] == \
        [_asdict_mapped(r) for r in ref.rows]
    assert port.problems == [dict(p, source=f"GPU_{p['source']}")
                             for p in ref.problems]
    assert port.runs() == ref.runs()
    assert {k: [_asdict_mapped(r) for r in v]
            for k, v in ref.by_key().items()} == \
        {k: [dataclasses.asdict(r) for r in v]
         for k, v in port.by_key().items()}


@pytest.mark.parametrize("name", COMMITTED)
def test_ingest_file_equals_the_references(name, gpu_tree):
    for have in (frozenset(), frozenset({"r05"})):
        ref_rows, ref_probs = ref_ld.ingest_file(os.path.join(_REPO, name),
                                                 have_full_runs=have)
        rows, probs = ld.ingest_file(os.path.join(gpu_tree, f"GPU_{name}"),
                                     have_full_runs=have)
        assert [dataclasses.asdict(r) for r in rows] == \
            [_asdict_mapped(r) for r in ref_rows]
        assert probs == [dict(p, source=f"GPU_{p['source']}")
                         for p in ref_probs]


@pytest.mark.parametrize("name", ["GPU_TELEMETRY_r05-1234.json",
                                  "GPU_TELEMETRY_r05.json",
                                  "GPU_BENCH_FULL_r05_watcher.json",
                                  "GPU_SERVE_smoke.json", "GPU_FLEET_r1.json",
                                  "GPU_SERVE_POOL_rehearse_x.json"])
def test_run_of_and_scratch_notes_equal_the_references(name):
    assert ld.run_of(name) == ref_ld.run_of(name[len("GPU_"):])
    assert ld._scratch_note(name) == ref_ld._scratch_note(name[len("GPU_"):])


# ============================================================ (ii) regress

def _committed_samples(name, key):
    with open(os.path.join(_REPO, name)) as f:
        return json.load(f)["extra"]["samples"][key]


# the reference tests' sets, and the latency samples of committed serve
# and trace artifacts
SAMPLE_SETS = {
    "ref": REF_SAMPLES, "ref_b": REF_SAMPLES_B, "bad": BAD_SAMPLES,
    "serve_total": _committed_samples("SERVE_FABRIC_r20.json",
                                      "serve_fabric_total_ms"),
    "serve_class": _committed_samples("TRACE_r19.json",
                                      "trace_stage_dispatch_p99_ms"),
}


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= F64_TOL["atol"] + F64_TOL["rtol"] * abs(b)


def _same_ci(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in ("point", "lo", "hi"):
        assert _close(got[k], want[k]), (k, got[k], want[k])
    for k in ("n", "block_len", "n_resamples", "ci_level"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("seed", [0, 12345])
@pytest.mark.parametrize("which", sorted(SAMPLE_SETS))
def test_bootstrap_ci_equals_the_references(which, seed):
    xs = SAMPLE_SETS[which]
    _same_ci(regress.bootstrap_mean_ci(xs, seed=seed, device="cpu"),
             ref_regress.bootstrap_mean_ci(xs, seed=seed))
    _same_ci(regress.bootstrap_mean_ci(xs, n_resamples=300, block_len=3,
                                       ci_level=0.9, seed=seed, device="cpu"),
             ref_regress.bootstrap_mean_ci(xs, n_resamples=300, block_len=3,
                                           ci_level=0.9, seed=seed))


@pytest.mark.parametrize("direction", ["lower", "higher"])
@pytest.mark.parametrize("pair", [("bad", "ref"), ("ref_b", "ref"),
                                  ("ref", "bad"), ("serve_total", "serve_class")])
def test_compare_samples_equals_the_references(pair, direction):
    cand, ref = (SAMPLE_SETS[k] for k in pair)
    got = regress.compare_samples(cand, ref, direction=direction, seed=7,
                                  device="cpu")
    want = ref_regress.compare_samples(cand, ref, direction=direction, seed=7)
    for side in ("candidate", "reference"):
        _same_ci(got.pop(side), want.pop(side))
    rel, want_rel = got.pop("rel_change"), want.pop("rel_change")
    assert _close(rel, want_rel)
    worse, want_worse = got.pop("worse"), want.pop("worse")
    # REF and REF_B have equal sums: their relative change is 0 up to
    # each package's rounding of the means, and its sign is that rounding
    assert worse == want_worse or abs(want_rel) <= F64_TOL["atol"]
    assert got == want


def test_points_memory_and_block_len_equal_the_references():
    for cand, ref, direction, n_c, n_r in [
            (30.0, 10.0, "lower", 1, 1), (10.0, 30.0, "lower", 3, 0),
            (10.0, 10.0, "higher", 0, 0), (0.0, 0.0, "lower", 1, 1),
            (5.0, 0.0, "higher", 2, 9), (9.5, 10.0, "higher", 1, 1),
            (10.5, 10.0, "lower", 1, 1), (12.0, 10.0, "higher", 1, 1)]:
        for rel in (0.05, 0.10, 0.5):
            kw = dict(direction=direction, suspect_rel=rel, reason="r",
                      n_cand=n_c, n_ref=n_r)
            assert regress.compare_points(cand, ref, **kw) == \
                ref_regress.compare_points(cand, ref, **kw)
    for cand, ref in [(220, 100), (105, 100), (50, 100), (0, 0), (7, 0),
                      (111, 100), (89, 100)]:
        for tol in (0.0, 0.1, 0.5):
            assert regress.compare_memory(cand, ref, tol_rel=tol) == \
                ref_regress.compare_memory(cand, ref, tol_rel=tol)
    assert [regress.default_block_len(n) for n in range(1, 400)] == \
        [ref_regress.default_block_len(n) for n in range(1, 400)]
    assert (regress.MIN_SAMPLES, regress.GATE_FAILING,
            regress.DEFAULT_MIN_REL, regress.DEFAULT_SUSPECT_REL,
            regress.DEFAULT_MEM_TOL) == \
        (ref_regress.MIN_SAMPLES, ref_regress.GATE_FAILING,
         ref_regress.DEFAULT_MIN_REL, ref_regress.DEFAULT_SUSPECT_REL,
         ref_regress.DEFAULT_MEM_TOL)
    # compare's dispatch: too few samples on a side is a point delta
    for cs, rs in [(None, None), ([1.0] * 4, REF_SAMPLES),
                   (REF_SAMPLES, []), ([2.0] * 5, [1.0] * 5)]:
        got = regress.compare(2.0, 1.0, cand_samples=cs, ref_samples=rs,
                              device="cpu")
        want = ref_regress.compare(2.0, 1.0, cand_samples=cs, ref_samples=rs)
        assert got["verdict"] == want["verdict"]
        assert got["basis"] == want["basis"]


# ================================================================ (iii) CLI

def _run(main, argv, cwd, capsys, monkeypatch):
    monkeypatch.chdir(cwd)
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


# the one message the port words for its own platforms
_ERR_MAP = (("(cpu rows never compare against gpu rows)",
             "(cpu-fallback rows never compare against tpu rows)"),)


def _as_reference_text(text: str) -> str:
    for a, b in _ERR_MAP:
        text = text.replace(a, b)
    return text.replace("GPU_", "").replace(PROG, "csmom")


def _same_command(argv, ref_root, port_root, capsys, monkeypatch):
    """Both CLIs on ``argv`` over their trees (the working directory each
    tree, so the printed root reads the same); returns the exit code."""
    ref = _run(ref_main, argv + ["--root", str(ref_root)], ref_root, capsys,
               monkeypatch)
    port = _run(cli_main, argv + ["--root", str(port_root), "--device", "cpu"],
                port_root, capsys, monkeypatch)
    assert port[0] == ref[0]
    assert _as_reference_text(port[1]) == ref[1]
    assert _as_reference_text(port[2]) == ref[2]
    return ref[0]


_RUNS = ref_ld.load(_REPO).runs()


@pytest.mark.parametrize("pair", list(zip(_RUNS, _RUNS[1:]))
                         + [("r10", "r14"), ("r05", "r21"), ("r18", "r20")],
                         ids=lambda p: "-".join(p))
def test_diff_prints_the_references_text(pair, gpu_tree, capsys, monkeypatch):
    _same_command(["ledger", "diff", *pair], _REPO, gpu_tree, capsys,
                  monkeypatch)


@pytest.mark.parametrize("candidate", [None, "r21", "r20", "r19", "r17",
                                       "r14", "r13", "r05", "r01", "r99",
                                       "rx1"])
def test_gate_prints_the_references_text(candidate, gpu_tree, capsys,
                                         monkeypatch):
    argv = ["ledger", "gate", "--offline"]
    if candidate:
        argv += ["--candidate", candidate]
    _same_command(argv, _REPO, gpu_tree, capsys, monkeypatch)


@pytest.mark.parametrize("case", ["clean", "regressed", "memory", "drift",
                                  "vanished", "thresholds"])
def test_synthetic_trees_print_the_references_text(case, tmp_path, capsys,
                                                   monkeypatch):
    # r02 0.2% over REF_B: REF and REF_B have equal sums, and the sign of
    # a zero change is each package's rounding of the means
    files = {"BENCH_FULL_r01.json": _full_record(REF_SAMPLES),
             "BENCH_FULL_r02.json": _full_record(
                 BAD_SAMPLES if case == "regressed"
                 else [1.002 * s for s in REF_SAMPLES_B])}
    thresholds = []
    if case == "memory":
        files["TELEMETRY_r01.json"] = _telemetry("r01", 1_000_000)
        files["TELEMETRY_r02.json"] = _telemetry("r02", 2_000_000)
    if case == "drift":
        for i, peak in enumerate((1_000_000, 1_090_000, 1_190_000), start=1):
            files[f"TELEMETRY_r{i:02d}.json"] = _telemetry(f"r{i:02d}", peak)
    if case == "vanished":
        files["BENCH_FULL_r01.json"]["extra"]["grid16_qcut_s"] = 0.25
        files["BENCH_FULL_r02.json"]["extra"]["grid16_qcut_s"] = "failed: x"
    if case == "thresholds":
        files["BENCH_FULL_r02.json"] = _full_record(
            [1.04 * s for s in REF_SAMPLES_B])
        thresholds = ["--min-rel", "0.01", "--suspect-rel", "0.02",
                      "--mem-tol", "0.5"]
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    ref_root.mkdir()
    port_root.mkdir()
    for name, obj in files.items():
        _write(ref_root, name, obj)
        _write(port_root, f"GPU_{name}", obj)
    rc = _same_command(["ledger", "gate", "--offline", *thresholds],
                       ref_root, port_root, capsys, monkeypatch)
    assert rc == (1 if case in ("regressed", "memory", "thresholds") else 0)
    _same_command(["ledger", "diff", "r01", "r02", *thresholds], ref_root,
                  port_root, capsys, monkeypatch)


# ============================================================= (iv) helpers

_OBJECTS = [
    None, [], "x", {}, {"partial": ""}, {"partial": "deadline"},
    {"extra": {"partial": "grid legs"}}, {"extra": {"partial": None}},
    {"extra": "not a dict", "partial": 0},
    {"rows": [1, 2, 3]}, {"phases": [{"name": "a"}]},
    {"extra": {"rows": [1, 2]}}, {"extra": {"phases": [1, 2, 3, 4]}},
    {"rows": "x", "extra": {"rows": [1]}}, {"rows": [], "phases": [1]},
    {"phases": "no", "extra": {"rows": [9]}},
    {"metric": "m", "value": 1.0}, {"metric": "m", "phases": []},
    {"n_devices": 4, "ok": True}, {"captured_utc": "t", "record": {}},
    {"rc": 0, "tail": "…"}, {"files_scanned": 1, "rules": [], "findings": []},
    {"kind": "serve"}, {"kind": "telemetry"}, {"kind": "record"},
    {"run_id": "x", "wall_s": 1, "phases": []},
    {"requests": {}, "latency_ms": {}, "batches": {}},
    {"requests": {}, "availability": 1, "hedge": {}},
    {"requests": {}, "availability": 1, "routers": {}, "transport": {},
     "hedge": {}},
    {"series": {}, "demand": {}, "capacity": {}, "requests": {}},
    {"books": {}, "stages": {}, "reconcile": {}, "metric": "m", "value": 1},
    {"ticks": {}, "panel": {}, "reconcile": {}},
    {"metric": "m", "value": 1, "rc": 0, "tail": ""},
    {"metric": "m", "value": 1, "partial": "x", "rows": [1]},
]


@pytest.mark.parametrize("i", range(len(_OBJECTS)))
def test_helpers_equal_the_references(i):
    obj = _OBJECTS[i]
    assert inv.is_partial(obj) == ref_inv.is_partial(obj)
    assert inv.measured_rows(obj) == ref_inv.measured_rows(obj)
    assert inv.detect_kind(obj) == ref_inv.detect_kind(obj)
    for other in _OBJECTS:
        if isinstance(other, dict) or other is None:
            assert inv.upgrade_ok(obj, other) == ref_inv.upgrade_ok(obj, other)
            assert inv.upgrade_ok(other, obj) == ref_inv.upgrade_ok(other, obj)


@pytest.mark.parametrize("name", COMMITTED)
def test_detect_kind_equals_the_references_on_the_committed_files(name):
    with open(os.path.join(_REPO, name)) as f:
        obj = json.load(f)
    assert inv.detect_kind(obj) == ref_inv.detect_kind(obj)
    assert inv.is_partial(obj) == ref_inv.is_partial(obj)
    assert inv.measured_rows(obj) == ref_inv.measured_rows(obj)


def test_validate_routes_lint_and_record_and_names_the_capture_kinds():
    report = {"schema_version": 2, "ok": True, "files_scanned": 3,
              "rules": ["clock-discipline"], "project": False,
              "findings": [], "suppressed": [],
              "cache": {"enabled": False}, "rule_timings_s": {}}
    for obj in (report, {**report, "surprise": 1}, {**report, "ok": False},
                {**report, "schema_version": 9},
                {**report, "findings": [{"rule": "x"}, 3]},
                {**report, "cache": {}}, _full_record(REF_SAMPLES),
                {"metric": 1, "value": "x"},
                {"metric": "m", "value": 1, "unit": "s", "vs_baseline": 1,
                 "extra": {"partial": " ", "rows": 3, "samples": [1]}}):
        assert inv.validate(obj) == ref_inv.validate(obj)
    for obj in ({"rc": 0, "tail": ""}, {"n_devices": 4, "ok": True},
                {"metric": "m", "phases": []},
                {"captured_utc": "t", "record": {}}):
        (v,) = inv.validate(obj)
        assert v.startswith(f"{inv.detect_kind(obj)}: no validator in the port")
        assert "Queue 1 item 8b" in v
    assert inv.validate({"x": 1}) == ref_inv.validate({"x": 1})
    assert inv.validate({"x": 1}, "nope") == ref_inv.validate({"x": 1}, "nope")


# ============================= the reference's tests/test_ledger.py, ported

# ------------------------------------------------------------ regress ----

def test_bootstrap_ci_brackets_the_mean():
    ci = regress.bootstrap_mean_ci(REF_SAMPLES, n_resamples=500, device="cpu")
    assert ci["lo"] <= ci["point"] <= ci["hi"]
    assert abs(ci["point"] - 0.1) < 0.001
    assert ci["n"] == len(REF_SAMPLES)


def test_confirmed_regression_needs_disjoint_cis_and_material_delta():
    v = regress.compare_samples(BAD_SAMPLES, REF_SAMPLES, direction="lower",
                                device="cpu")
    assert v["verdict"] == "regression" and v["worse"]
    # same distribution: never confirmed, whatever the noise says
    v2 = regress.compare_samples(REF_SAMPLES_B, REF_SAMPLES,
                                 direction="lower", device="cpu")
    assert v2["verdict"] == "no-change"
    # higher-is-better mirror: 3x more throughput is an improvement
    v3 = regress.compare_samples(BAD_SAMPLES, REF_SAMPLES,
                                 direction="higher", device="cpu")
    assert v3["verdict"] == "improvement"


def test_point_comparison_is_never_a_confirmed_regression():
    v = regress.compare(30.0, 10.0, direction="lower")
    assert v["verdict"] == "suspect"          # flagged...
    assert v["verdict"] not in regress.GATE_FAILING  # ...but never gating
    assert "point-delta" in v["basis"]
    # too few samples on one side degrades to point-delta too
    v2 = regress.compare(30.0, 10.0, cand_samples=[30.0] * 2,
                         ref_samples=REF_SAMPLES, direction="lower")
    assert "point-delta" in v2["basis"]


def test_memory_compare_is_deterministic():
    assert regress.compare_memory(220, 100)["verdict"] == "memory-growth"
    assert regress.compare_memory(105, 100)["verdict"] == "no-change"
    assert regress.compare_memory(50, 100)["verdict"] == "memory-shrink"


# ------------------------------------------------------------- ledger ----

def test_ingest_separates_platforms_and_provenance(tmp_path):
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", _full_record(REF_SAMPLES))
    _write(tmp_path, "GPU_BENCH_FULL_r02.json",
           _full_record(REF_SAMPLES_B, platform="gpu"))
    L = ld.load(str(tmp_path))
    rows = [r for r in L.rows if r.metric == "grid16_rank_s"]
    assert {r.platform for r in rows} == {"cpu", "gpu"}
    keys = {r.key() for r in rows}
    assert len(keys) == 2, "cpu and gpu rows must never share a ledger key"
    assert all(r.samples == tuple(r_s) for r, r_s in
               zip(sorted(rows, key=lambda r: r.run),
                   (REF_SAMPLES, REF_SAMPLES_B)))


def test_partial_smoke_and_variant_rows_are_not_gate_eligible(tmp_path):
    _write(tmp_path, "GPU_BENCH_FULL_r01.json",
           _full_record(REF_SAMPLES, partial="deadline hit"))
    _write(tmp_path, "GPU_BENCH_FULL_r02_watcher.json",
           _full_record(REF_SAMPLES_B))
    L = ld.load(str(tmp_path))
    assert L.rows and not any(r.gate_eligible() for r in L.rows)
    flags = {f for r in L.rows for f in r.flags}
    assert "partial" in flags and "variant:watcher" in flags


def test_parsed_null_driver_capture_is_a_gap_not_a_row(tmp_path):
    _write(tmp_path, "GPU_BENCH_r04.json", {"rc": 0, "tail": "truncated…",
                                            "parsed": None})
    L = ld.load(str(tmp_path))
    assert L.rows == []
    assert any("r4 failure" in p["note"] for p in L.problems)


def test_damaged_artifact_is_a_problem_never_a_raise(tmp_path):
    (tmp_path / "GPU_BENCH_FULL_r01.json").write_text('{"metric": "x", "val')
    L = ld.load(str(tmp_path))
    assert L.rows == []
    assert any("not valid JSON" in p["note"] for p in L.problems)


def test_committed_history_ingests_with_known_gaps_only(gpu_tree):
    L = ld.load(gpu_tree)
    assert len(L.rows) >= 20, "committed artifacts should yield a trajectory"
    gap_sources = {p["source"] for p in L.problems}
    # the two known headline losses stay visible as gaps
    assert {"GPU_BENCH_r01.json", "GPU_BENCH_r04.json"} <= gap_sources
    # every row's provenance fields are populated enough to key on
    for r in L.rows:
        assert r.run.startswith("r") and r.metric and r.source


# ----------------------------------------------------------- gate CLI ----

def test_gate_fails_on_injected_regression(regressed_pair, capsys):
    rc = cli_main(["ledger", "gate", "--offline",
                   "--root", str(regressed_pair), "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 1
    assert "regression" in out.out and "GATE FAILED" in out.err


def test_gate_passes_on_statistically_identical_runs(clean_pair, capsys):
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root",
                        str(clean_pair)]))
    assert rc == 0
    assert "gate PASSED" in capsys.readouterr().out


def test_gate_fails_on_unexplained_memory_growth(clean_pair, capsys):
    _write(clean_pair, "GPU_TELEMETRY_r01.json", _telemetry("r01", 1_000_000))
    _write(clean_pair, "GPU_TELEMETRY_r02.json", _telemetry("r02", 2_000_000))
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root",
                        str(clean_pair)]))
    assert rc == 1
    assert "memory-growth" in capsys.readouterr().out


def test_gate_tolerates_in_band_memory_drift(clean_pair, capsys):
    _write(clean_pair, "GPU_TELEMETRY_r01.json", _telemetry("r01", 1_000_000))
    _write(clean_pair, "GPU_TELEMETRY_r02.json", _telemetry("r02", 1_050_000))
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root",
                        str(clean_pair)]))
    assert rc == 0


def test_gate_warns_on_gate_pairable_rows_without_samples(clean_pair,
                                                          capsys):
    """A gate-pairable metric without its bootstrap samples is named by
    the gate: its verdicts can only ever be point-delta.  Sampled metrics
    stay out of the warning."""
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root",
                        str(clean_pair)]))
    out = capsys.readouterr().out
    assert rc == 0
    assert "sample-coverage gaps" in out
    gap_block = out.split("sample-coverage gaps")[1]
    # the headline metric carries no samples entry -> warned
    assert "intraday_event_backtest_bar_groups_per_sec" in gap_block
    # the sampled grid wall must NOT be named a gap
    assert "grid16_rank_s" not in gap_block


def test_gate_passes_on_the_committed_artifact_history(gpu_tree, capsys):
    """Over the renamed history the gate passes (point-delta drifts may
    be suspect but are never confirmed without samples), and
    GPU_BENCH_r04.json stays surfaced as the known gap."""
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root", gpu_tree]))
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "gate PASSED" in out
    assert "GPU_BENCH_r04.json" in out  # the known gap stays surfaced


def test_diff_reports_bootstrap_cis_not_bare_deltas(regressed_pair, capsys):
    rc = cli_main(_cpu(["ledger", "diff", "r01", "r02",
                        "--root", str(regressed_pair)]))
    out = capsys.readouterr().out
    assert rc == 0
    # every sampled metric shows an interval and the sample count
    line = next(ln for ln in out.splitlines() if "grid16_rank_s" in ln
                and "regression" in ln)
    assert line
    assert "[0." in out and "(n=8)" in out
    assert "bootstrap-ci" in out


def test_diff_unknown_run_is_a_pointed_error(clean_pair, capsys):
    rc = cli_main(_cpu(["ledger", "diff", "r01", "r99",
                        "--root", str(clean_pair)]))
    err = capsys.readouterr().err
    assert rc == 2
    assert "r99" in err and "known runs" in err


def test_show_markdown_emits_tables(gpu_tree, capsys):
    rc = cli_main(["ledger", "show", "--markdown", "--root", gpu_tree,
                   "--metric", "grid16_rank_s"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "| run | value | platform |" in out
    assert "`GPU_BENCH_FULL_r05.json`" in out
    assert f"{PROG} ledger show --markdown" in out  # provenance comment


def test_show_empty_root_is_a_pointed_error(tmp_path, capsys):
    rc = cli_main(["ledger", "show", "--root", str(tmp_path)])
    assert rc == 2
    assert "no round artifacts" in capsys.readouterr().err


def test_bare_ledger_prints_usage(capsys):
    assert cli_main(["ledger"]) == 2
    assert f"{PROG} ledger {{show,roadmap,diff,gate}}" in \
        capsys.readouterr().err


def test_ledger_refuses_unknown_schema_telemetry(tmp_path):
    """A future-era sidecar is not half-parsed into gate-eligible rows:
    it becomes a named problem, and other artifacts still ingest."""
    obj = _telemetry("r01", 100)
    obj["schema_version"] = 99
    _write(tmp_path, "GPU_TELEMETRY_r01.json", obj)
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", _full_record(REF_SAMPLES))
    L = ld.load(str(tmp_path))  # must not raise
    assert not any(r.metric == "mem_peak_bytes" for r in L.rows)
    assert any("unknown telemetry schema_version 99" in p["note"]
               for p in L.problems)
    assert any(r.metric == "grid16_rank_s" for r in L.rows)


# -------------------------------------------------- schema round-trips ----

def test_samples_schema_validated_in_records():
    good = _full_record(REF_SAMPLES)
    assert inv.validate(good, "record") == []
    assert inv.validate(good) == []
    bad = _full_record(REF_SAMPLES)
    bad["extra"]["samples"]["grid16_rank_s"] = ["0.1", 0.2]
    assert any("samples" in v for v in inv.validate(bad, "record"))
    bad2 = _full_record(REF_SAMPLES)
    bad2["extra"]["samples"] = [0.1, 0.2]
    assert any("samples" in v for v in inv.validate(bad2, "record"))


def test_telemetry_memory_block_schema():
    good = _telemetry("r01", 1000)
    assert inv.validate(good, "telemetry") == []
    bad = _telemetry("r01", 1000)
    bad["metrics"]["memory"]["grid.jk16.rank.kernel@512x3780"].pop(
        "peak_bytes")
    assert any("peak_bytes" in v for v in inv.validate(bad, "telemetry"))
    bad2 = _telemetry("r01", 1000)
    bad2["metrics"]["memory"]["x"] = {"peak_bytes": 1,
                                      "argument_size_in_bytes": "lots"}
    assert any("argument_size_in_bytes" in v
               for v in inv.validate(bad2, "telemetry"))
    # a capture-failure reason string is a legitimate per-shape value
    ok = _telemetry("r01", 1000)
    ok["metrics"]["memory"]["y"] = "not available: a CPU call"
    assert inv.validate(ok, "telemetry") == []


# -------------------------------------------- review-hardening pins ----

def test_null_in_sample_list_degrades_never_raises(tmp_path):
    rec = _full_record(REF_SAMPLES)
    rec["extra"]["samples"]["grid16_rank_s"] = [0.1, None, "x", 0.2, True]
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", rec)
    L = ld.load(str(tmp_path))
    row = next(r for r in L.rows if r.metric == "grid16_rank_s")
    assert row.samples == (0.1, 0.2)  # null/str/bool dropped, no raise


def test_pid_suffixed_sidecar_is_a_variant_not_round_evidence(tmp_path):
    """An operator rerun's GPU_TELEMETRY_rNN-<pid>.json ingests flagged,
    never gate-eligible."""
    assert ld.run_of("GPU_TELEMETRY_r05-1234.json") == ("r05", 5, "1234")
    assert ld.run_of("GPU_TELEMETRY_r05.json") == ("r05", 5, None)
    _write(tmp_path, "GPU_TELEMETRY_r01.json", _telemetry("r01", 1_000_000))
    _write(tmp_path, "GPU_TELEMETRY_r01-999.json",
           _telemetry("r01", 9_999_999))
    L = ld.load(str(tmp_path))
    mem = [r for r in L.rows if r.metric == "mem_peak_bytes"]
    eligible = [r for r in mem if r.gate_eligible()]
    assert len(eligible) == 1 and eligible[0].value == 1_000_000
    rerun = next(r for r in mem if r.value == 9_999_999)
    assert "variant:999" in rerun.flags


def test_gate_bad_candidate_id_is_a_pointed_error(clean_pair, capsys):
    rc = cli_main(_cpu(["ledger", "gate", "--root", str(clean_pair),
                        "--candidate", "rx1"]))
    err = capsys.readouterr().err
    assert rc == 2
    assert "not a run id" in err


def test_diff_refuses_cross_provenance_pairing(tmp_path, capsys):
    """A session/variant row never diffs against a live row of another
    run."""
    _write(tmp_path, "GPU_BENCH_TPU_r01_session.json",
           _full_record(REF_SAMPLES, platform="gpu"))
    _write(tmp_path, "GPU_BENCH_FULL_r02.json",
           _full_record(REF_SAMPLES_B, platform="gpu"))
    rc = cli_main(_cpu(["ledger", "diff", "r01", "r02", "--root",
                        str(tmp_path)]))
    cap = capsys.readouterr()
    assert "[skip]" in cap.out and "incomparable provenance" in cap.out
    assert "regression" not in cap.out and "improvement" not in cap.out
    assert rc == 1  # nothing comparable survived


def test_diff_pairs_like_for_like_when_both_sides_share_a_flagset(tmp_path,
                                                                  capsys):
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", _full_record(REF_SAMPLES))
    _write(tmp_path, "GPU_BENCH_FULL_r01_watcher.json",
           _full_record(REF_SAMPLES))
    _write(tmp_path, "GPU_BENCH_FULL_r02_watcher.json",
           _full_record(BAD_SAMPLES))
    rc = cli_main(_cpu(["ledger", "diff", "r01", "r02", "--root",
                        str(tmp_path)]))
    out = capsys.readouterr().out
    assert rc == 0
    line = next(ln for ln in out.splitlines()
                if "grid16_rank_s" in ln and "regression" in ln)
    assert line  # the watcher-vs-watcher 3x regression was examined


def test_gate_reports_vanished_metrics(tmp_path, capsys):
    r1 = _full_record(REF_SAMPLES)
    r1["extra"]["grid16_qcut_s"] = 0.25
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", r1)
    r2 = _full_record(REF_SAMPLES_B)
    r2["extra"]["grid16_qcut_s"] = "failed: RuntimeError: boom"
    _write(tmp_path, "GPU_BENCH_FULL_r02.json", r2)
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root",
                        str(tmp_path)]))
    out = capsys.readouterr().out
    assert rc == 0  # not confirmable without a number...
    assert "1 vanished" in out  # ...but loudly visible
    assert "grid16_qcut_s" in out and "last measured r01" in out


def test_bool_peak_bytes_rejected_everywhere():
    bad = _telemetry("r01", 1000)
    bad["metrics"]["memory"]["grid.jk16.rank.kernel@512x3780"][
        "peak_bytes"] = True
    assert any("peak_bytes" in v for v in inv.validate(bad, "telemetry"))
    rows = ld._telemetry_rows(bad, "r01", 1, None, "GPU_TELEMETRY_r01.json")
    assert not any(r.metric == "mem_peak_bytes" for r in rows)


def test_histrank_multihost_records_are_info_never_gated(gpu_tree):
    """Record-shaped captures outside the bench family ride as info rows;
    serve, replay, trace and fleet rows gate."""
    L = ld.load(gpu_tree)
    other = [r for r in L.rows
             if not r.source.startswith(("GPU_BENCH", "GPU_TELEMETRY",
                                         "GPU_SERVE", "GPU_REPLAY",
                                         "GPU_TRACE", "GPU_FLEET"))]
    assert other, "the renamed HISTRANK/MULTIHOST should yield info rows"
    assert all("info" in r.flags and not r.gate_eligible() for r in other)
    for family in ("GPU_REPLAY", "GPU_SERVE", "GPU_TRACE", "GPU_FLEET"):
        rows = [r for r in L.rows if r.source.startswith(family)]
        assert rows and any(r.gate_eligible() for r in rows), family


def test_top_level_partial_marker_flags_rows(tmp_path):
    rec = _full_record(REF_SAMPLES)
    rec["partial"] = "deadline hit before the grid legs"
    _write(tmp_path, "GPU_BENCH_FULL_r01.json", rec)
    L = ld.load(str(tmp_path))
    assert L.rows and all("partial" in r.flags for r in L.rows)
    assert not any(r.gate_eligible() for r in L.rows)


def test_modeled_and_measured_peaks_never_share_a_key(tmp_path):
    t1 = _telemetry("r01", 150)
    t1["metrics"]["memory"]["grid.jk16.rank.kernel@512x3780"][
        "peak_source"] = "model: argument+output+temp"
    t2 = _telemetry("r02", 220)
    t2["metrics"]["memory"]["grid.jk16.rank.kernel@512x3780"][
        "peak_source"] = "peak_memory_in_bytes"
    _write(tmp_path, "GPU_TELEMETRY_r01.json", t1)
    _write(tmp_path, "GPU_TELEMETRY_r02.json", t2)
    L = ld.load(str(tmp_path))
    mem = [r for r in L.rows if r.metric == "mem_peak_bytes"]
    assert len({r.key() for r in mem}) == 2
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root",
                        str(tmp_path)]))
    assert rc == 0  # first-seen on the measured key, no spurious growth


def test_valueless_phases_artifact_is_a_named_problem(gpu_tree):
    L = ld.load(gpu_tree)
    assert any(p["source"] == "GPU_PHASES_CPU_r04.json"
               and "no numeric value axis" in p["note"]
               for p in L.problems)


def test_damaged_full_record_does_not_suppress_healthy_headline(tmp_path):
    (tmp_path / "GPU_BENCH_FULL_r01.json").write_text('{"metric": "x", "val')
    _write(tmp_path, "GPU_BENCH_r01.json", {
        "n": 1, "cmd": "bench", "rc": 0, "tail": "{}",
        "parsed": _full_record(REF_SAMPLES),
    })
    L = ld.load(str(tmp_path))
    assert any(r.metric == "grid16_rank_s"
               and r.source == "GPU_BENCH_r01.json" for r in L.rows)
    assert any("not valid JSON" in p["note"] for p in L.problems)


def test_variant_driver_capture_survives_canonical_full_dedup(tmp_path):
    _write(tmp_path, "GPU_BENCH_FULL_r05.json", _full_record(REF_SAMPLES))
    _write(tmp_path, "GPU_BENCH_r05_watcher.json", {
        "n": 5, "cmd": "bench", "rc": 0, "tail": "{}",
        "parsed": _full_record(BAD_SAMPLES),
    })
    L = ld.load(str(tmp_path))
    watcher = [r for r in L.rows if r.source == "GPU_BENCH_r05_watcher.json"]
    assert watcher and all("variant:watcher" in r.flags for r in watcher)
    # the canonical headline (same run, no variant) still defers to FULL
    _write(tmp_path, "GPU_BENCH_r05.json", {
        "n": 5, "cmd": "bench", "rc": 0, "tail": "{}",
        "parsed": _full_record(REF_SAMPLES_B),
    })
    L2 = ld.load(str(tmp_path))
    assert not any(r.source == "GPU_BENCH_r05.json" for r in L2.rows)


def test_unstamped_memory_stats_never_become_rows(tmp_path):
    bad = _telemetry("r01", 1000)
    bad["metrics"]["memory"]["grid.jk16.rank.kernel@512x3780"].pop(
        "platform")
    assert any("platform" in v for v in inv.validate(bad, "telemetry"))
    rows = ld._telemetry_rows(bad, "r01", 1, None, "GPU_TELEMETRY_r01.json")
    assert not any(r.metric == "mem_peak_bytes" for r in rows)


def test_point_verdict_reports_true_sample_counts():
    v = regress.compare(0.24, 0.10, cand_samples=[0.24, 0.25, 0.23],
                        ref_samples=None, direction="lower")
    assert v["candidate"]["n"] == 3 and v["reference"]["n"] == 1


def test_gate_surfaces_compounding_subtolerance_drift(tmp_path, capsys):
    for i, peak in enumerate((1_000_000, 1_090_000, 1_190_000), start=1):
        _write(tmp_path, f"GPU_TELEMETRY_r{i:02d}.json",
               _telemetry(f"r{i:02d}", peak))
    rc = cli_main(_cpu(["ledger", "gate", "--offline", "--root",
                        str(tmp_path)]))
    out = capsys.readouterr().out
    assert rc == 0  # each step is inside --mem-tol: accepted per round
    assert "cumulative drift since r01" in out  # ...but never hidden


# ------------------------------------------------ roadmap round-update ----

def test_splice_roadmap_replaces_the_marker_span_only():
    from csmom_tpu_torch.cli.ledger import (
        ROADMAP_BEGIN,
        ROADMAP_END,
        splice_roadmap,
    )

    doc = (f"# head\nprose stays\n\n{ROADMAP_BEGIN}\n\nOLD TABLES\n\n"
           f"{ROADMAP_END}\ntail stays\n")
    new = splice_roadmap(doc, "#### fresh table")
    assert "OLD TABLES" not in new
    assert "#### fresh table" in new
    assert new.startswith("# head\nprose stays")
    assert new.endswith(f"{ROADMAP_END}\ntail stays\n")
    # idempotent: splicing the same tables changes nothing
    assert splice_roadmap(new, "#### fresh table") == new


def test_splice_roadmap_refuses_missing_or_misordered_markers():
    from csmom_tpu.cli import ledger as ref_cli
    from csmom_tpu_torch.cli.ledger import (
        ROADMAP_BEGIN,
        ROADMAP_END,
        splice_roadmap,
    )

    with pytest.raises(ValueError, match="markers missing"):
        splice_roadmap("no markers here", "t")
    with pytest.raises(ValueError, match="markers missing"):
        splice_roadmap(f"{ROADMAP_END}\n{ROADMAP_BEGIN}", "t")
    # the JAX package's markers are not the port's
    with pytest.raises(ValueError, match="markers missing"):
        splice_roadmap(f"{ref_cli.ROADMAP_BEGIN}\nx\n{ref_cli.ROADMAP_END}",
                       "t")


def test_roadmap_rows_filter_keeps_gate_pairable_metrics_only():
    from csmom_tpu_torch.cli.ledger import roadmap_rows
    from csmom_tpu_torch.obs.ledger import Row

    def row(metric, flags=()):
        return Row(run="r01", run_num=1, metric=metric, value=1.0,
                   unit="s", direction="lower", platform="gpu",
                   device_kind="gpu", workload="w", source="S_r01.json",
                   flags=tuple(flags))

    rows = [row("grid16_rank_s"),
            row("grid16_rank_s", ("variant:watcher",)),  # kept: has a live row
            row("phase.row_s", ("info",)),               # pure info: dropped
            row("mem_peak_bytes")]                       # per-shape: dropped
    kept = {(r.metric, r.flags) for r in roadmap_rows(rows)}
    assert kept == {("grid16_rank_s", ()),
                    ("grid16_rank_s", ("variant:watcher",))}


def test_roadmap_write_regenerates_the_ports_span(gpu_tree, tmp_path,
                                                  capsys):
    """The round-update flow on the port's markers: ``roadmap --write``
    splices the tables ``show --markdown`` renders, equal to the JAX
    package's tables over the same history but for the names, a second
    run finds them current, and the text around the span is kept."""
    from csmom_tpu.cli import ledger as ref_cli
    from csmom_tpu_torch.cli.ledger import (
        ROADMAP_BEGIN,
        ROADMAP_END,
        _markdown_tables,
        roadmap_rows,
    )

    doc = tmp_path / "TRAJECTORY.md"
    doc.write_text(f"# H100\n\n{ROADMAP_BEGIN}\nstale\n{ROADMAP_END}\n"
                   "tail\n")
    argv = ["ledger", "roadmap", "--root", gpu_tree, "--roadmap", str(doc)]
    assert cli_main(argv) == 0                      # dry run
    assert doc.read_text().count("stale") == 1
    assert cli_main(argv + ["--write"]) == 0
    assert "regenerated the trajectory tables" in capsys.readouterr().out
    text = doc.read_text()
    tables = _markdown_tables(roadmap_rows(ld.load(gpu_tree).rows))
    assert text == (f"# H100\n\n{ROADMAP_BEGIN}\n\n{tables}\n\n"
                    f"{ROADMAP_END}\ntail\n")
    ref_tables = ref_cli._markdown_tables(
        ref_cli.roadmap_rows(ref_ld.load(_REPO).rows))
    assert _as_reference_text(tables) == ref_tables
    assert cli_main(argv + ["--write"]) == 0
    assert "already current" in capsys.readouterr().out
    assert doc.read_text() == text


def test_observatory_armed_is_a_footnote_not_a_flag(tmp_path):
    with open(os.path.join(_REPO, "SERVE_FABRIC_r20.json")) as f:
        base = json.load(f)
    armed = json.loads(json.dumps(base))
    armed["run_id"] = "r91"
    armed["extra"]["observatory_armed"] = True
    disarmed = json.loads(json.dumps(base))
    disarmed["run_id"] = "r90"
    disarmed["extra"]["observatory_armed"] = False
    _write(tmp_path, "GPU_SERVE_FABRIC_r90.json", disarmed)
    _write(tmp_path, "GPU_SERVE_FABRIC_r91.json", armed)
    L = ld.load(str(tmp_path))
    lat = {r.run: r for r in L.rows if r.metric == "serve_fabric_p50_ms"}
    assert lat["r91"].notes == ("observatory-armed",)
    assert lat["r90"].notes == ()
    # a footnote, not a flag: gating and pairing are unaffected
    assert lat["r91"].gate_eligible() and lat["r90"].gate_eligible()
    assert lat["r91"].key() == lat["r90"].key()
    assert lat["r91"].flags == ()
    thr = [r for r in L.rows
           if r.metric == "serve_fabric_throughput_rps" and r.run == "r91"]
    assert thr and thr[0].notes == ()


def test_verdict_printer_surfaces_note_asymmetry(capsys):
    from csmom_tpu_torch.cli.ledger import _print_verdict

    def row(run, num, notes):
        return ld.Row(run=run, run_num=num, metric="serve_fabric_p50_ms",
                      value=30.0 if num == 1 else 45.0, unit="ms",
                      direction="lower", platform="gpu",
                      device_kind="gpu", workload="w",
                      source=f"S_{run}.json", notes=notes)

    ref, cand = row("r01", 1, ()), row("r02", 2, ("observatory-armed",))
    v = regress.compare_points(cand.value, ref.value, direction="lower",
                               suspect_rel=0.05, reason="test")
    _print_verdict(cand, ref, v)
    out = capsys.readouterr().out
    assert "note[observatory-armed]: r02 only" in out
    assert "documented cost" in out


# ======================================================= the port's own cases

def test_diff_and_gate_without_device_cpu_give_the_no_card_error(
        regressed_pair, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error, which a machine with a card "
                    "never gives")
    for argv in (["ledger", "diff", "r01", "r02"],
                 ["ledger", "gate", "--offline"],
                 ["ledger", "gate", "--offline", "--device", "cuda"]):
        assert cli_main(argv + ["--root", str(regressed_pair)]) == 2
        cap = capsys.readouterr()
        assert cap.out == ""
        assert "no CUDA device is available; pass --device cpu" in cap.err
    # show and roadmap take no --device and are not probed
    assert cli_main(["ledger", "show", "--root", str(regressed_pair)]) == 0
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        regress.bootstrap_mean_ci(REF_SAMPLES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        regress.compare(1.0, 1.0, cand_samples=REF_SAMPLES,
                        ref_samples=REF_SAMPLES)


def test_roadmap_refuses_roadmap_md_and_leaves_it_unchanged(gpu_tree,
                                                            capsys):
    path = os.path.join(_REPO, "ROADMAP.md")
    with open(path, "rb") as f:
        before = f.read()
    for extra in ([], ["--write"]):
        rc = cli_main(["ledger", "roadmap", "--root", gpu_tree,
                       "--roadmap", path, *extra])
        err = capsys.readouterr().err
        assert rc == 1
        assert "markers missing or misordered" in err
        assert "gpu-trajectory-tables:begin" in err
    with open(path, "rb") as f:
        assert f.read() == before


def test_the_port_never_reads_a_jax_named_file(tmp_path, capsys):
    """``SERVE_r01.json`` is the reference's name: the port's ledger does
    not see it, and the reference's does not see ``GPU_SERVE_r02.json``."""
    with open(os.path.join(_REPO, "SERVE_r14.json")) as f:
        art = json.load(f)
    _write(tmp_path, "SERVE_r01.json", dict(art, run_id="r01"))
    _write(tmp_path, "GPU_SERVE_r02.json", dict(art, run_id="r02"))
    _write(tmp_path, "BENCH_FULL_r03.json", _full_record(REF_SAMPLES))
    port, ref = ld.load(str(tmp_path)), ref_ld.load(str(tmp_path))
    assert {r.source for r in port.rows} == {"GPU_SERVE_r02.json"}
    assert {r.source for r in ref.rows} == {"SERVE_r01.json",
                                            "BENCH_FULL_r03.json"}
    assert port.problems == []
    assert all(p.startswith("GPU_") for p in ld.DEFAULT_PATTERNS)
    assert [p[len("GPU_"):] for p in ld.DEFAULT_PATTERNS] == \
        list(ref_ld.DEFAULT_PATTERNS)


def test_show_and_gate_over_the_repo_root_give_the_pointed_error(capsys):
    """The repository root holds the JAX package's artifacts only: the
    port finds no round artifact there and says so, never an empty
    pass."""
    for argv in (["ledger", "show"], ["ledger", "gate", "--offline",
                                      "--device", "cpu"],
                 ["ledger", "diff", "r01", "r02", "--device", "cpu"]):
        assert cli_main(argv + ["--root", _REPO]) == 2
        err = capsys.readouterr().err
        assert "no round artifacts (GPU_BENCH_*/" in err


def test_show_prints_the_references_table(gpu_tree, capsys, monkeypatch):
    for extra in ([], ["--run", "r20"], ["--metric", "serve_p99"],
                  ["--markdown", "--metric", "fleet"]):
        ref = _run(ref_main, ["ledger", "show", "--root", _REPO, *extra],
                   _REPO, capsys, monkeypatch)
        port = _run(cli_main, ["ledger", "show", "--root", gpu_tree, *extra],
                    gpu_tree, capsys, monkeypatch)
        assert port[0] == ref[0] == 0
        assert _as_reference_text(port[1]) == ref[1]


def test_the_ledger_modules_are_in_the_wall_free_tier_and_sweep_clean():
    from csmom_tpu.analysis.rules import ClockDiscipline as RefClock
    from csmom_tpu_torch.analysis import run_lint
    from csmom_tpu_torch.analysis.rules import ClockDiscipline

    ours = set(ClockDiscipline.WALL_FREE_FILES)
    theirs = {p.replace("csmom_tpu/", "csmom_tpu_torch/", 1)
              for p in RefClock.WALL_FREE_FILES}
    assert ours == theirs
    files = [os.path.join(_REPO, "csmom_tpu_torch", rel) for rel in
             ("obs/ledger.py", "obs/regress.py", "cli/ledger.py")]
    rep = run_lint(paths=files, repo=_REPO)
    assert rep.findings == []
