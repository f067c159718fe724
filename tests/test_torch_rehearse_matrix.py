"""The port's ``rehearse`` matrix and check functions against the reference's.

``csmom_tpu_torch.cli.rehearse`` ships the reference's 29 scenarios in
its order, with the reference's names, pipelines, plans, environments,
fast flags, row counts and budgets.  The notes of the 17 scenarios of
the serving, replay and warm-up tiers are the reference's (less its
leading "<LABEL> <n>: " tags); the 12 of the capture tier (mini, shell,
bench-child, bench) say what they rehearse in the port's own words.
Every check function returns the reference's violations on the same
result dict; those that differ are pinned where they differ: the
version-skew refusal names the port's remedy, on the card the warm-up
check also wants a heal and both kernels launched, the killed bench
child is retried on the same device, and a probe outage is the
last-resort line and exit 1 (ROADMAP.md known differences 67, 68 and 72).
"""

import dataclasses
import os
import re
import subprocess
import sys

import pytest

from csmom_tpu.cli import rehearse as ref
from csmom_tpu_torch.cli import rehearse as port
from csmom_tpu_torch.serve.health import BUILD_POINTER

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the capture tier's pipelines (ported with the bench tooling)
_CAPTURE = {"mini", "shell", "bench", "bench-child"}


def _plain(v):
    """Scenario environments as comparable data: an SLO policy as its
    classes' fields, tuples as lists."""
    if hasattr(v, "classes") and hasattr(v, "resolve"):
        return [dataclasses.asdict(c) for c in v.classes]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _notes(text):
    return re.sub(r"^[A-Z]+ \d+: ", "", text)


def _row(s):
    notes = None if s.pipeline in _CAPTURE else _notes(s.notes)
    return (s.name, s.pipeline, s.fast,
            s.plan.to_toml() if s.plan is not None else None,
            _plain(s.env), getattr(s, "rows", 6), getattr(s, "budget_s", None),
            notes)


@pytest.mark.parametrize("fast", [False, True])
def test_matrix_equals_the_references_ported_tiers(fast):
    mine = port.builtin_matrix(fast=fast)
    theirs = ref.builtin_matrix(fast=fast)
    assert [_row(s) for s in mine] == [_row(s) for s in theirs]
    assert len(mine) == (16 if fast else 29)
    if fast:
        assert {s.pipeline for s in mine} == {"mini", "shell", "serve",
                                             "serve-pool", "replay"}
    for s in mine:
        if s.pipeline in _CAPTURE:
            assert s.notes and not re.search(r"tun{2}el|\br\d\b", s.notes), s.name


def test_the_absent_scenarios_are_the_twelve_of_the_unported_tiers():
    """None is absent any more: the twelve scenarios of the capture tier
    are in the matrix, and every pipeline has a runner."""
    mine = {s.name for s in port.builtin_matrix()}
    absent = [s for s in ref.builtin_matrix() if s.name not in mine]
    assert absent == []
    assert len([s for s in port.builtin_matrix() if s.pipeline in _CAPTURE]) == 12
    assert not hasattr(port, "UNPORTED_PIPELINES")
    assert {s.pipeline for s in port.builtin_matrix()} == set(port._RUNNERS)
    assert set(port._RUNNERS) == set(ref._RUNNERS)
    assert set(port._CUSTOM_CHECKS) == set(ref._CUSTOM_CHECKS)


def test_plan_summaries_equal_the_references():
    theirs = {s.name: ref._plan_summary(s.plan) for s in ref.builtin_matrix()}
    for s in port.builtin_matrix():
        assert port._plan_summary(s.plan) == theirs[s.name], s.name


def _cli(args, timeout=120, env=None):
    return subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "rehearse", *args],
        capture_output=True, text=True, timeout=timeout, cwd=_REPO,
        env={**os.environ, "PYTHONPATH": _REPO, **(env or {})})


def test_list_prints_every_ported_scenario_with_its_plan():
    p = _cli(["--list"])
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    matrix = port.builtin_matrix()
    assert len(lines) == 2 * len(matrix)
    for i, s in enumerate(matrix):
        assert lines[2 * i].startswith(s.name)
        tier = "fast" if s.fast else "full"
        assert f" [{tier}] " in lines[2 * i]
        assert lines[2 * i + 1].endswith("plan: " + ref._plan_summary(s.plan))


@pytest.mark.parametrize("pipeline,item", [
    ("bench", "8b"), ("bench-child", "8b"), ("shell", "8b"), ("mini", "8c")])
def test_an_unported_pipeline_exits_2_naming_its_item(pipeline, item):
    """The capture tier's pipelines are ported (items 8b and 8c):
    ``--pipeline`` names one without exit 2, and, as in the reference, it
    only picks the pipeline a custom ``--plan`` drives; ``shell``, whose
    faults are environment-driven, takes no custom plan (exit 2)."""
    p = _cli(["--pipeline", pipeline, "--list"], timeout=60)
    assert p.returncode == 0, p.stderr
    assert len(p.stdout.splitlines()) == 2 * 29
    assert "is not ported" not in p.stderr and f"item {item}" not in p.stderr
    plan = 'name = "x"\nseed = 1\n\n[[fault]]\npoint = "mini.row"\naction = "sleep"\n'
    p = _cli(["--plan", plan, "--pipeline", pipeline, "--list"], timeout=60)
    if pipeline == "shell":
        assert p.returncode == 2
        assert "--pipeline shell does not take a custom plan" in p.stderr
    else:
        assert p.returncode == 0, p.stderr
        assert p.stdout.startswith("x ") and f" {pipeline} " in p.stdout


def test_the_warmup_scenario_needs_a_card_or_device_cpu():
    """Without a card (this machine) a matrix holding the warm-up exits 2
    before any scenario runs, naming --device cpu; the stub-only matrix
    of --list needs none."""
    for args in (["--only", "corrupt-aot-cache"], []):
        p = _cli(args, timeout=60)
        assert p.returncode == 2, p.stdout + p.stderr
        assert "--device cpu" in p.stderr
        assert "rehearsing" not in p.stdout
    assert _cli(["--list", "--only", "corrupt"]).returncode == 0


def test_a_custom_plan_whose_check_cannot_hold_exits_1(tmp_path):
    """A plan that kills the armed warm-up process at its first entry
    leaves no summary line: the generic check cannot hold, and rehearse
    fails loudly."""
    plan = tmp_path / "kill.toml"
    plan.write_text('name = "kill-warmup"\nseed = 1\n\n[[fault]]\n'
                    'point = "warmup.entry"\naction = "kill"\n')
    p = _cli(["--plan", str(plan), "--pipeline", "warmup", "--device", "cpu",
              "--sandbox", str(tmp_path / "box")], timeout=300,
             env={"CSMOM_TELEMETRY_DIR": str(tmp_path / "telemetry")})
    assert p.returncode == 1, p.stdout + p.stderr
    assert "[FAIL] kill-warmup" in p.stdout
    assert "warmup printed no summary line" in p.stdout
    assert "0/1 scenarios green" in p.stdout


def test_a_lint_finding_refuses_the_rehearsal(monkeypatch, capsys):
    """The whole-project lint sweep gates the start: a finding, and no
    scenario runs."""
    from csmom_tpu_torch.cli.main import build_parser

    def no_run(*a, **k):
        raise AssertionError("a scenario ran past a lint finding")

    monkeypatch.setattr(port, "_lint_gate", lambda: ["x.py:1: [rule] finding"])
    monkeypatch.setattr(port, "_run_scenario", no_run)
    args = build_parser().parse_args(["rehearse", "--fast"])
    assert port.cmd_rehearse(args) == 1
    err = capsys.readouterr().err
    assert "refusing to rehearse" in err and "x.py:1: [rule] finding" in err


# ----------------------------------------------------- check functions ----

# the reference's round labels in its violation texts, in the port's words
_WORDS = ((r"the \w+ empty-record failure", "the empty-record failure"),)


def _violations(call):
    """``call(module)`` for the port's and the reference's rehearse, the
    reference's texts in the port's words."""
    theirs = call(ref)
    for pat, repl in _WORDS:
        theirs = [re.sub(pat, repl, v) for v in theirs]
    return call(port), theirs


_SERVE_ART = {"kind": "serve", "requests": {"admitted": 3, "served": 3,
                                             "rejected": 0, "expired": 0}}


# a runner's result dict with nothing landed, a record and a partial
_BASE = {"headline_violations": [], "trailing": None, "sidecar_rows": 0,
         "rc": 0}
_REC = {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0,
        "extra": {"rows": [1, 2]}}
_PART = {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0,
         "extra": {"rows": [1], "partial": "deadline hit"}}


# (check name, result dicts: an empty one, then one a branch each)
_CASES = {
    "_check_serve_worker_crash": [
        {}, {"artifact": {**_SERVE_ART, "batches": {"count": 1}}},
        {"artifact": {"requests": {"rejected_worker_crash": 2, "served": 1},
                      "batches": {"count": 3}}}],
    "_check_serve_deadline_storm": [
        {}, {"artifact": {"requests": {"expired": 4}}}],
    "_check_serve_burst_storm": [
        {}, {"artifact": {"classes": {
            "bulk": {"rejected_quota": 3, "latency_ms": {"p99": 10.0}},
            "interactive": {"served": 4, "admitted": 5,
                            "latency_ms": {"p99": 400.0}}}}},
        {"artifact": {"classes": {
            "bulk": {"rejected_quota": 3},
            "interactive": {"served": 5, "admitted": 5,
                            "within_budget": True}}}}],
    "_check_serve_cache_poison": [
        {}, {"artifact": {"cache": {"hits": 3, "stale_blocked": 1,
                                    "stale_hits": 2}}}],
    "_check_pool_worker_kill": [
        {}, {"artifact": {"pool": {"kills": 1},
                          "requests": {"worker_conn_failures": 2,
                                       "served": 9},
                          "availability": 0.95}}],
    "_check_trace_stitch_worker_kill": [
        {}, {"trace_book_violations": ["books open"],
             "trace_artifact": {"orphans": {"count": 2,
                                            "reasons": {"timeout": 2}},
                                "stages": {"transport": {}},
                                "books": {"complete": 3}}},
        {"trace_artifact": {"orphans": {"count": 1, "reasons": {
            "connection reset": 1}}}}],
    "_check_fleet_capture_worker_kill": [
        {}, {"artifact": {"pool": {"n_workers": 2}},
             "fleet_artifact": {
                 "series": {"processes": {"w0": {"close_reason": "severed"}}},
                 "lifecycle": {"ready_walls_s": [1.0, 1.1, 1.2]},
                 "capacity": {"kill_windows": [{}],
                              "kill_window_loss_frac": 0.3},
                 "demand": {"classes": {"standard": {}}}}}],
    "_check_spare_promote_on_kill": [
        {}, {"fleet_artifact": {
            "elastic": {"promotions": [{"wall_s": 2.0}, {"wall_s": 0.1}],
                        "promotions_missed": 1, "spare_ids": ["s0"]},
            "capacity": {"kill_window_loss_frac": 0.5,
                         "kill_windows": [{"worker_id": "s0"}]},
            "lifecycle": {"events": [{"worker_id": "w1"}]}}}],
    "_check_pool_rolling_restart": [
        {}, {"roll": {"aborted": "a replacement never became ready",
                      "rolled": ["w0"]},
             "artifact": {"pool": {"n_workers": 2},
                          "compile": {"in_window_fresh_compiles": 1},
                          "availability": 0.5}}],
    "_check_mesh_pinned_worker_kill": [
        {}, {"artifact": {"pool": {"kills": 1, "restarts": 1, "events": [
            {"event": "spawn", "worker_id": "w0", "device_slice": "0:2"},
            {"event": "spawn", "worker_id": "w0", "device_slice": "2:2"},
            {"event": "spawn", "worker_id": "w1", "device_slice": None}]},
            "compile": {"in_window_fresh_compiles": 2}}}],
    "_check_fabric_partition": [
        {}, {"artifact": {"routers": {"replicas": [
            {"accounting": {"worker_conn_failures": 2}}]},
            "requests": {"served": 4}, "availability": 0.9}}],
    "_check_fabric_straggler": [
        {}, {"artifact": {"hedge": {"router_tier": {"hedged": 3},
                                    "rate": 0.7},
                          "availability": 1.0, "requests": {"served": 1}}}],
    "_check_fabric_router_kill": [
        {}, {"artifact": {"routers": {"kills": 1, "restarts": 1},
                          "workers": {"kills": 1},
                          "requests": {"failovers": 2, "served": 5},
                          "availability": 1.0}}],
    "_check_replay_tick_storm": [
        {}, {"artifact": {"ticks": {"merged_late": 1, "quarantined": 2,
                                    "deduped": 1, "dropped_gap": 0},
                          "panel": {"gap_bars": 1},
                          "reconcile": {"count": 3, "drift_events": 1},
                          "serve": {"requests": {"served": 1}}}}],
    "_check_replay_version_skew": [
        {}, {"artifact": {"versions": {"skew_events": 1}}}],
    "_check_partial_no_lost_rows": [
        _BASE, {**_BASE, "headline_violations": ["h"], "trailing": _REC,
                "sidecar_rows": 3, "rc": 1, "artifact": {"metric": "m"}},
        {**_BASE, "trailing": _PART, "sidecar_rows": 2}],
    "_check_full_all_rows": [
        _BASE, {**_BASE, "trailing": _PART, "sidecar_rows": 3, "rc": 2,
                "artifact": {"metric": 1}}],
    "_check_killed_nothing_fabricated": [
        {"rc": 0, "trailing": _REC, "artifact": _REC}],
    "_check_short_write": [
        {}, {"artifact": _REC, "prior_intact": False,
             "retry_artifact": {"metric": 1}}],
    "_check_bench_partial": [
        _BASE, {**_BASE, "trailing": {**_REC, "value": 0}, "rc": 3},
        {**_BASE, "trailing": {**_PART, "extra": {"partial": "child deadline hit",
                                                  "platform": "gpu"}}}],
    "_check_bench_supervisor_landed": [
        _BASE, {**_BASE, "trailing": _REC, "full_record": {"metric": 1}}],
    "_check_bench_child_full": [
        _BASE, {**_BASE, "trailing": _PART, "rc": 1}],
    "_check_custom_generic": [
        _BASE, {**_BASE, "trailing": _REC, "sidecar_rows": 5}],
    "_check_serve_generic": [{}, {"artifact": _SERVE_ART}],
    "_check_serve_pool_generic": [{}, {"artifact": {"kind": "serve_pool"}}],
    "_check_serve_fabric_generic": [{}, {"artifact": {"kind": "serve_fabric"}}],
    "_check_replay_generic": [{}, {"artifact": {"kind": "replay"}}],
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_check_functions_return_the_references_violations(name):
    seen = []
    for r in _CASES[name]:
        mine, theirs = _violations(lambda m: getattr(m, name)(dict(r)))
        assert mine == theirs, (name, r)
        seen.append(mine)
    assert all(seen)  # every case breaks at least one rule


def test_every_ported_check_is_held_to_the_reference():
    checks = {s.check.__name__ for s in port.builtin_matrix()}
    checks |= {f.__name__ for f in port._CUSTOM_CHECKS.values()}
    assert checks - {"_check_pool_version_skew", "_check_warmup_healed",
                     "_check_kill_retried", "_check_probe_outage"} \
        <= set(_CASES)


def _landed(value, rc=0, errors=(), extra=None):
    """A bench supervisor's result dict: its headline and full record."""
    head = {"metric": "m", "value": value, "unit": "u", "vs_baseline": 1.0,
            "extra": {"full_record": "GPU_BENCH_FULL_rehearse.json",
                      **(extra or {})}}
    full = {**head, "extra": {**head["extra"], "attempt_errors": list(errors)}}
    return {"headline_violations": [], "trailing": head, "rc": rc,
            "full_record": full, "sidecar_rows": 0}


def test_kill_check_holds_the_retry_on_the_same_device():
    """``kill-child-mid-compile``: the reference secures its record with a
    CPU fallback child, the port by retrying on the same device; the
    check is the reference's, in those words, and a measured record must
    exit 0."""
    word = ("the fallback child did not secure",
            "the retried child did not secure")
    for r in (_BASE, _landed(5.0, errors=["cuda child attempt 1: rc=-9"]),
              _landed(0.0), _landed(2.0, errors=["probe: x"])):
        mine = port._check_kill_retried(dict(r))
        theirs = [v.replace(*word) for v in ref._check_kill_fallback(dict(r))]
        assert mine == theirs
    assert port._check_kill_retried(
        _landed(5.0, errors=["cuda child attempt 1: rc=-9"])) == []
    assert port._check_kill_retried(
        _landed(5.0, rc=1, errors=["cuda child attempt 1"])) == [
        "a measured record must exit 0, got rc=1"]


def test_probe_outage_check_wants_the_last_resort_line():
    """``probe-outage``: the reference's check wants the CPU fallback's
    measured value; the port measures nothing on another device, so its
    check wants the last-resort line, exit 1, the failed probes, the full
    record and the telemetry sidecar."""
    side = {"kind": "telemetry"}
    last = _landed(0.0, rc=1, extra={"error": "all benchmark attempts failed"})
    last["full_record"]["extra"]["probes"] = [{"ok": False}]
    last["telemetry_sidecar"] = side
    mine = port._check_probe_outage(last)
    assert all(v.startswith("telemetry sidecar: ") for v in mine)
    assert ref._check_bench_fallback_measured(last) != []
    measured = _landed(5.0)
    assert ref._check_bench_fallback_measured(measured) == []
    out = port._check_probe_outage(measured)
    assert any("last-resort record" in v for v in out)
    assert any("must exit 1" in v for v in out)
    assert any("telemetry sidecar did not land" in v for v in out)


_SKEW_BRANCHES = [
    {},
    {"skew": {"started": False, "state": "failed", "restarts": 0,
              "reason": "worker refused ready (rc=4): cache version skew — "
                        "redeploy and build first (csmom warmup; "
                        f"{BUILD_POINTER})"}},
    {"skew": {"started": True, "state": "ready", "restarts": 2,
              "reason": "crash"}},
]


def test_version_skew_check_names_the_ports_remedy():
    """The port's refusal points at its kernel build, not at the
    reference's ``csmom warmup``: the one branch that differs, by that
    pointer only."""
    for r in _SKEW_BRANCHES:
        mine = port._check_pool_version_skew(r)
        theirs = ref._check_pool_version_skew(r)
        assert [v.replace(BUILD_POINTER, "csmom warmup") for v in mine] == theirs
    only_ref_pointer = {"skew": {"state": "failed", "reason": "skew; csmom warmup"}}
    assert port._check_pool_version_skew(only_ref_pointer) == [
        f"refusal reason lost the `{BUILD_POINTER}` pointer"]
    assert ref._check_pool_version_skew(only_ref_pointer) == []


_WARM_OK = {"metric": "aot_warmup", "value": 9, "n_errors": 0,
            "n_cache_hits": 0}


@pytest.mark.parametrize("trailing", [
    None, _WARM_OK, {**_WARM_OK, "n_errors": 2}, {**_WARM_OK, "value": 0},
    {**_WARM_OK, "platform": "cpu", "n_self_healed": 0}])
def test_warmup_check_equals_the_references_off_the_card(trailing):
    r = {"trailing": trailing, "headline_violations": []}
    assert port._check_warmup_healed(r) == ref._check_warmup_healed(r)


def test_warmup_check_is_tighter_on_the_card():
    healed = {**_WARM_OK, "platform": "gpu", "n_self_healed": 2,
              "launches": {"decile_partial_sums": 2,
                           "cohort_partial_sums": 2, "rank_labels": 2}}
    assert port._check_warmup_healed({"trailing": healed}) == []
    unhealed = {**healed, "n_self_healed": 0,
                "launches": {"decile_partial_sums": 2}}
    out = port._check_warmup_healed({"trailing": unhealed})
    assert len(out) == 3 and "self-healed" in out[0]
    assert "cohort_partial_sums" in out[1] and "rank_labels" in out[2]
    assert ref._check_warmup_healed({"trailing": unhealed}) == []
    # a failed fault-free pass fails the scenario (the reference ignores it)
    r = {"trailing": healed, "headline_violations": ["pass 1 failed"]}
    assert port._check_warmup_healed(r) == ["pass 1 failed"]
    assert ref._check_warmup_healed(r) == []
