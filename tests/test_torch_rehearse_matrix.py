"""The port's ``rehearse`` matrix and check functions against the reference's.

``csmom_tpu_torch.cli.rehearse`` ships 17 of the reference's 29
scenarios, those of the tiers the port runs (serve, serve-pool,
serve-fabric, replay and the warm-up's ``corrupt-aot-cache``), with the
reference's names, plans, environments, fast flags and notes (less
the reference's leading "<LABEL> <n>: " tags) in its order.
Every check function returns the reference's violations on the same
result dict; the two that differ are pinned where they differ: the
version-skew refusal names the port's remedy, and on the card the
warm-up check also wants a heal and both kernels launched.
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
_UNPORTED = {"mini", "shell", "bench", "bench-child"}


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
    return (s.name, s.pipeline, s.fast,
            s.plan.to_toml() if s.plan is not None else None,
            _plain(s.env), _notes(s.notes))


@pytest.mark.parametrize("fast", [False, True])
def test_matrix_equals_the_references_ported_tiers(fast):
    mine = port.builtin_matrix(fast=fast)
    theirs = [s for s in ref.builtin_matrix(fast=fast)
              if s.pipeline not in _UNPORTED]
    assert [_row(s) for s in mine] == [_row(s) for s in theirs]
    assert len(mine) == (13 if fast else 17)
    if fast:
        assert {s.pipeline for s in mine} == {"serve", "serve-pool", "replay"}


def test_the_absent_scenarios_are_the_twelve_of_the_unported_tiers():
    mine = {s.name for s in port.builtin_matrix()}
    absent = [s for s in ref.builtin_matrix() if s.name not in mine]
    assert len(absent) == 12
    assert {s.pipeline for s in absent} == _UNPORTED
    assert set(port.UNPORTED_PIPELINES) == _UNPORTED
    assert {s.pipeline for s in port.builtin_matrix()} == set(port._RUNNERS)


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
    p = _cli(["--pipeline", pipeline, "--fast"], timeout=60)
    assert p.returncode == 2
    assert f"--pipeline {pipeline} is not ported" in p.stderr
    assert f"item {item}" in p.stderr
    assert "scenarios green" not in p.stdout


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

def _violations(call):
    """``call(module)`` for the port's and the reference's rehearse."""
    return call(port), call(ref)


_SERVE_ART = {"kind": "serve", "requests": {"admitted": 3, "served": 3,
                                             "rejected": 0, "expired": 0}}


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
    assert checks - {"_check_pool_version_skew", "_check_warmup_healed"} \
        <= set(_CASES)


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
                           "cohort_partial_sums": 2}}
    assert port._check_warmup_healed({"trailing": healed}) == []
    unhealed = {**healed, "n_self_healed": 0,
                "launches": {"decile_partial_sums": 2}}
    out = port._check_warmup_healed({"trailing": unhealed})
    assert len(out) == 2 and "self-healed" in out[0]
    assert "cohort_partial_sums" in out[1]
    assert ref._check_warmup_healed({"trailing": unhealed}) == []
    # a failed fault-free pass fails the scenario (the reference ignores it)
    r = {"trailing": healed, "headline_violations": ["pass 1 failed"]}
    assert port._check_warmup_healed(r) == ["pass 1 failed"]
    assert ref._check_warmup_healed(r) == []
