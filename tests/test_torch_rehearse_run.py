"""``rehearse`` run end to end on the CPU, in processes of their own.

The 16 fast scenarios (mini, shell, serve, serve-pool, replay) run on
stub engines and the capture plumbing and need no card.  Every serving
artifact they land passes the check of its scenario in both packages,
and the run's telemetry sidecar, ``GPU_TELEMETRY_rehearse_fast.json``,
holds one ``rehearse.row`` span per scenario and passes both packages'
``telemetry`` validators.  No wall gate: the tier's wall on this machine
is a record, not a limit.

The capture tier: each ``mini`` and ``shell`` scenario gives the same
result (pass or fail, and its violations) in both packages, run by each
package's own runner; the supervisor's ``bench`` scenarios and the
``clock-skew-mid-child`` child run green with ``--device cpu``; the rest
of the bench tier, the 150 s ``r5-hang-mid-compile-window`` among them,
runs in the slow matrix (the card runs ``expire-deadline-mid-row`` in
the smoke's phase 22).
"""

import glob
import json
import os
import subprocess
import sys

import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.cli import rehearse as ref
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.cli import rehearse as port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rehearse_fast")
    env = {**os.environ, "PYTHONPATH": _REPO,
           "CSMOM_TELEMETRY_DIR": str(tmp / "telemetry")}
    for k in ("CSMOM_TELEMETRY", "CSMOM_TELEMETRY_RUN", "CSMOM_FAULT_PLAN"):
        env.pop(k, None)
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "rehearse", "--fast",
         "--device", "cpu", "--sandbox", str(tmp / "box"), "--keep"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp), env=env)
    return tmp, p


def test_fast_tier_runs_green_without_a_card(fast_run):
    tmp, p = fast_run
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "16/16 scenarios green" in p.stdout
    for s in port.builtin_matrix(fast=True):
        assert f"[PASS] {s.name}" in p.stdout


def _artifact(box, prefix):
    (path,) = glob.glob(os.path.join(box, f"{prefix}_rehearse_*.json"))
    with open(path) as f:
        return json.load(f)


def _result(tmp, scenario):
    """The result dict a scenario's check reads, rebuilt from what the
    run landed in its sandbox."""
    box = str(tmp / "box" / scenario.name)
    if scenario.pipeline == "serve":
        return {"artifact": _artifact(box, "GPU_SERVE")}
    if scenario.pipeline == "replay":
        return {"artifact": _artifact(box, "GPU_REPLAY")}
    r = {"artifact": _artifact(box, "GPU_SERVE_POOL"),
         "trace_book_violations": []}
    if scenario.env.get("trace"):
        r["trace_artifact"] = _artifact(box, "GPU_TRACE")
    if scenario.env.get("fleet"):
        r["fleet_artifact"] = _artifact(box, "GPU_FLEET")
    return r


def test_landed_artifacts_pass_both_packages_checks(fast_run):
    tmp, p = fast_run
    assert p.returncode == 0
    ref_checks = {s.name: s.check for s in ref.builtin_matrix(fast=True)}
    held = 0
    for s in port.builtin_matrix(fast=True):
        if s.env.get("mode") in ("roll", "skew") or s.pipeline in ("mini", "shell"):
            # their evidence is the supervisor's or the runner's, never
            # landed as an artifact of the tier (the capture tier's
            # results are held below)
            continue
        r = _result(tmp, s)
        assert s.check(r) == [], s.name
        assert ref_checks[s.name](r) == [], s.name
        held += 1
    assert held == 11


def test_the_runs_sidecar_holds_a_row_per_scenario(fast_run):
    tmp, p = fast_run
    assert p.returncode == 0
    path = tmp / "telemetry" / "GPU_TELEMETRY_rehearse_fast.json"
    assert f"telemetry: {path}" in p.stdout
    with open(path) as f:
        obj = json.load(f)
    assert inv.validate(obj) == [] and inv.detect_kind(obj) == "telemetry"
    assert ref_inv.validate(obj, "telemetry") == []
    rows = {a["name"]: a for a in obj["spans"]}
    assert rows["rehearse.row"]["count"] == 16
    assert rows["rehearse.run"]["count"] == 1
    assert obj["metrics"]["counters"]["rehearse.scenarios"] == 16
    assert obj["metrics"]["counters"]["rehearse.failures"] == 0
    assert not os.path.exists(tmp / ".csmom_scratch")
    # timeline renders it, by run id, from the same directory
    t = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "timeline",
         "rehearse_fast"], capture_output=True, text=True, timeout=120,
        cwd=str(tmp), env={**os.environ, "PYTHONPATH": _REPO,
                           "CSMOM_TELEMETRY_DIR": str(tmp / "telemetry")})
    assert t.returncode == 0, t.stderr
    assert "run rehearse_fast" in t.stdout and "rehearse.row" in t.stdout


# ------------------------------------------------------------ capture tier --

def _capture(pipelines, fast=None):
    return [s.name for s in port.builtin_matrix()
            if s.pipeline in pipelines and (fast is None or s.fast == fast)]


@pytest.mark.parametrize("name", _capture(("mini", "shell")))
def test_capture_plumbing_scenario_equals_the_references(name, tmp_path):
    """The same scenario through each package's runner (the port's
    minibench and capture_lib.sh, the reference's): the same verdict and
    the same violations."""
    mine = {s.name: s for s in port.builtin_matrix()}[name]
    theirs = {s.name: s for s in ref.builtin_matrix()}[name]
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("CSMOM_FAULT", "CSMOM_TELEMETRY", "CSMOM_MINIBENCH"))}
    try:
        r_mine, v_mine, _ = port._run_scenario(mine, str(tmp_path / "port"), "cpu")
        r_theirs, v_theirs, _ = ref._run_scenario(theirs, str(tmp_path / "reference"))
    finally:
        os.environ.update(saved)
    assert v_mine == v_theirs == []
    assert (r_mine["rc"], r_mine["sidecar_rows"]) == (r_theirs["rc"],
                                                     r_theirs["sidecar_rows"])
    assert ((r_mine.get("artifact") is None) == (r_theirs.get("artifact") is None))
    if r_mine.get("artifact") is not None:
        assert (inv.measured_rows(r_mine["artifact"])
                == inv.measured_rows(r_theirs["artifact"]))


_FAST_BENCH = ("kill-child-mid-compile", "probe-outage", "enospc-on-land",
               "clock-skew-mid-child")


def _rehearse_cpu(tmp, names, timeout):
    args = ["--device", "cpu", "--sandbox", str(tmp / "box"), "--keep"]
    for n in names:
        args += ["--only", n]
    env = {**os.environ, "PYTHONPATH": _REPO,
           "CSMOM_TELEMETRY_DIR": str(tmp / "telemetry")}
    for k in ("CSMOM_TELEMETRY", "CSMOM_TELEMETRY_RUN", "CSMOM_FAULT_PLAN"):
        env.pop(k, None)
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "rehearse", *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(tmp), env=env)
    rows = {}
    for ln in p.stdout.splitlines():
        ln = ln.strip()
        if ln.startswith("[PASS]") or ln.startswith("[FAIL]"):
            rows[ln.split()[1]] = ln[1:5]
    return p, rows


@pytest.fixture(scope="module")
def fast_bench_run(tmp_path_factory):
    return _rehearse_cpu(tmp_path_factory.mktemp("rehearse_bench"),
                         _FAST_BENCH, 600)


@pytest.mark.parametrize("name", _FAST_BENCH)
def test_fast_bench_scenario_runs_green_on_the_cpu(fast_bench_run, name):
    p, rows = fast_bench_run
    assert rows.get(name) == "PASS", p.stdout[-3000:] + p.stderr[-3000:]
    assert p.returncode == 0 and "4/4 scenarios green" in p.stdout


def test_the_bench_tier_is_the_rest_of_the_matrix():
    assert set(_capture(("bench", "bench-child"))) == set(_FAST_BENCH) | {
        "r5-hang-mid-compile-window", "expire-deadline-mid-row"}


@pytest.mark.slow
def test_the_whole_bench_tier_runs_green_on_the_cpu(tmp_path):
    """The slow matrix: all six bench and bench-child scenarios, the
    150 s ``r5-hang-mid-compile-window`` among them."""
    names = _capture(("bench", "bench-child"))
    p, rows = _rehearse_cpu(tmp_path, names, 1800)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert rows == dict.fromkeys(names, "PASS")
