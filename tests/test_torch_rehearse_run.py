"""``rehearse --fast`` run end to end on the CPU, in a process of its own.

The 13 fast scenarios (serve, serve-pool, replay) run on stub engines and
need no card.  Every artifact they land passes the check of its scenario
in both packages, and the run's telemetry sidecar,
``GPU_TELEMETRY_rehearse_fast.json``, holds one ``rehearse.row`` span per
scenario and passes both packages' ``telemetry`` validators.  No wall
gate: the tier's wall on this machine is a record, not a limit.
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
    assert "13/13 scenarios green" in p.stdout
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
        if s.env.get("mode") in ("roll", "skew"):
            continue  # their evidence is the supervisor's, never landed
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
    assert rows["rehearse.row"]["count"] == 13
    assert rows["rehearse.run"]["count"] == 1
    assert obj["metrics"]["counters"]["rehearse.scenarios"] == 13
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
