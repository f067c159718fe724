"""The matrix's scenarios outside the fast tier, each through ``--only``
in a process of its own on the CPU: the three ``serve-fabric`` scenarios
(router replicas as processes, chaos armed in their tier through
``PoolSupervisor.extra_env``) and the warm-up's ``corrupt-aot-cache``
with ``--device cpu``, where nothing is built and so nothing is there to
corrupt (the card's heal is the smoke's phase 20)."""

import glob
import json
import os
import subprocess
import sys

import pytest

from csmom_tpu.cli import rehearse as ref
from csmom_tpu_torch.cli import rehearse as port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FABRIC = [s.name for s in port.builtin_matrix()
           if s.pipeline == "serve-fabric"]


def _rehearse(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": _REPO,
           "CSMOM_TELEMETRY_DIR": str(tmp_path / "telemetry")}
    env.pop("CSMOM_FAULT_PLAN", None)
    return subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.cli", "rehearse", *args,
         "--sandbox", str(tmp_path / "box"), "--keep"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)


def test_the_fabric_tier_is_three_scenarios():
    assert _FABRIC == ["fabric-partition-mid-burst", "fabric-induced-straggler",
                       "fabric-router-kill-mid-burst"]


@pytest.mark.parametrize("name", _FABRIC)
def test_fabric_scenario_runs_green(tmp_path, name):
    p = _rehearse(tmp_path, "--only", name, "--device", "cpu")
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert f"[PASS] {name}" in p.stdout and "1/1 scenarios green" in p.stdout
    (path,) = glob.glob(str(tmp_path / "box" / name / "GPU_SERVE_FABRIC_*.json"))
    with open(path) as f:
        art = json.load(f)
    check = {s.name: s.check for s in ref.builtin_matrix()}[name]
    assert check({"artifact": art}) == []  # the reference's check holds too


def test_corrupt_aot_cache_runs_green_on_the_cpu(tmp_path):
    p = _rehearse(tmp_path, "--only", "corrupt-aot-cache", "--device", "cpu")
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "[PASS] corrupt-aot-cache" in p.stdout
    assert "1/1 scenarios green" in p.stdout
    assert "none was there to corrupt" in p.stdout
    box = tmp_path / "box" / "corrupt-aot-cache"
    with open(box / "pass2.out") as f:
        summary = json.loads(f.read().strip().splitlines()[-1])
    assert summary["platform"] == "cpu" and summary["n_errors"] == 0
    assert summary["value"] > 0 and summary["n_self_healed"] == 0
    assert summary["launches"] == {"decile_partial_sums": 0,
                                   "cohort_partial_sums": 0, "rank_labels": 0}
    # the armed pass found the sandbox's build directory empty
    assert "nothing to damage" in (box / "pass2.err").read_text()
    assert not (box / "jit-cache").exists() or not os.listdir(box / "jit-cache")
