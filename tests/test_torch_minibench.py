"""``python -m csmom_tpu_torch.chaos.minibench`` against the reference's.

Under the same environment and the same fault plans, both miniature
capture children give the same record keys, the same measured-row
counts, the same sidecar rows and the same exit code; the port's
imports no torch (as the reference's imports no jax).
"""

import json
import os
import subprocess
import sys

import pytest

from csmom_tpu_torch.chaos import invariants as inv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLANS = {
    "none": None,
    "trip-deadline": ('name = "t"\nseed = 1\n\n[[fault]]\npoint = "mini.row"\n'
                      'action = "trip_deadline"\nafter = 3\n'),
    "stdout-noise": ('name = "n"\nseed = 3\n\n[[fault]]\npoint = "mini.finish"\n'
                     'action = "stdout_noise"\nseconds = 1.0\n'),
    "kill": ('name = "k"\nseed = 5\n\n[[fault]]\npoint = "mini.row"\n'
             'action = "kill"\nafter = 2\n'),
}


def _run(module, box, plan):
    box.mkdir()
    sidecar = box / "sidecar.jsonl"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSMOM_", "JAX_PLATFORMS"))}
    env.update({"PYTHONPATH": _REPO, "JAX_PLATFORMS": "cpu",
                "CSMOM_MINIBENCH_BUDGET": "60", "CSMOM_MINIBENCH_ROWS": "6",
                "CSMOM_MINIBENCH_SIDECAR": str(sidecar),
                "CSMOM_FAULT_STATE": str(box / "state")})
    if plan is not None:
        (box / "plan.toml").write_text(plan)
        env["CSMOM_FAULT_PLAN"] = str(box / "plan.toml")
    p = subprocess.run([sys.executable, "-X", "importtime", "-m", module],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=str(box))
    rows = ([json.loads(ln) for ln in sidecar.read_text().splitlines() if ln]
            if sidecar.exists() else [])
    mods = {ln.split("|")[-1].strip() for ln in p.stderr.splitlines()
            if ln.startswith("import time:")}
    return p, inv.trailing_json(p.stdout), rows, mods


def _shape(obj):
    if obj is None:
        return None
    ex = obj["extra"]
    return (sorted(obj), sorted(ex), inv.measured_rows(obj),
            [sorted(r) for r in ex["rows"]], inv.is_partial(obj),
            obj["metric"], obj["unit"])


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_both_minibench_processes_agree(plan, tmp_path):
    mine = _run("csmom_tpu_torch.chaos.minibench", tmp_path / "port", PLANS[plan])
    theirs = _run("csmom_tpu.chaos.minibench", tmp_path / "reference", PLANS[plan])
    (p, obj, rows, mods), (rp, robj, rrows, _) = mine, theirs
    assert p.returncode == rp.returncode, p.stderr[-2000:]
    assert _shape(obj) == _shape(robj)
    assert [r["row"] for r in rows] == [r["row"] for r in rrows]
    assert [sorted(r) for r in rows] == [sorted(r) for r in rrows]
    assert "torch" not in mods and not any(m.startswith("csmom_tpu.") for m in mods)
    if obj is not None:
        assert inv.validate(obj) == [] and inv.validate_headline_text(p.stdout) == []
        assert inv.measured_rows(obj) == len(rows)
    expect_rows = {"none": 6, "stdout-noise": 6, "trip-deadline": 3, "kill": 2}
    assert len(rows) == expect_rows[plan]
