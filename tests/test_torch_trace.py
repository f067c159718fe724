"""Request-path tracing in the port: ``loadgen --trace`` in its three
serving modes, the ``trace`` artifact kind and the ``trace`` command,
against ``csmom_tpu``.

- The reference's committed ``TRACE_r17.json``, ``TRACE_r18.json`` and
  ``TRACE_r19.json`` pass the port's validator, and the port's ``trace
  <file>`` prints the same text as the reference's ``cmd_trace`` on each
  (the rendering is a function of the artifact's bytes).
- ``loadgen --trace --stub`` lands a ``GPU_TRACE_*`` that both packages'
  validators accept, in-process, through the pool and through the fabric
  with a router replica SIGKILLed: the books close against the run's
  request books and every orphan half carries its reason.
- The reference's broken books and residuals are refused by both
  validators.
- The ledger ingests a ``GPU_TRACE_*`` artifact's per-stage rows with
  their samples and its budget-burn rows, and a traced serve run's p99
  rows carry their samples, as the reference's does.

The serving modes run stub workers (no torch in any spawned process);
every spawned process is stopped before a test returns.
"""

import argparse
import copy
import json
import os
import signal
import time

import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.cli.trace import cmd_trace as ref_cmd_trace
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.cli.main import main
from csmom_tpu_torch.obs import trace as obs_trace

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = ("TRACE_r17.json", "TRACE_r18.json", "TRACE_r19.json")


@pytest.fixture(autouse=True)
def _disarmed():
    obs_trace.disarm_tracing()
    yield
    obs_trace.disarm_tracing()


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_trace_artifacts_pass_the_ports_validator(name):
    path = os.path.join(_REPO, name)
    assert inv.detect_kind(json.load(open(path))) == "trace"
    assert inv.validate_file(path) == []


def _render_both(path, capsys):
    """(port stdout, reference stdout, their exit codes) for one file."""
    rc = main(["trace", path])
    port = capsys.readouterr().out
    ref_rc = ref_cmd_trace(argparse.Namespace(run=path, root=None, top=8,
                                              json=False))
    ref = capsys.readouterr().out
    return port, ref, rc, ref_rc


@pytest.mark.parametrize("name", COMMITTED)
def test_trace_renders_the_committed_files_as_the_reference_does(name, capsys):
    port, ref, rc, ref_rc = _render_both(os.path.join(_REPO, name), capsys)
    assert rc == ref_rc == 0
    assert port == ref
    for section in ("trace books:", "per-stage decomposition",
                    "critical path", "per-class SLO error-budget burn"):
        assert section in port


def _base():
    return {
        "kind": "trace", "schema_version": 1, "run_id": "x",
        "metric": "trace_complete_traces", "value": 2, "unit": "traces",
        "vs_baseline": 1.0,
        "books": {"opened": 3, "complete": 2, "partial": 1,
                  "partial_reasons": {"queue full": 1}},
        "orphans": {"count": 0, "reasons": {}},
        "stages": {"dispatch": {"count": 2, "p50": 1.0, "p95": 2.0,
                                "p99": 2.0, "max_ms": 2.0, "total_s": 0.003}},
        "classes": {}, "slowest": [],
        "reconcile": {"checked": 3, "violations": 0,
                      "max_abs_residual_ms": 0.0, "epsilon_ms": 2.0},
        "requests": {"admitted": 3, "served": 2, "rejected": 1, "expired": 0},
    }


# the reference's broken artifacts (tests/test_trace.py): (mutation, the
# message both validators must give)
_BROKEN = {
    "books_open": (lambda a: a["books"].update(partial=0, partial_reasons={}),
                   "books broken"),
    "partial_without_reason": (lambda a: a["books"].update(partial_reasons={}),
                               "closed without a reason"),
    "complete_is_not_served": (lambda a: a["requests"].update(served=1,
                                                              rejected=2),
                               "books.complete"),
    "critical_path_off": (lambda a: a.update(slowest=[{
        "trace_id": "t", "wall_ms": 50.0, "stages": {"dispatch": 1.0}}]),
        "critical path does not reconcile"),
    "reconcile_violations": (lambda a: a["reconcile"].update(violations=2),
                             "full stop"),
    "orphan_without_reason": (lambda a: a["orphans"].update(count=2),
                              "orphan reasons sum"),
    "unknown_schema": (lambda a: a.update(schema_version=7),
                       "unknown schema_version"),
}


@pytest.mark.parametrize("validator", ["port", "reference"])
@pytest.mark.parametrize("case", sorted(_BROKEN))
def test_broken_trace_artifacts_are_refused(case, validator):
    check = inv if validator == "port" else ref_inv
    assert check.validate(_base(), "trace") == []
    bad = copy.deepcopy(_base())
    mutate, message = _BROKEN[case]
    mutate(bad)
    assert any(message in v for v in check.validate(bad, "trace"))


# --------------------------------------------------- loadgen --trace -------

_MODES = {
    "inprocess": [],
    "pool": ["--pool", "--workers", "2", "--kill-worker-after", "0.3"],
    "fabric": ["--fabric", "--workers", "2", "--routers", "2",
               "--kill-router-after", "0.3"],
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_loadgen_trace_lands_an_artifact_both_validators_accept(mode, tmp_path,
                                                                 capsys):
    run_id = f"t-{mode}"
    rc = main(["loadgen", "--stub", "--smoke", "--trace", "--schedule",
               "1.0x60", "--out", str(tmp_path), "--run-id", run_id,
               *_MODES[mode]])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "trace armed" in out and "trace artifact: " in out
    path = tmp_path / f"GPU_TRACE_{run_id}.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    tart = json.loads(path.read_text())
    serve = json.loads(next(p for p in tmp_path.glob(f"GPU_SERVE*_{run_id}.json")
                            ).read_text())
    req = serve["requests"]
    assert tart["books"]["opened"] == req["admitted"]
    assert tart["books"]["complete"] == req["served"]
    assert tart["books"]["partial"] == req["rejected"] + req["expired"]
    assert tart["reconcile"]["violations"] == 0
    if mode != "inprocess":
        for stage in ("route", "transport", "queue_wait", "dispatch", "finalize"):
            assert stage in tart["stages"], stage
    conn = {"pool": "worker_conn_failures", "fabric": "router_conn_failures"}
    if mode in conn:
        assert tart["orphans"]["count"] == req[conn[mode]]
        victim = "w0:" if mode == "pool" else "r0:"
        assert all(r.startswith(victim) for r in tart["orphans"]["reasons"])
    assert not obs_trace.tracing_armed()
    # the port's artifact renders as the reference renders it
    port, ref, rc, ref_rc = _render_both(str(path), capsys)
    assert rc == ref_rc == 0 and port == ref


def test_fabric_trace_books_close_under_router_replica_sigkill(tmp_path):
    """Three tiers traced (client -> replicas, each armed with --trace ->
    workers), one replica SIGKILLed mid-dispatch: the client's book
    closes against the fabric's request books, every orphan half names the
    dead replica, the stitched chain carries every tier's stages, and each
    surviving replica's own trace book closes too."""
    from csmom_tpu_torch.serve.fabric import build_fabric, stop_fabric
    from csmom_tpu_torch.serve.loadgen import LoadConfig, run_fabric_loadgen
    from csmom_tpu_torch.serve.supervisor import PoolConfig

    smoke = dict(profile="serve-smoke", engine="stub", ready_timeout_s=30.0,
                 poll_interval_s=0.05, backoff_base_s=0.05, backoff_cap_s=0.5)
    wsup, pub, rsup, client = build_fabric(
        PoolConfig(n_workers=2, **smoke), PoolConfig(n_workers=2, **smoke),
        str(tmp_path), deadline_ms=3000.0, trace=True, client_deadline_s=3.0)
    book = obs_trace.arm_tracing(seed=3)

    def kill_replica():
        time.sleep(0.3)
        os.kill(rsup.handles[0].proc.pid, signal.SIGKILL)
        give_up = time.monotonic() + 30.0
        while time.monotonic() < give_up:
            if any(h.generation >= 1 and h.state == "ready" for h in rsup.handles):
                return
            time.sleep(0.05)

    try:
        art = run_fabric_loadgen(client, rsup, wsup, LoadConfig(
            schedule="1.2x70", seed=7, deadline_s=3.0, run_id="t-fabric-kill"),
            concurrent=kill_replica)
    finally:
        stop_fabric(pub, rsup, wsup)
        client.close()
    obs_trace.disarm_tracing()
    req = art["requests"]
    assert book.invariant_violations() == []
    assert book.opened == req["admitted"] and book.complete == req["served"]
    assert book.partial == req["rejected"] + req["expired"]
    snap = book.snapshot()
    assert snap["orphans"]["count"] == req["router_conn_failures"] > 0
    assert all(r.startswith("r0:") for r in snap["orphans"]["reasons"])
    for stage in ("route", "transport", "queue_wait", "dispatch", "finalize"):
        assert stage in snap["stages"], stage
    assert snap["reconcile"]["violations"] == 0
    surviving = [r for r in art["routers"]["replicas"]
                 if r.get("state") == "ready" and "accounting" in r]
    assert surviving
    for rep in surviving:
        tr = rep["trace"]
        assert tr["invariant_violations"] == [] and rep["torch_loaded"] is False
        b = tr["snapshot"]["books"]
        assert b["opened"] == b["complete"] + b["partial"]
    tart = obs_trace.build_artifact(
        book, "t-fabric-kill",
        requests={k: req[k] for k in ("admitted", "served", "rejected", "expired")},
        fresh_compiles=0, platform="stub", workload="fabric kill")
    assert inv.validate(tart) == [] and ref_inv.validate(tart) == []


def test_trace_finds_an_artifact_by_run_id_and_reports_a_missing_one(tmp_path,
                                                                     capsys):
    rc = main(["loadgen", "--stub", "--smoke", "--trace", "--schedule", "0.3x40",
               "--out", str(tmp_path), "--run-id", "by-id"])
    assert rc == 0
    capsys.readouterr()
    assert main(["trace", "by-id", "--root", str(tmp_path)]) == 0
    by_id = capsys.readouterr().out
    assert main(["trace", "by", "--root", str(tmp_path)]) == 0   # GPU_TRACE_*by*
    assert capsys.readouterr().out == by_id
    assert main(["trace", "by-id", "--root", str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["run_id"] == "by-id"
    assert main(["trace", "nothing-here", "--root", str(tmp_path)]) == 2
    assert "loadgen --trace" in capsys.readouterr().err


def test_loadgen_trace_defaults_to_the_card(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    assert main(["loadgen", "--trace", "--smoke", "--out", str(tmp_path)]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


# ------------------------------------------------------------ the ledger ----

def _run_traced_loadgen(**load_kw):
    from csmom_tpu_torch.serve.loadgen import LoadConfig, run_loadgen
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    book = obs_trace.arm_tracing(seed=1)
    svc = SignalService(ServeConfig(profile="serve-smoke",
                                    engine="stub")).start()
    art = run_loadgen(svc, LoadConfig(run_id="trace_unit", **load_kw))
    obs_trace.disarm_tracing()
    return book, art


def test_ledger_ingests_trace_rows_with_samples_and_burn(tmp_path):
    book, art = _run_traced_loadgen(schedule="0.4x80", seed=3,
                                    deadline_s=2.0)
    tart = obs_trace.build_artifact(
        book, "r90",
        requests={k: art["requests"][k]
                  for k in ("admitted", "served", "rejected", "expired")},
        fresh_compiles=0, platform="stub", workload="unit")
    with open(tmp_path / "GPU_TRACE_r90.json", "w") as f:
        json.dump(tart, f)
    from csmom_tpu_torch.obs import ledger as ld

    L = ld.load(str(tmp_path))
    by_metric = {}
    for r in L.rows:
        by_metric.setdefault(r.metric, []).append(r)
    disp = by_metric["trace_stage_dispatch_p99_ms"][0]
    assert disp.direction == "lower" and disp.gate_eligible()
    assert disp.samples, "per-stage rows must carry their CI backing"
    burn_rows = [m for m in by_metric if m.endswith("_budget_burn")]
    assert burn_rows, "per-class budget-burn rows must land"
    for m in burn_rows:
        assert by_metric[m][0].gate_eligible()
    assert "trace_complete_traces" in by_metric
    assert not by_metric["trace_complete_traces"][0].gate_eligible()


def test_ledger_attaches_serve_latency_samples_to_p99_rows(tmp_path):
    _, art = _run_traced_loadgen(schedule="0.4x80", seed=3,
                                 deadline_s=2.0)
    with open(tmp_path / "GPU_SERVE_r91.json", "w") as f:
        json.dump(dict(art, run_id="r91"), f)
    from csmom_tpu_torch.obs import ledger as ld

    L = ld.load(str(tmp_path))
    rows = {r.metric: r for r in L.rows}
    assert rows["serve_p99_ms"].samples, (
        "serve p99 rows must carry the persisted per-request samples")
    cls_rows = [r for m, r in rows.items()
                if m.endswith("_p99_ms") and m.startswith("serve_")
                and not m.startswith(("serve_p", "serve_ep_"))]
    assert any(r.samples for r in cls_rows), "class p99 rows lost samples"
    ep_rows = [r for m, r in rows.items() if m.startswith("serve_ep_")
               and m.endswith("_p99_ms")]
    assert any(r.samples for r in ep_rows), "endpoint p99 rows lost samples"
    # and the artifact is v4-valid (burn + samples are schema rules)
    assert inv.validate(art, "serve") == []
