"""The port's replay harness (``csmom_tpu_torch.stream.replay``), the
``replay`` artifact kind and the ``replay`` command, against
``csmom_tpu``'s on the same seeds.

- ``run_replay`` with the stub engine in both packages, fault-free and
  under ``builtin_fault_plan``, with ``capacity`` equal to the log and
  wrapped: the tick, panel and version books, the reconcile counters and
  the serve books are exactly equal.
- ``engine="torch", device="cpu"`` against the reference's
  ``engine="jax"`` on the CPU: the same books, and the reconcile's
  ``engine_max_abs_diff`` within the f32 turnover tolerance stated at
  ``_f32_engine_tol`` (both engines sum float32 prefixes in their own
  order).
- ``REPLAY_r12.json`` passes the port's validator, the port's artifacts
  pass the reference's, and the reference's doctored artifacts are
  refused by both.
- The ledger ingests a ``GPU_REPLAY_*`` artifact's rows (a smoke run's
  flagged) and refuses an unknown schema era, as the reference's does.
"""

import copy
import json
import os

import numpy as np
import pytest

from csmom_tpu.chaos import inject as ref_inject
from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.chaos.plan import PLAN_ENV
from csmom_tpu.stream import replay as ref_replay
from csmom_tpu_torch.chaos import inject
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.stream import replay
from csmom_tpu_torch.stream.replay import ReplayConfig, run_replay

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the books a replay's outcome is judged by (wall-clock figures aside)
_BOOKS = ("ticks", "panel", "versions")
_RECONCILE = ("count", "drift_events", "rebuilds", "reanchors")


def _armed_run(module, inject_module, cfg, plan=None):
    """``module.run_replay(cfg)`` with ``plan`` (a FaultPlan or None)
    armed through the environment, restored afterwards."""
    saved = {k: os.environ.get(k) for k in (PLAN_ENV, "CSMOM_FAULT_STATE")}
    if plan is None:
        os.environ.pop(PLAN_ENV, None)
    else:
        os.environ[PLAN_ENV] = plan.to_toml()
    os.environ.pop("CSMOM_FAULT_STATE", None)
    inject_module.reset()
    try:
        return module.run_replay(cfg)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        inject_module.reset()


def _pair(chaos: bool, capacity, **kw):
    """The same stub replay in both packages; returns (port, ref)."""
    cfgs = [m.ReplayConfig(run_id="t", engine="stub", profile="serve-smoke",
                           capacity=capacity, **kw)
            for m in (replay, ref_replay)]
    return tuple(
        _armed_run(m, im, cfg, m.builtin_fault_plan(cfg) if chaos else None)
        for m, im, cfg in ((replay, inject, cfgs[0]),
                           (ref_replay, ref_inject, cfgs[1])))


def _serve_books(art):
    req = dict(art["serve"]["requests"])
    # the port's service books carry two counters of its own (quota and
    # coalesced rejections), zero in every replay
    assert req.pop("rejected_quota", 0) == 0
    assert req.pop("rejected_coalesced", 0) == 0
    req.pop("served_cache_hits", None)
    req.pop("served_coalesced", None)
    return req


@pytest.fixture(scope="module")
def stub_pairs():
    return {(chaos, cap): _pair(chaos, cap)
            for chaos in (False, True) for cap in (None, 32)}


@pytest.mark.parametrize("cap", [None, 32], ids=["wrapped", "capacity_eq_bars"])
@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "builtin"])
def test_stub_replay_books_equal_the_reference(stub_pairs, chaos, cap):
    port, ref = stub_pairs[(chaos, cap)]
    assert inv.validate(port) == [] and ref_inv.validate(port) == []
    for block in _BOOKS:
        assert port[block] == ref[block], block
    assert {k: port["reconcile"][k] for k in _RECONCILE} == \
        {k: ref["reconcile"][k] for k in _RECONCILE}
    assert _serve_books(port) == {k: v for k, v in _serve_books(ref).items()
                                  if k in _serve_books(port)}
    assert port["reconcile"]["drift_events"] == 0
    assert port["compile"]["in_window_fresh_compiles"] == 0
    assert port["extra"]["engine"] == "stub"
    assert port["extra"]["platform"] == "stub"
    if cap is None:
        assert port["panel"]["evictions"] > 0 and port["reconcile"]["reanchors"] > 0
    else:
        assert port["panel"]["evictions"] == 0
    if chaos:
        t = port["ticks"]
        assert min(t["merged_late"], t["quarantined"], t["deduped"],
                   t["dropped_gap"]) > 0
        assert port["versions"]["skew_refusals"] == port["versions"]["skew_attempts"] > 0


def _f32_engine_tol(cfg) -> float:
    """The largest reconcile difference two f32 engines may show: 32 ulps
    of the largest cumulative turnover of the run (the updater's own
    cross-check tolerance, ``IncrementalTurnover._cross_atol``)."""
    log = replay.synth_tick_log(cfg)
    vol = np.zeros(cfg.n_assets)
    for t in log:
        vol[int(t.asset[1:])] += t.volume / 21.0
    return 32.0 * float(np.finfo(np.float32).eps) * (float(vol.max()) + 1.0)


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "builtin"])
def test_torch_cpu_replay_equals_the_jax_replay(chaos):
    kw = dict(run_id="t", seed=12, profile="serve-smoke")
    port_cfg = ReplayConfig(engine="torch", device="cpu", **kw)
    ref_cfg = ref_replay.ReplayConfig(engine="jax", **kw)
    port = _armed_run(replay, inject, port_cfg,
                      replay.builtin_fault_plan(port_cfg) if chaos else None)
    ref = _armed_run(ref_replay, ref_inject, ref_cfg,
                     ref_replay.builtin_fault_plan(ref_cfg) if chaos else None)
    for block in _BOOKS:
        assert port[block] == ref[block], block
    for k in (*_RECONCILE, "engine_checks"):
        assert port["reconcile"][k] == ref["reconcile"][k], k
    assert port["reconcile"]["engine_checks"] > 0
    tol = _f32_engine_tol(port_cfg)
    assert port["reconcile"]["engine_max_abs_diff"] <= tol
    assert ref["reconcile"]["engine_max_abs_diff"] <= tol
    assert port["compile"]["in_window_fresh_compiles"] == 0
    assert port["extra"]["engine"] == "torch"
    assert port["extra"]["platform"] == "cpu"
    assert inv.validate(port) == [] and ref_inv.validate(port) == []


def test_jax_is_the_torch_engine_and_unknown_engines_are_refused():
    art = run_replay(ReplayConfig(run_id="t", engine="jax", device="cpu",
                                  bars=24, profile="serve-smoke",
                                  serve_every_bars=100, reconcile_every_bars=100))
    assert art["extra"]["engine"] == "torch"
    with pytest.raises(ValueError, match="unknown replay engine"):
        ReplayConfig(engine="cuda").validate()


@pytest.mark.parametrize("which", ["REPLAY_r12.json"])
def test_committed_replay_artifacts_pass_the_ports_validator(which):
    path = os.path.join(_REPO, which)
    assert inv.detect_kind(json.load(open(path))) == "replay"
    assert inv.validate_file(path) == []


# the reference's doctored books (tests/test_replay.py): (mutation, the
# message both validators must give)
_DOCTORED = {
    "vanished_tick": (lambda a: a["ticks"].__setitem__(
        "applied", a["ticks"]["applied"] - 1), "tick accounting broken"),
    "feed_ledger_mismatch": (lambda a: a["ticks"].__setitem__(
        "dropped_gap", 7), "feed accounting broken"),
    "impossible_serve_version": (lambda a: a["versions"].__setitem__(
        "serve_max", a["versions"]["ingest_final"] + 5),
        "version reconciliation broken"),
    "unbalanced_serve_book": (lambda a: a["serve"]["requests"].__setitem__(
        "served", a["serve"]["requests"]["served"] + 1),
        "request accounting broken"),
    "skew_counter_mismatch": (lambda a: a["versions"].__setitem__(
        "skew_refusals", 3), "skew_refusals"),
    "unknown_schema": (lambda a: a.__setitem__("schema_version", 99),
                       "unknown schema_version"),
}


@pytest.mark.parametrize("validator", ["port", "reference"])
@pytest.mark.parametrize("case", sorted(_DOCTORED))
def test_doctored_replay_books_are_refused(stub_pairs, case, validator):
    mutate, message = _DOCTORED[case]
    bad = copy.deepcopy(stub_pairs[(False, None)][0])
    mutate(bad)
    check = inv if validator == "port" else ref_inv
    assert any(message in v for v in check.validate(bad, "replay"))


def test_late_tick_on_final_bar_does_not_read_as_drift():
    """A tick of the last bar held late lands at the end-of-log flush as
    applied into a consumed bar: it dirties the updaters like a merge."""
    from csmom_tpu_torch.chaos.plan import Fault, FaultPlan

    cfg = ReplayConfig(run_id="t_lastlate", engine="stub", profile="serve-smoke")
    total = cfg.n_assets * cfg.bars
    plan = FaultPlan("late-on-final-bar", seed=1, faults=(
        Fault(point="stream.tick", action="tick_late", after=total - 2,
              max_fires=1),))
    art = _armed_run(replay, inject, cfg, plan)
    assert inv.validate(art) == []
    assert art["reconcile"]["drift_events"] == 0
    assert art["reconcile"]["rebuilds"] >= 1
    assert art["ticks"]["offered"] == art["ticks"]["generated"]


def test_replay_capacity_must_hold_a_serve_window():
    with pytest.raises(ValueError, match="capacity"):
        ReplayConfig(capacity=8).validate()
    cfg = ReplayConfig(capacity=ReplayConfig().bars)
    cfg.validate()
    assert cfg.resolved_capacity() == cfg.bars == replay.REPLAY_SMOKE_BARS
    assert ReplayConfig().resolved_capacity() < ReplayConfig().bars


def test_synth_log_and_fault_plan_equal_the_reference():
    cfg = ReplayConfig(seed=5)
    ref_cfg = ref_replay.ReplayConfig(seed=5)
    a = replay.synth_tick_log(cfg)
    b = ref_replay.synth_tick_log(ref_cfg)
    assert [(t.asset, t.bar_time, t.price, t.volume, t.seq) for t in a] == \
        [(t.asset, t.bar_time, t.price, t.volume, t.seq) for t in b]
    assert replay.builtin_fault_plan(cfg).to_toml() == \
        ref_replay.builtin_fault_plan(ref_cfg).to_toml()


# ------------------------------------------------------------------- CLI ---

def _cli(argv, capsys):
    from csmom_tpu_torch.cli.main import main

    saved = os.environ.get(PLAN_ENV)
    try:
        rc = main(argv)
    finally:
        if saved is None:
            os.environ.pop(PLAN_ENV, None)
        else:
            os.environ[PLAN_ENV] = saved
        inject.reset()
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("engine_args", [["--stub"], ["--device", "cpu"]],
                         ids=["stub", "torch_cpu"])
def test_cli_replay_smoke_lands_a_valid_artifact(tmp_path, capsys, engine_args):
    rc, out, err = _cli(["replay", "--smoke", *engine_args, "--chaos", "builtin",
                         "--out-dir", str(tmp_path), "--json"], capsys)
    assert rc == 0, out + err
    path = tmp_path / "GPU_REPLAY_smoke.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    assert "stale request(s) refused" in out
    assert json.loads(out.strip().splitlines()[-1])["metric"] == "replay_ticks_per_s"
    art = json.loads(path.read_text())
    assert (art["reconcile"]["engine_checks"] > 0) == (engine_args != ["--stub"])


def test_cli_replay_defaults_to_the_card(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    rc, out, err = _cli(["replay", "--smoke", "--out-dir", str(tmp_path)], capsys)
    assert rc == 2 and "--device cpu" in err
    assert not list(tmp_path.iterdir())


# ------------------------------------------------------------ the ledger ----

def test_replay_pattern_in_tier1_sweep_and_ledger():
    import inspect

    from csmom_tpu_torch.obs import ledger

    sig = inspect.signature(inv.validate_tree)
    assert "GPU_REPLAY_*.json" in sig.parameters["patterns"].default
    assert "GPU_REPLAY_*.json" in ledger.DEFAULT_PATTERNS


def test_ledger_ingests_replay_rows(tmp_path, stub_pairs):
    from csmom_tpu_torch.obs import ledger
    from csmom_tpu_torch.serve.loadgen import write_artifact

    art = dict(stub_pairs[(False, None)][0], run_id="r99")
    write_artifact(str(tmp_path), art, prefix="GPU_REPLAY")
    led = ledger.load(str(tmp_path))
    metrics = {r.metric for r in led.rows}
    assert "replay_ticks_per_s" in metrics
    assert "replay_staleness_p99_ms" in metrics
    assert "replay_in_window_fresh_compiles" in metrics
    # smoke-bucket replays are flagged, never gate-eligible
    smoke_rows = [r for r in led.rows if r.metric == "replay_ticks_per_s"]
    assert smoke_rows and not any(r.gate_eligible() for r in smoke_rows)


def test_ledger_refuses_unknown_replay_schema(tmp_path, stub_pairs):
    from csmom_tpu_torch.obs import ledger

    art = dict(stub_pairs[(False, None)][0], run_id="r98", schema_version=42)
    path = tmp_path / "GPU_REPLAY_r98.json"
    path.write_text(json.dumps(art))
    led = ledger.load(str(tmp_path))
    assert led.rows == []
    assert any("unknown replay schema_version" in p["note"]
               for p in led.problems)
