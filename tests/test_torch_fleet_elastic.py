"""The port's elastic fleet tier on the CPU: hot spares, promotion, the
autoscaler, the prefork parent and the ``fleet.elastic`` block.

Mirrors ``tests/test_fleet_elastic.py`` case for case against the port's
modules (stub workers: no torch in any spawned process), its ledger case
on a ``GPU_FLEET_*`` name.  Added here:

- ``AutoscalerPolicy.decide`` gives the reference's decisions (action
  and reason) on one seeded ``(now, offered_rps, n_ready)`` sequence;
- a port ``fleet.elastic`` artifact passes the reference's validator;
- a stub worker forked by a ``PreforkServer`` process is polled through
  the parent, SIGKILLed and reaped, with the parent at one native thread
  and CUDA never initialized;
- ``spawn`` refuses to fork while a second thread is alive;
- a spare forked by the prefork parent is promoted into a killed slot,
  and the controller's stop leaves no process behind.

Every wait is bounded, and every spawned process is stopped in a
``finally``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.serve import fleet as ref_serve_fleet
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.obs import fleet as obs_fleet
from csmom_tpu_torch.obs import metrics
from csmom_tpu_torch.obs import spans as obs_spans
from csmom_tpu_torch.serve import fleet as serve_fleet
from csmom_tpu_torch.serve import health, proto
from csmom_tpu_torch.serve.fleet import (
    AutoscalerPolicy,
    FleetConfig,
    FleetController,
    PreforkServer,
)
from csmom_tpu_torch.serve.queue import AdmissionQueue
from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor
from csmom_tpu_torch.utils.deadline import mono_now_s

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_observatory():
    obs_fleet.disarm("test setup")
    metrics.reset()
    yield
    obs_fleet.disarm("test teardown")
    obs_spans.disarm()
    metrics.reset()


_SMOKE_POOL = dict(profile="serve-smoke", engine="stub",
                   ready_timeout_s=30.0, poll_interval_s=0.05,
                   backoff_base_s=0.05, backoff_cap_s=0.3)


def _poll(pred, timeout_s=10.0):
    give_up = time.monotonic() + timeout_s
    while time.monotonic() < give_up:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _events(sup, name):
    return [e for e in sup.summary()["events"] if e["event"] == name]


# -------------------------------------------------- autoscaler policy ----

def _policy(**over):
    kw = dict(high_rps_per_worker=10.0, low_rps_per_worker=2.0,
              sustain_s=1.0, cooldown_s=5.0, min_workers=1, max_workers=4)
    kw.update(over)
    return AutoscalerPolicy(**kw)


def test_policy_holds_inside_the_hysteresis_band():
    p = _policy()
    d = p.decide(0.0, 5.0, 1)
    assert d["action"] == "hold" and "band" in d["reason"]
    assert d["offered_rps"] == 5.0 and d["n_ready"] == 1


def test_policy_scale_up_requires_sustain_then_cools_down():
    p = _policy()
    assert p.decide(0.0, 50.0, 1)["action"] == "hold", "breach must sustain"
    d = p.decide(1.2, 50.0, 1)
    assert d["action"] == "scale_up" and "sustained" in d["reason"]
    d = p.decide(1.3, 50.0, 2)
    assert d["action"] == "hold" and "cooldown" in d["reason"], (
        "an action's dead time must absorb the follow-on breach — no "
        "thrash on a single burst")


def test_policy_scale_up_stops_at_the_declared_ceiling():
    p = _policy(cooldown_s=0.1)
    p.decide(0.0, 100.0, 4)
    d = p.decide(1.5, 100.0, 4)
    assert d["action"] == "hold" and "ceiling" in d["reason"], (
        "max_workers is a hard bound, not advice")


def test_policy_scale_down_requires_sustain_and_respects_floor():
    p = _policy()
    assert p.decide(0.0, 1.0, 2)["action"] == "hold"
    assert p.decide(1.5, 1.0, 2)["action"] == "scale_down"
    p2 = _policy()
    p2.decide(0.0, 1.0, 1)
    d = p2.decide(1.5, 1.0, 1)
    assert d["action"] == "hold" and "floor" in d["reason"]


def test_policy_band_dip_resets_the_sustain_timer():
    p = _policy()
    p.decide(0.0, 50.0, 1)          # above, sustaining
    p.decide(0.5, 5.0, 1)           # back in band: timer resets
    d = p.decide(1.2, 50.0, 1)
    assert d["action"] == "hold", (
        "a breach interrupted by an in-band tick must re-sustain from "
        "scratch — hysteresis exists to ignore blips")


def test_policy_refuses_an_inverted_band():
    with pytest.raises(ValueError, match="inverted"):
        _policy(low_rps_per_worker=20.0)


def test_policy_every_decision_is_reasoned():
    p = _policy(cooldown_s=0.5)
    t, seen = 0.0, []
    for rps in (0.0, 0.0, 50.0, 50.0, 50.0, 5.0, 0.5, 0.5, 0.5):
        d = p.decide(t, rps, 2)
        seen.append(d)
        t += 0.7
    for d in seen:
        assert d["action"] in ("scale_up", "scale_down", "hold")
        assert str(d["reason"]).strip(), d


# ------------------------------------------- capacity: spare reserve ----

def _ev(event, wid, t, **kw):
    return dict({"event": event, "worker_id": wid, "t_s": t}, **kw)


def test_spare_reserve_covers_the_kill_window():
    events = [
        _ev("ready", "w0", 0.0), _ev("ready", "w1", 0.0),
        _ev("ready", "w2", 0.0),
        _ev("spare_ready", "s0", 0.5),
        _ev("chaos_kill", "w1", 2.0),
        _ev("spare_promoted", "s0", 2.1),
        _ev("ready", "w1", 2.1, spawn_kind="spare-promotion"),
    ]
    cap = obs_fleet.capacity_account(events, 3, (0.0, 10.0))
    kw = cap["kill_windows"][0]
    assert kw["worker_id"] == "w1" and not kw["open_ended"]
    assert kw["loss_frac"] == pytest.approx(0.0), (
        "a kill window covered by a parked-ready spare is no capacity "
        "hole — the reserve credit is the whole point of the tier")
    assert cap["kill_window_loss_frac"] == pytest.approx(0.0)
    assert cap["spare_reserve_worker_s"] == pytest.approx(1.6), \
        "spare_ready 0.5 → spare_promoted 2.1"
    # the same kill WITHOUT the spare reads as the full hole
    bare = [e for e in events if not e["event"].startswith("spare")]
    cap2 = obs_fleet.capacity_account(bare, 3, (0.0, 10.0))
    assert cap2["kill_window_loss_frac"] == pytest.approx(1 / 3, abs=1e-3)


def test_spare_death_opens_no_kill_window():
    events = [
        _ev("ready", "w0", 0.0),
        _ev("spare_ready", "s0", 0.5),
        _ev("spare_death", "s0", 3.0),
    ]
    cap = obs_fleet.capacity_account(events, 1, (0.0, 10.0))
    assert cap["kill_windows"] == [], (
        "a parked spare dying costs no serving capacity — it was never "
        "routed")
    assert cap["spare_reserve_worker_s"] == pytest.approx(2.5)


def test_loss_fractions_never_read_negative():
    # spare reserve overlapping steady state pushes available past
    # nominal; the account must clamp, not report capacity conjured
    events = [
        _ev("ready", "w0", 0.0),
        _ev("spare_ready", "s0", 0.0),
        _ev("chaos_kill", "w0", 4.0),
        _ev("ready", "w0", 4.2),
    ]
    cap = obs_fleet.capacity_account(events, 1, (0.0, 10.0))
    assert cap["kill_window_loss_frac"] >= 0.0
    assert cap["steady_state_loss_frac"] >= 0.0
    for kw in cap["kill_windows"]:
        assert kw["loss_frac"] >= 0.0


# --------------------------------------------------- demand rate input ----

def test_demand_recent_rps_reads_the_open_window(tmp_path):
    agg = obs_fleet.arm("unit-elastic", cadence_s=60.0,
                        scratch_dir=str(tmp_path))
    try:
        assert agg.demand_recent_rps(2.0) == 0.0, (
            "before the window opens the control input must read 0, "
            "not poison the policy with stale buckets")
        obs_fleet.open_demand_window()
        for _ in range(6):
            obs_fleet.demand("offered", "interactive")
        for _ in range(3):
            obs_fleet.demand("offered", "bulk")
        assert agg.demand_recent_rps(2.0) > 0.0
        assert agg.demand_recent_rps(2.0, slo_class="bulk") > 0.0
        assert agg.demand_recent_rps(2.0, slo_class="bulk") < \
            agg.demand_recent_rps(2.0), "class filter narrows the sum"
        assert agg.demand_recent_rps(2.0, slo_class="nope") == 0.0
    finally:
        obs_fleet.disarm("unit over")


# ---------------------------------------------------- quota auto-tune ----

def test_retune_quota_retunes_the_live_bucket_in_place():
    q = AdmissionQueue(capacity=8)
    assert q.retune_quota("bulk", 32.0)
    b = q._buckets["bulk"]
    assert b.rate == 32.0 and b.burst == pytest.approx(48.0), \
        "burst defaults to 1.5x the retuned rate"
    assert q.retune_quota("bulk", 40.0, quota_burst=50.0)
    assert q._buckets["bulk"].burst == 50.0
    assert q.retune_quota("batch", 20.0), "the r10 alias resolves"
    assert q._buckets["bulk"].rate == 20.0


def test_retune_quota_refuses_unquotad_classes_and_bad_rates():
    q = AdmissionQueue(capacity=8)
    assert not q.retune_quota("interactive", 10.0), (
        "granting an unquota'd class a quota at runtime would change "
        "admission semantics, not tune them")
    assert not q.retune_quota("bulk", 0.0)
    assert not q.retune_quota("bulk", -5.0)


# ------------------------------------------- live pool: promotion seam ----

class _InFlightPublisher:
    """A routes publisher whose publish may be IN FLIGHT when the
    promotion lands — the promotion must queue behind it, not wedge."""

    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def publish_once(self):
        with self.lock:
            self.calls += 1


def test_promotion_fills_the_slot_with_a_publish_in_flight(tmp_path):
    cfg = PoolConfig(n_workers=1, **_SMOKE_POOL)
    sup = PoolSupervisor(cfg, str(tmp_path)).start()
    pub = _InFlightPublisher()
    fleet = None
    try:
        fleet = FleetController(
            sup, FleetConfig(spares=1, min_workers=1, max_workers=3),
            publisher=pub).start()
        assert len(fleet.spares) == 1, "start() waits for the spare"
        spare_id = fleet.spares[0].worker_id
        old_pid = sup.handles[0].proc.pid
        with pub.lock:  # a publish is in flight while the kill lands
            assert sup.kill_worker("w0", signal.SIGKILL)
            assert _poll(lambda: fleet.counts["promoted"] == 1)
        h = sup.handles[0]
        assert h.worker_id == "w0", "the slot keeps its own id"
        assert h.spawn_kind == "spare-promotion"
        assert h.generation == 1
        assert h.state == "ready"
        assert h.proc.pid != old_pid, "the spare's PROCESS fills the slot"
        assert _poll(lambda: pub.calls >= 1), (
            "promotion must publish routes once the in-flight publish "
            "releases — queued behind it, never skipped")
        (p,) = fleet.promotions
        assert p["victim"] == "w0" and p["spare"] == spare_id
        assert p["wall_s"] <= 1.5, (
            f"promotion wall {p['wall_s']}s — a parked-ready swap must "
            "be O(publish), nowhere near a re-warm")
        ready = _events(sup, "ready")
        assert ready[-1]["spawn_kind"] == "spare-promotion"
        assert ready[-1]["worker_id"] == "w0"
        # backfill refills the pool off the hot path
        assert _poll(lambda: any(s.state == "ready" for s in fleet.spares))
        assert fleet.counts["backfills"] >= 1
    finally:
        if fleet is not None:
            fleet.stop()
        sup.stop()


def test_double_kill_with_one_spare_rewarns_the_second_honestly(tmp_path):
    cfg = PoolConfig(n_workers=2, **_SMOKE_POOL)
    sup = PoolSupervisor(cfg, str(tmp_path)).start()
    fleet = None
    try:
        fleet = FleetController(
            sup, FleetConfig(spares=1, min_workers=2, max_workers=4)).start()
        assert sup.kill_worker("w0", signal.SIGKILL)
        assert sup.kill_worker("w1", signal.SIGKILL)
        assert _poll(lambda: all(h.generation >= 1 and h.state == "ready"
                                 for h in sup.handles), timeout_s=20.0)
        kinds = sorted(h.spawn_kind for h in sup.handles)
        # one slot promoted; the other re-warmed the slow way (unless
        # the backfilled second spare landed first, which is also legal
        # — but the books must SAY which happened)
        assert fleet.counts["promoted"] >= 1
        if "respawn" in kinds:
            assert _events(sup, "spare_promotion_missed"), (
                "a victim re-warmed because no spare was parked — the "
                "miss must be a booked event, not silence")
        ready = _events(sup, "ready")
        assert all(e.get("spawn_kind") in ("cold", "respawn",
                                           "spare-promotion")
                   for e in ready)
    finally:
        if fleet is not None:
            fleet.stop()
        sup.stop()


def test_spare_dying_parked_backfills_and_never_enters_the_books(tmp_path):
    cfg = PoolConfig(n_workers=1, **_SMOKE_POOL)
    sup = PoolSupervisor(cfg, str(tmp_path)).start()
    fleet = None
    try:
        fleet = FleetController(
            sup, FleetConfig(spares=1, min_workers=1, max_workers=3)).start()
        s0 = fleet.spares[0]
        s0.proc.kill()
        assert _poll(lambda: fleet.counts["died_parked"] >= 1)
        deaths = _events(sup, "spare_death")
        assert deaths and deaths[-1]["phase"] == "parked"
        # the backfill restores the reserve without touching the pool
        assert _poll(lambda: any(s.state == "ready" for s in fleet.spares),
                     timeout_s=20.0)
        assert sup.handles[0].generation == 0, (
            "a parked spare's death must not disturb the serving slot")
        spare_ids = set(fleet._all_spare_ids)
        walls = obs_fleet.lifecycle_walls(sup.summary()["events"])
        assert not spare_ids & {w["worker_id"] for w in walls}, (
            "spares must never land lifecycle samples")
        cap = obs_fleet.capacity_account(
            obs_fleet.absolute_events(sup.summary()["events"],
                                      sup.t0_mono_s),
            1, (sup.t0_mono_s, mono_now_s()))
        assert not [kw for kw in cap["kill_windows"]
                    if kw["worker_id"] in spare_ids], (
            "a spare death digs no capacity hole")
    finally:
        if fleet is not None:
            fleet.stop()
        sup.stop()


# ------------------------------------- elastic block schema + doctored ----

def _mini_elastic_artifact(tmp_path, run_id="r97"):
    """A REAL loopback capture with a consistent elastic block and a
    promotion-regime lifecycle sample."""
    agg = obs_fleet.arm(run_id, cadence_s=0.05, scratch_dir=str(tmp_path))
    obs_fleet.open_demand_window()
    t0 = mono_now_s()
    metrics.counter("unit.work").inc(2)
    for _ in range(5):
        obs_fleet.demand("offered", "interactive")
        obs_fleet.demand("admitted", "interactive")
    for _ in range(4):
        obs_fleet.demand("served", "interactive")
    assert _poll(lambda: any(b["samples"] >= 2 for b in
                             agg.snapshot()["processes"].values()))
    obs_fleet.disarm_emitter("drained for the unit")
    agg.close_all("run-end")
    events = [
        dict(_ev("ready", "w0", t0 - 0.5), generation=0, wall_s=6.5,
             spawn_kind="cold", walls={}),
        _ev("spare_ready", "s0", t0 - 0.4),
        _ev("chaos_kill", "w0", t0 + 0.01),
        _ev("spare_promoted", "s0", t0 + 0.02),
        dict(_ev("ready", "w0", t0 + 0.02), generation=1, wall_s=0.01,
             spawn_kind="spare-promotion", walls={}),
    ]
    elastic = {
        "armed": True, "spares_configured": 1, "prefork": False,
        "autoscale": True, "spare_ids": ["s0", "s1"],
        "spares": {"spawned": 2, "ready": 2, "promoted": 1,
                   "backfills": 1, "died_parked": 0},
        "promotions": [{"victim": "w0", "spare": "s0", "generation": 1,
                        "t_kill_s": 0.01, "t_ready_s": 0.02,
                        "wall_s": 0.01}],
        "promotions_missed": 0,
        "decisions": [{"t_s": 0.1, "action": "hold",
                       "reason": "2.0 rps/worker inside hysteresis band "
                                 "[5, 200]", "offered_rps": 2.0,
                       "n_ready": 1}],
        "quota": {"slo_class": "bulk", "floor_rps": 8.0,
                  "ceiling_rps": 64.0,
                  "applied": [{"t_s": 0.2, "slo_class": "bulk",
                               "quota_rps": 12.0,
                               "applied_to": ["w0"]}]},
        "bounds": {"min_workers": 1, "max_workers": 3},
    }
    art = obs_fleet.build_artifact(
        agg, run_id,
        requests={"admitted": 5, "served": 4, "rejected": 1, "expired": 0},
        worker_events=events, n_workers=1, window=(t0, t0 + 0.2),
        fresh_compiles=0, platform="stub", workload="unit loopback",
        elastic=elastic)
    obs_fleet.disarm("unit over")
    return art


def test_elastic_block_validates_and_splits_walls_by_kind(tmp_path):
    art = _mini_elastic_artifact(tmp_path)
    assert inv.validate(art, "fleet") == []
    samples = art["extra"]["samples"]
    assert samples["fleet_worker_ready_wall_cold_s"] == [6.5]
    assert samples["fleet_worker_ready_wall_promotion_s"] == [0.01], (
        "promotion-regime walls gate against their own kind, never "
        "averaged into the cold-spawn distribution")


def test_elastic_schema_refuses_doctored_evidence(tmp_path):
    art = _mini_elastic_artifact(tmp_path)

    def doctored(mutate):
        obj = json.loads(json.dumps(art))
        mutate(obj)
        return inv.validate(obj, "fleet")

    def _time_travel(o):
        o["elastic"]["promotions"][0]["t_ready_s"] = -5.0
    assert any("before the kill" in v for v in doctored(_time_travel))

    def _spare_in_lifecycle(o):
        o["lifecycle"]["events"].append(
            {"worker_id": "s0", "generation": 0, "kind": "cold",
             "wall_s": 0.5, "walls": {}})
    assert any("held out of the serving lifecycle" in v
               for v in doctored(_spare_in_lifecycle))

    def _spare_kill_window(o):
        o["capacity"]["kill_windows"].append(
            {"worker_id": "s0", "t_kill_s": 0.1, "t_ready_s": 0.2,
             "open_ended": False, "width_s": 0.1, "loss_frac": 1.0})
    assert any("digs no capacity hole" in v
               for v in doctored(_spare_kill_window))

    def _double_promotion(o):
        p = dict(o["elastic"]["promotions"][0])
        p["generation"] = 2
        o["elastic"]["promotions"].append(p)
        o["elastic"]["spares"]["promoted"] = 2
    assert any("promoted twice" in v for v in doctored(_double_promotion))

    def _counter_mismatch(o):
        o["elastic"]["spares"]["promoted"] = 3
    assert any("promotion records" in v
               for v in doctored(_counter_mismatch))

    def _unreasoned(o):
        o["elastic"]["decisions"][0]["reason"] = "  "
    assert any("reasoned event" in v for v in doctored(_unreasoned))

    def _bad_action(o):
        o["elastic"]["decisions"][0]["action"] = "yolo"
    assert any("unknown" in v for v in doctored(_bad_action))

    def _quota_breach(o):
        o["elastic"]["quota"]["applied"][0]["quota_rps"] = 9999.0
    assert any("declared bounds" in v for v in doctored(_quota_breach))

    def _undeclared_spare(o):
        o["elastic"]["promotions"][0]["spare"] = "sX"
    assert any("not a declared spare" in v
               for v in doctored(_undeclared_spare))


# ------------------------------------------------------ across packages ----

def test_policy_decisions_equal_the_reference():
    """One seeded demand sequence through both packages' policies: the
    same actions with the same reasons, tick for tick."""
    import random

    rng = random.Random(20)
    kw = dict(high_rps_per_worker=200.0, low_rps_per_worker=5.0,
              sustain_s=1.5, cooldown_s=5.0, min_workers=3, max_workers=5)
    port, ref = AutoscalerPolicy(**kw), ref_serve_fleet.AutoscalerPolicy(**kw)
    t, n_ready = 100.0, 3
    mine, theirs = [], []
    for _ in range(400):
        t += rng.choice((0.25, 0.5, 0.5, 1.0))
        regime = rng.random()
        rps = (rng.uniform(0.0, 20.0) if regime < 0.4
               else rng.uniform(500.0, 1200.0) if regime < 0.7
               else rng.uniform(20.0, 500.0))
        a, b = port.decide(t, rps, n_ready), ref.decide(t, rps, n_ready)
        mine.append(a)
        theirs.append(b)
        if a["action"] == "scale_up":
            n_ready += 1
        elif a["action"] == "scale_down":
            n_ready -= 1
    assert mine == theirs
    actions = {d["action"] for d in mine}
    assert {"scale_up", "scale_down", "hold"} <= actions, actions


def test_port_elastic_artifact_passes_the_reference_validator(tmp_path):
    art = _mini_elastic_artifact(tmp_path)
    p = tmp_path / "GPU_FLEET_r97.json"
    with open(p, "w") as f:
        json.dump(art, f)
    assert ref_inv.validate_file(str(p)) == [] == inv.validate_file(str(p))


# --------------------------------------------------------- prefork parent ----

def _start_prefork(tmp_path, name="prefork"):
    """A prefork parent process on a unix socket under ``tmp_path``,
    started the way the controller starts one (the one-thread
    environment), and its address once it answers ``ping``."""
    addr = str(tmp_path / f"{name}.sock")
    env = {**os.environ, "PYTHONPATH": _REPO, **serve_fleet.PREFORK_THREAD_ENV}
    log = open(tmp_path / f"{name}.log", "ab")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "csmom_tpu_torch.serve.fleet", "--socket",
             addr, "--preimport", serve_fleet.PREFORK_IMPORTS["stub"]],
            stdout=log, stderr=log, env=env)
    finally:
        log.close()

    def pinged():
        try:
            return proto.request_once(addr, {"op": "ping"},
                                      timeout_s=2.0)[0].get("state") == "ok"
        except (OSError, proto.ProtocolError):
            return False

    assert _poll(pinged, timeout_s=30.0), (tmp_path / f"{name}.log").read_text()
    return proc, addr


def _shutdown_prefork(proc, addr):
    try:
        proto.request_once(addr, {"op": "shutdown"}, timeout_s=5.0)
    except (OSError, proto.ProtocolError):
        pass
    try:
        proc.wait(timeout=15.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5.0)


def _alive(pid):
    """True while ``pid`` exists at all (a zombie included)."""
    return os.path.exists(f"/proc/{pid}")


def test_prefork_child_is_polled_through_the_parent_killed_and_reaped(
        tmp_path):
    proc, addr = _start_prefork(tmp_path)
    child_pid = None
    try:
        ping, _ = proto.request_once(addr, {"op": "ping"}, timeout_s=5.0)
        assert ping["imported"] == ["csmom_tpu_torch.serve.worker"]
        assert ping["native_threads"] == 1
        assert ping["cuda_initialized"] is False
        w_addr = str(tmp_path / "s0.sock")
        reply, _ = proto.request_once(addr, {
            "op": "spawn",
            "argv": ["--socket", w_addr, "--engine", "stub", "--profile",
                     "serve-smoke", "--worker-id", "s0"],
            "log_path": str(tmp_path / "s0.log")}, timeout_s=10.0)
        assert reply["state"] == "ok", reply
        assert reply["native_threads"] == 1 and not reply["cuda_initialized"]
        child_pid = reply["pid"]
        child = serve_fleet._PreforkChild(child_pid, addr)
        assert _poll(lambda: health.readiness(w_addr, timeout_s=2.0)
                     .get("ok"), timeout_s=30.0)
        assert child.poll() is None, "a live child polls as running"
        os.kill(child_pid, signal.SIGKILL)
        assert child.wait(timeout=10.0) == -signal.SIGKILL, (
            "the parent's waitpid status: killed by SIGKILL")
        assert not _alive(child_pid), "the parent reaped the child"
        again, _ = proto.request_once(addr, {"op": "ping"}, timeout_s=5.0)
        assert again["children"] == 1 and again["native_threads"] == 1
    finally:
        if child_pid is not None and _alive(child_pid):
            try:
                os.kill(child_pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        _shutdown_prefork(proc, addr)
    assert proc.returncode == 0


def test_spawn_refuses_to_fork_while_a_second_thread_is_alive():
    """The parent forks only with one native thread alive: in a process
    with another thread running, ``spawn`` refuses and forks nothing."""
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    t.start()
    try:
        srv = PreforkServer("unused.sock")
        assert serve_fleet.native_threads() > 1
        reply = srv.handle({"op": "spawn", "argv": ["--help"]})
        assert reply["state"] == "rejected"
        assert "native threads" in reply["error"]
        assert reply["native_threads"] > 1
        assert srv._children == {}, "nothing was forked"
    finally:
        stop.set()
        t.join(timeout=5.0)


def test_prefork_spare_is_promoted_and_every_process_stops(tmp_path):
    """``--prefork`` with one spare: the spare comes from the parent,
    fills a SIGKILLed slot, and the controller's stop drains the
    promoted child and shuts the parent down, leaving no process.  The
    drain happens while the supervisor's monitor still runs, so the
    handle is out of "ready" first: the planned stop books no death (a
    death there opened a kill window after the measured one and made a
    fleet artifact invalid)."""
    cfg = PoolConfig(n_workers=1, **_SMOKE_POOL)
    sup = PoolSupervisor(cfg, str(tmp_path)).start()
    fleet = None
    pids = []
    try:
        fleet = FleetController(
            sup, FleetConfig(spares=1, prefork=True, min_workers=1,
                             max_workers=2)).start()
        spawn = _events(sup, "spare_spawn")
        assert spawn and spawn[0]["via"] == "prefork"
        assert spawn[0]["native_threads"] == 1
        assert spawn[0]["cuda_initialized"] is False
        assert _events(sup, "prefork_ready")[0]["native_threads"] == 1
        prefork_pid = fleet._prefork_proc.pid
        spare_pid = fleet.spares[0].proc.pid
        pids += [prefork_pid, spare_pid]
        assert sup.kill_worker("w0", signal.SIGKILL)
        assert _poll(lambda: fleet.counts["promoted"] == 1)
        assert sup.handles[0].proc.pid == spare_pid
        assert isinstance(sup.handles[0].proc, serve_fleet._PreforkChild)
        assert _poll(lambda: any(s.state == "ready" for s in fleet.spares))
        pids.append(fleet.spares[0].proc.pid)
        assert fleet.summary()["prefork"] is True
        drained = []
        drain_stop = sup._drain_stop

        def recording_drain_stop(h, *a, **kw):
            drained.append((h.worker_id, h.state))
            return drain_stop(h, *a, **kw)

        sup._drain_stop = recording_drain_stop
        deaths = len(_events(sup, "death"))
        fleet.stop()
        time.sleep(3 * _SMOKE_POOL["poll_interval_s"])
        assert ("w0", "draining") in drained, drained
        assert len(_events(sup, "death")) == deaths
    finally:
        if fleet is not None:
            fleet.stop()
        sup.stop()
    assert _poll(lambda: not any(_alive(p) for p in pids), timeout_s=10.0), (
        [p for p in pids if _alive(p)])


def test_demand_rate_reads_a_steady_rate_at_any_instant(monkeypatch):
    """At a steady 100 arrivals a second the port's trailing rate reads
    100 at the start, the middle and the end of a one-second bucket; the
    reference's reads half of it at a bucket's start (it divides by the
    horizon's whole width) and so sees a sawtooth the autoscaler's
    sustain timer keeps resetting on (ROADMAP.md, known difference 28)."""
    from csmom_tpu.obs import fleet as ref_fleet

    clock = {"t": 1000.0}
    readings = {}
    for mod, name in ((obs_fleet, "port"), (ref_fleet, "reference")):
        monkeypatch.setattr(mod, "mono_now_s", lambda: clock["t"])
        agg = mod.FleetAggregator("unit-rate", cadence_s=60.0)
        clock["t"] = 1000.0
        agg.open_demand_window()
        readings[name] = []
        marks = [1004.995, 1005.005, 1005.505]  # a bucket's end, start, middle
        for i in range(600):                 # 6 s at 100/s
            clock["t"] = 1000.0 + i / 100.0
            agg.note_demand("offered", "interactive")
            while marks and clock["t"] + 0.01 > marks[0]:
                clock["t"] = marks.pop(0)
                readings[name].append(agg.demand_recent_rps(2.0))
    assert readings["port"] == pytest.approx([100.0, 100.0, 100.0], rel=0.02)
    assert readings["reference"][1] == pytest.approx(50.0, rel=0.02)
    # the first second reads over one second, never a burst of a few
    # events over a few milliseconds
    monkeypatch.setattr(obs_fleet, "mono_now_s", lambda: clock["t"])
    agg = obs_fleet.FleetAggregator("unit-rate", cadence_s=60.0)
    clock["t"] = 2000.0
    agg.open_demand_window()
    for _ in range(3):
        agg.note_demand("offered", "bulk")
    clock["t"] = 2000.01
    assert agg.demand_recent_rps(2.0) == pytest.approx(3.0)


class _FakeSupervisor:
    """What the autoscale loop touches of a supervisor: a new slot's
    process stays ``starting`` (a cold worker warming) until the test
    says it is ready."""

    slot_prefix = "w"

    def __init__(self, n: int, run_dir: str):
        from csmom_tpu_torch.serve.supervisor import WorkerHandle

        self.run_dir = run_dir
        self.config = PoolConfig(n_workers=n, **_SMOKE_POOL)
        self.t0_mono_s = mono_now_s()
        self.events = []
        self.handles = [WorkerHandle(slot=i, worker_id=f"w{i}",
                                     socket_path=f"{run_dir}/w{i}.sock",
                                     state="ready") for i in range(n)]

    def ready_workers(self):
        return [h for h in self.handles if h.state == "ready"]

    def _slot_address(self, slot, generation=0):
        return f"{self.run_dir}/w{slot}.sock"

    def _spawn(self, h):
        h.state = "starting"

    def _probe_until_ready(self, h, timeout_s):
        return False

    def _event(self, event, worker_id, **ctx):
        self.events.append({"event": event, "worker_id": worker_id, **ctx})


class _FakeDemand:
    def __init__(self, rps):
        self.rps = rps

    def demand_recent_rps(self, horizon_s=3.0, event="offered",
                          slo_class=None):
        return 0.0 if slo_class else self.rps


def test_autoscaler_asks_no_decision_while_a_worker_warms(tmp_path):
    """Under a sustained burst with the cooldown over, a scale-up still
    warming holds the loop: the fleet never passes its declared ceiling
    counting the worker that is not ready yet (the reference's loop asks
    its policy with the ready count alone and spawns a second worker
    once the cooldown ends; ROADMAP.md, known difference 30)."""
    wsup = _FakeSupervisor(2, str(tmp_path))
    ctl = FleetController(wsup, FleetConfig(
        autoscale=True, min_workers=2, max_workers=3, sustain_s=0.0,
        cooldown_s=0.0, high_rps_per_worker=10.0, low_rps_per_worker=1.0),
        aggregator=_FakeDemand(1000.0))
    for _ in range(5):
        ctl._autoscale_tick()
    assert [h.worker_id for h in wsup.handles] == ["w0", "w1", "w2"]
    assert wsup.handles[-1].state == "starting"
    actions = [d["action"] for d in ctl.decisions]
    assert actions.count("scale_up") == 1
    warming = [d for d in ctl.decisions if d["action"] == "hold"]
    assert warming and "w2 warming" in warming[0]["reason"]
    # once it is ready, the ceiling is the policy's to hold
    wsup.handles[-1].state = "ready"
    ctl._autoscale_tick()
    assert ctl.decisions[-1]["action"] == "hold"
    assert "ceiling" in ctl.decisions[-1]["reason"]
    assert len(wsup.handles) == 3


def test_ledger_ingests_per_kind_ready_wall_rows(tmp_path):
    art = _mini_elastic_artifact(tmp_path)
    with open(tmp_path / "GPU_FLEET_r97.json", "w") as f:
        json.dump(art, f)
    from csmom_tpu_torch.obs import ledger as ld

    L = ld.load(str(tmp_path))
    rows = {r.metric: r for r in L.rows}
    agg = rows["fleet_worker_ready_wall_s"]
    assert agg.value == pytest.approx(6.5), "aggregate keeps the max"
    promo = rows["fleet_worker_ready_wall_promotion_s"]
    assert promo.direction == "lower"
    assert promo.value == pytest.approx(0.01)
    assert list(promo.samples) == [0.01]
    cold = rows["fleet_worker_ready_wall_cold_s"]
    assert cold.value == pytest.approx(6.5)
