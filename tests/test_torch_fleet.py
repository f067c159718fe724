"""The port's fleet observatory on the CPU: snapshot deltas, the
emitter/aggregator loop, the capacity account and the ``fleet``
artifact's schema.

Mirrors ``tests/test_fleet.py`` case for case against the port's
modules, its ledger and committable-name cases on the port's
``GPU_FLEET_*`` names.  Added here:

- ``capacity_account``, ``lifecycle_walls`` and ``absolute_events`` give
  equal output in both packages on the same event lists;
- the reference's committed ``FLEET_r20.json`` and ``FLEET_r21.json``
  pass the port's validator, and a port artifact the reference's;
- a router replica streaming to an armed aggregator still never loads
  torch.

Every wait is bounded, and every armed aggregator is disarmed in a
fixture.
"""

import gc
import json
import os
import subprocess
import sys
import time

import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.obs import fleet as ref_fleet
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.obs import fleet as obs_fleet
from csmom_tpu_torch.obs import metrics
from csmom_tpu_torch.obs import spans as obs_spans
from csmom_tpu_torch.serve import health, proto
from csmom_tpu_torch.serve.fabric import (
    FabricClient,
    FabricClientConfig,
    write_routes,
)
from csmom_tpu_torch.utils.deadline import mono_now_s

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": _REPO}


@pytest.fixture(autouse=True)
def _clean_observatory():
    obs_fleet.disarm("test setup")
    metrics.reset()
    yield
    obs_fleet.disarm("test teardown")
    obs_spans.disarm()
    metrics.reset()


def _snap():
    return metrics.snapshot(include_compile=False)


# ------------------------------------------ snapshot identity + deltas ----

def test_snapshot_carries_identity_and_advancing_seq():
    obs_spans.arm(None, run_id="fleet-unit", proc="t")
    metrics.set_identity("worker", "w3")
    s1, s2 = _snap(), _snap()
    assert s2["seq"] > s1["seq"], "seq is a per-process lifetime counter"
    assert s1["identity"] == {"pid": os.getpid(), "role": "worker",
                              "slot": "w3"}


def test_snapshot_delta_counters_gauges_and_histograms():
    obs_spans.arm(None, run_id="fleet-unit", proc="t")
    c = metrics.counter("unit.reqs")
    g = metrics.gauge("unit.depth")
    h = metrics.histogram("unit.lat")
    c.inc(3)
    g.set(5)
    h.observe(1.0)
    prev = _snap()
    c.inc(2)
    g.set(9)
    h.observe(2.0)
    h.observe(3.0)
    d = metrics.snapshot_delta(prev, _snap())
    assert d["counters"]["unit.reqs"] == 2, "counters delta"
    assert d["gauges"]["unit.depth"] == 9, "gauges carry current value"
    assert d["histograms"]["unit.lat"]["count"] == 2


def test_snapshot_delta_refuses_splices_and_regressions():
    obs_spans.arm(None, run_id="fleet-unit", proc="t")
    metrics.counter("unit.reqs").inc()
    prev, cur = _snap(), _snap()
    other = json.loads(json.dumps(cur))
    other["identity"]["pid"] = prev["identity"]["pid"] + 1
    with pytest.raises(ValueError, match="across processes"):
        metrics.snapshot_delta(prev, other)
    with pytest.raises(ValueError, match="advancing seq"):
        metrics.snapshot_delta(cur, prev)
    doctored = json.loads(json.dumps(prev))
    doctored["counters"]["unit.reqs"] = 99
    with pytest.raises(ValueError, match="monotone"):
        metrics.snapshot_delta(doctored, cur)


# ------------------------------------------------- disarmed = zero cost ----

def test_disarmed_demand_hook_is_allocation_free():
    assert not obs_fleet.armed()
    for _ in range(2000):  # warm the code path first
        obs_fleet.demand("offered", "interactive")
        obs_fleet.open_demand_window()
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(5000):
        obs_fleet.demand("offered", "interactive")
    gc.collect()
    grown = sys.getallocatedblocks() - before
    assert grown < 50, (
        f"disarmed demand hooks allocated {grown} blocks over 5000 calls "
        "— the unarmed serve submit path must pay one load + compare")


# --------------------------------------------- emitter/aggregator loop ----

def test_arm_exports_env_contract_and_disarm_retracts(tmp_path):
    agg = obs_fleet.arm("unit-run", cadence_s=60.0,
                        scratch_dir=str(tmp_path))
    try:
        assert obs_fleet.armed()
        assert obs_fleet.current_aggregator() is agg
        assert os.environ[obs_fleet.ENV_ADDR] == agg.address
        assert os.environ[obs_fleet.ENV_RUN] == "unit-run"
        assert float(os.environ[obs_fleet.ENV_CADENCE]) == 60.0
    finally:
        obs_fleet.disarm("unit over")
    assert not obs_fleet.armed()
    for k in (obs_fleet.ENV_ADDR, obs_fleet.ENV_RUN,
              obs_fleet.ENV_CADENCE):
        assert k not in os.environ, f"disarm must retract {k}"
    assert obs_fleet.arm_emitter_from_env("worker", "w0") is None, (
        "after disarm a fresh spawn must stay dark, not dial a dead "
        "socket")


def _poll(pred, timeout_s=5.0):
    give_up = time.monotonic() + timeout_s
    while time.monotonic() < give_up:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_loopback_stream_opens_at_arm_and_fin_closes(tmp_path):
    agg = obs_fleet.arm("unit-run", cadence_s=0.05,
                        scratch_dir=str(tmp_path))
    try:
        metrics.counter("unit.work").inc(4)
        # the hello frame opens the book at arm time; cadence ticks add
        # samples and carry the counter delta
        assert _poll(lambda: any(
            b["samples"] >= 2
            for b in agg.snapshot()["processes"].values()))
        obs_fleet.disarm_emitter("drained for the unit")
        snap = agg.snapshot()
        (name, book), = snap["processes"].items()
        assert name.startswith("loadgen@")
        assert book["closed"] and book["close_reason"] == \
            "fin: drained for the unit"
        assert book["first_seq"] == 1 and book["seq_gaps"] == 0
        series = snap["points"][f"{name}|unit.work"]
        assert series["kind"] == "counter"
        assert series["v"][-1] == 4.0, "cum reconstruction from deltas"
        assert all(b >= a for a, b in zip(series["v"], series["v"][1:])), \
            "counter series are monotone by construction"
    finally:
        obs_fleet.disarm("unit over")


def test_severed_connection_reason_closes_the_stream_book(tmp_path):
    agg = obs_fleet.arm("unit-run", cadence_s=60.0,
                        scratch_dir=str(tmp_path))
    try:
        # a second process's emitter, long cadence: only the hello frame
        em = obs_fleet.FleetEmitter(agg.address, "unit-run", "worker",
                                    "w9", cadence_s=60.0).start()
        proc = em.proc
        assert _poll(lambda: proc in agg.snapshot()["processes"])
        # kill the connection WITHOUT a fin — the SIGKILL signature
        em._stop.set()
        em._channel.close("unit: abrupt death")
        assert _poll(lambda: agg.snapshot()["processes"][proc]["closed"])
        reason = agg.snapshot()["processes"][proc]["close_reason"]
        assert "severed" in reason, (
            f"EOF without fin closed as {reason!r} — a killed emitter "
            "must read as a reason-closed gap, never silence")
    finally:
        obs_fleet.disarm("unit over")


def test_dead_aggregator_costs_counted_drops_never_a_crash(tmp_path):
    em = obs_fleet.FleetEmitter(
        str(tmp_path / "nobody-listens.sock"), "unit-run", "worker", "w0",
        cadence_s=60.0).start()
    try:
        assert em.dropped == 1, "the hello frame's failure is COUNTED"
        em._tick()
        assert em.dropped == 2, "every failed tick is one counted drop"
    finally:
        em.stop("unit over")


# ---------------------------------------------------- capacity account ----

def _ev(event, wid, t):
    return {"event": event, "worker_id": wid, "t_s": t}


def test_capacity_account_kill_window_and_death_dedup():
    events = [
        _ev("ready", "w0", 0.0), _ev("ready", "w1", 0.0),
        _ev("chaos_kill", "w1", 2.0),
        # the monitor's death notice for the SAME incident must not
        # double-open the window
        _ev("death", "w1", 2.1),
        _ev("ready", "w1", 4.0),
    ]
    cap = obs_fleet.capacity_account(events, 2, (0.0, 10.0))
    assert len(cap["kill_windows"]) == 1, "one incident, one window"
    kw = cap["kill_windows"][0]
    assert kw["worker_id"] == "w1" and not kw["open_ended"]
    assert kw["t_kill_s"] == pytest.approx(2.0)
    assert kw["t_ready_s"] == pytest.approx(4.0)
    assert kw["width_s"] == pytest.approx(2.0)
    assert cap["nominal_worker_s"] == pytest.approx(20.0)
    assert cap["available_worker_s"] == pytest.approx(18.0)
    assert kw["loss_frac"] == pytest.approx(0.5), \
        "one of two slots dark across the window"
    assert cap["kill_window_loss_frac"] == pytest.approx(0.5)
    assert cap["steady_state_loss_frac"] == pytest.approx(0.0), \
        "steady-state loss ~ 0 is a measured result, not an assumption"


def test_capacity_account_organic_death_digs_the_same_hole():
    events = [_ev("ready", "w0", 0.0), _ev("death", "w0", 3.0),
              _ev("ready", "w0", 5.0)]
    cap = obs_fleet.capacity_account(events, 1, (0.0, 10.0))
    assert len(cap["kill_windows"]) == 1, (
        "a monitor-detected death (or a fault-plan self-kill inside the "
        "worker) is the same capacity hole as an explicit chaos kill")
    assert cap["kill_windows"][0]["width_s"] == pytest.approx(2.0)


def test_capacity_account_unreplaced_victim_stays_open_ended():
    events = [_ev("ready", "w0", 0.0), _ev("chaos_kill", "w0", 6.0)]
    cap = obs_fleet.capacity_account(events, 1, (0.0, 10.0))
    kw = cap["kill_windows"][0]
    assert kw["open_ended"], "the capacity never came back in-window"
    assert kw["t_ready_s"] == pytest.approx(10.0)
    assert cap["available_worker_s"] == pytest.approx(6.0)


def test_lifecycle_walls_one_sample_per_respawn():
    events = [
        {"event": "spawn", "worker_id": "w0", "t_s": 0.0},
        {"event": "ready", "worker_id": "w0", "t_s": 1.4,
         "generation": 0, "wall_s": 1.4,
         "walls": {"main_to_bind_s": 0.2, "warm_s": 0.9}},
        {"event": "death", "worker_id": "w0", "t_s": 3.0},
        {"event": "ready", "worker_id": "w0", "t_s": 4.2,
         "generation": 1, "wall_s": 1.1, "walls": {}},
    ]
    walls = obs_fleet.lifecycle_walls(events)
    assert [w["generation"] for w in walls] == [0, 1]
    assert [w["wall_s"] for w in walls] == [1.4, 1.1]
    assert walls[0]["walls"]["warm_s"] == 0.9


def test_absolute_events_shift_onto_the_shared_mono_timeline():
    shifted = obs_fleet.absolute_events(
        [_ev("ready", "w0", 1.5)], 1000.0)
    assert shifted[0]["t_s"] == pytest.approx(1001.5)


# ------------------------------------- artifact schema + doctored bytes ----

def _mini_fleet_artifact(tmp_path, run_id="r99"):
    """A REAL loopback capture: armed aggregator + local emitter, a
    demand window, synthetic supervisor events — the smallest artifact
    the schema accepts."""
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
        dict(_ev("ready", "w0", t0 - 0.5), generation=0, wall_s=1.2,
             walls={}),
        _ev("chaos_kill", "w0", t0 + 0.01),
        dict(_ev("ready", "w0", t0 + 0.05), generation=1, wall_s=1.3,
             walls={}),
    ]
    art = obs_fleet.build_artifact(
        agg, run_id,
        requests={"admitted": 5, "served": 4, "rejected": 1,
                  "expired": 0},
        worker_events=events, n_workers=1, window=(t0, t0 + 0.2),
        fresh_compiles=0, platform="stub", workload="unit loopback")
    obs_fleet.disarm("unit over")
    return art


def test_fleet_artifact_validates_and_refuses_doctored_bytes(tmp_path):
    art = _mini_fleet_artifact(tmp_path)
    assert inv.validate(art, "fleet") == []
    assert inv.detect_kind(art) == "fleet", "kind detection by signature"

    def doctored(mutate):
        obj = json.loads(json.dumps(art))
        mutate(obj)
        return inv.validate(obj, "fleet")

    # a counter series edited to decrease after landing
    def _bend_counter(obj):
        for s in obj["series"]["points"].values():
            if s["kind"] == "counter" and len(s["v"]) >= 2:
                s["v"][-1] = s["v"][-2] - 1
                return
        pytest.fail("no counter series with >= 2 samples to doctor")
    assert any("monotone" in v for v in doctored(_bend_counter))

    # demand totals no longer matching the embedded serve book
    def _bend_demand(obj):
        obj["demand"]["classes"]["interactive"]["served"] += 1
        obj["demand"]["per_second"][0]["interactive"]["served"] = \
            obj["demand"]["per_second"][0]["interactive"].get(
                "served", 0) + 1
    assert any("unreconciled demand" in v for v in doctored(_bend_demand))

    # per-second buckets disagreeing with the class totals
    def _bend_buckets(obj):
        obj["demand"]["per_second"][0]["interactive"]["offered"] += 2
    assert any("cannot disagree" in v for v in doctored(_bend_buckets))

    # a series from a process the aggregator never opened
    def _orphan(obj):
        obj["series"]["points"]["ghost|unit.x"] = {
            "proc": "ghost", "metric": "unit.x", "kind": "gauge",
            "t_s": [0.0], "v": [1.0]}
    assert any("orphan series" in v for v in doctored(_orphan))

    # a stream book left open (silent truncation)
    def _unclose(obj):
        book = next(iter(obj["series"]["processes"].values()))
        book["closed"] = False
        book["close_reason"] = None
    assert any("reason-closed" in v for v in doctored(_unclose))

    # an unknown schema era must be refused whole, not half-parsed
    def _era(obj):
        obj["schema_version"] = 99
    assert any("schema_version" in v for v in doctored(_era))


def test_validate_file_and_tree_pick_up_fleet(tmp_path):
    art = _mini_fleet_artifact(tmp_path)
    p = tmp_path / "GPU_FLEET_r99.json"
    with open(p, "w") as f:
        json.dump(art, f)
    assert inv.validate_file(str(p)) == []
    bad = json.loads(json.dumps(art))
    bad["capacity"]["kill_window_loss_frac"] = 1.5
    with open(tmp_path / "GPU_FLEET_r98.json", "w") as f:
        json.dump(bad, f)
    report = inv.validate_tree(str(tmp_path))
    assert report.get("GPU_FLEET_r99.json") == []
    assert report.get("GPU_FLEET_r98.json"), (
        "validate_tree must sweep the GPU_FLEET family and surface the "
        "damaged artifact")


# ------------------------------------------------------ across packages ----

def _event_lists():
    """Seeded supervisor event lists: kills, deaths, respawns, spare
    intervals, promotions, unreplaced victims, two slots dark at once."""
    import random

    rng = random.Random(20)
    lists = []
    for _ in range(6):
        events, t = [], 0.0
        for w in ("w0", "w1", "w2"):
            events.append(dict(_ev("ready", w, rng.uniform(0.0, 0.5)),
                               generation=0, wall_s=rng.uniform(5, 9),
                               spawn_kind="cold",
                               walls={"main_to_bind_s": 0.3,
                                      "warm_s": rng.uniform(1, 2)}))
        events.append(_ev("spare_ready", "s0", rng.uniform(0.2, 1.0)))
        for _k in range(rng.randint(1, 4)):
            t += rng.uniform(0.3, 2.0)
            w = rng.choice(("w0", "w1", "w2"))
            events.append(_ev(rng.choice(("chaos_kill", "death")), w, t))
            if rng.random() < 0.3:
                events.append(_ev("death", w, t + 0.05))
            if rng.random() < 0.8:
                back = t + rng.uniform(0.001, 3.0)
                kind = rng.choice(("respawn", "spare-promotion"))
                if kind == "spare-promotion":
                    events.append(_ev("spare_promoted", "s0", back))
                events.append(dict(_ev("ready", w, back), generation=_k + 1,
                                   wall_s=back - t, spawn_kind=kind,
                                   walls={}))
        if rng.random() < 0.5:
            events.append(_ev("spare_death", "s0", t + 1.0))
        rng.shuffle(events)
        lists.append(events)
    return lists


@pytest.mark.parametrize("events", _event_lists(),
                         ids=[f"seeded{i}" for i in range(6)])
def test_capacity_walls_and_events_equal_the_reference(events):
    """The port's capacity account, lifecycle walls and absolute shift
    give what ``csmom_tpu.obs.fleet`` gives on the same event lists."""
    for n_slots, window in ((3, (0.0, 10.0)), (4, (0.5, 6.0))):
        assert (obs_fleet.capacity_account(events, n_slots, window)
                == ref_fleet.capacity_account(events, n_slots, window))
    assert (obs_fleet.lifecycle_walls(events)
            == ref_fleet.lifecycle_walls(events))
    assert (obs_fleet.absolute_events(events, 1234.5)
            == ref_fleet.absolute_events(events, 1234.5))


@pytest.mark.parametrize("name", ["FLEET_r20.json", "FLEET_r21.json"])
def test_reference_fleet_artifacts_pass_the_port_validator(name):
    with open(os.path.join(_REPO, name)) as f:
        obj = json.load(f)
    assert inv.detect_kind(obj) == ref_inv.detect_kind(obj) == "fleet"
    assert inv.validate(obj) == ref_inv.validate(obj) == []


def test_port_fleet_artifact_passes_the_reference_validator(tmp_path):
    art = _mini_fleet_artifact(tmp_path)
    p = tmp_path / "GPU_FLEET_r99.json"
    with open(p, "w") as f:
        json.dump(art, f)
    assert ref_inv.validate_file(str(p)) == []
    assert ref_inv.detect_kind(art) == "fleet"


def _wait_ready(address, timeout_s=60.0):
    assert _poll(lambda: health.readiness(address, timeout_s=2.0).get("ok"),
                 timeout_s), f"process at {address} never ready"


def test_router_replica_armed_streams_and_never_loads_torch(tmp_path):
    """A port replica with ``CSMOM_FLEET`` set streams its metrics to the
    aggregator (its book opens, and closes with a fin when it drains),
    notes demand through its own router, and its ``stats`` reply still
    says it never loaded torch."""
    agg = obs_fleet.arm("unit-replica", cadence_s=0.1,
                        scratch_dir=str(tmp_path))
    env = {**_ENV, **{k: os.environ[k] for k in (
        obs_fleet.ENV_ADDR, obs_fleet.ENV_RUN, obs_fleet.ENV_CADENCE)}}
    procs = []

    def spawn(module, argv, name):
        log = open(tmp_path / f"{name}.log", "ab")
        try:
            p = subprocess.Popen([sys.executable, "-m", module, *argv],
                                 stdout=log, stderr=log, env=env)
        finally:
            log.close()
        procs.append(p)
        return p

    w_addr, r_addr = str(tmp_path / "w0.sock"), str(tmp_path / "r0.sock")
    client = None
    try:
        spawn("csmom_tpu_torch.serve.worker",
              ["--socket", w_addr, "--engine", "stub", "--profile",
               "serve-smoke", "--worker-id", "w0"], "worker")
        _wait_ready(w_addr)
        routes = str(tmp_path / "routes.json")
        write_routes(routes, [("w0", w_addr)], retry_after_s=None)
        spawn("csmom_tpu_torch.serve.router",
              ["--listen", r_addr, "--routes", routes, "--router-id", "r0",
               "--profile", "serve-smoke", "--deadline-ms", "5000"],
              "replica")
        _wait_ready(r_addr)

        class _Replica:
            worker_id = "r0"
            socket_path = r_addr

        client = FabricClient(lambda: [_Replica()], FabricClientConfig(
            default_deadline_s=5.0))
        import numpy as np

        v = np.full((4, 24), 100.0, np.float32)
        m = np.ones((4, 24), bool)
        req = client.submit("momentum", v, m)
        assert req.wait(10.0) and req.state == "served", req.error
        stats, _ = proto.request_once(r_addr, {"op": "stats"}, timeout_s=5.0)
        assert stats["tier"] == "router" and stats["torch_loaded"] is False
        assert _poll(lambda: any(p.startswith("router:r0@")
                                 for p in agg.snapshot()["processes"]))
        for addr in (r_addr, w_addr):
            proto.request_once(addr, {"op": "stop"}, timeout_s=10.0)
        for p in procs:
            p.wait(timeout=15.0)
        books = agg.snapshot()["processes"]
        replica_book = next(b for n, b in books.items()
                            if n.startswith("router:r0@"))
        worker_book = next(b for n, b in books.items()
                           if n.startswith("worker:w0@"))
        assert replica_book["close_reason"] == "fin: router stopped (drained)"
        assert worker_book["close_reason"] == "fin: worker stopped (drained)"
    finally:
        if client is not None:
            client.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5.0)
        obs_fleet.disarm("unit over")


# ------------------------------------------------------------ the ledger ----

def test_ledger_ingests_fleet_rows_with_samples(tmp_path):
    art = _mini_fleet_artifact(tmp_path)
    with open(tmp_path / "GPU_FLEET_r99.json", "w") as f:
        json.dump(art, f)
    from csmom_tpu_torch.obs import ledger as ld

    L = ld.load(str(tmp_path))
    rows = {}
    for r in L.rows:
        rows.setdefault(r.metric, []).append(r)
    loss = rows["fleet_kill_window_capacity_loss_frac"][0]
    assert loss.direction == "lower"
    assert loss.value == art["value"]
    wall = rows["fleet_worker_ready_wall_s"][0]
    assert wall.direction == "lower"
    assert wall.value == pytest.approx(1.3), "the max (re)spawn wall"
    assert wall.samples, "ready-wall rows carry their CI backing"
    demand_rows = [m for m in rows if m.startswith("fleet_demand_")]
    assert "fleet_demand_interactive_rps" in demand_rows
    assert not rows["fleet_demand_interactive_rps"][0].gate_eligible(), (
        "demand rate is workload-descriptive, info only")


def test_ledger_refuses_unknown_fleet_schema_era(tmp_path):
    art = _mini_fleet_artifact(tmp_path)
    art["schema_version"] = 99
    with open(tmp_path / "GPU_FLEET_r99.json", "w") as f:
        json.dump(art, f)
    from csmom_tpu_torch.obs import ledger as ld

    L = ld.load(str(tmp_path))
    assert not any(r.metric.startswith("fleet_") for r in L.rows), (
        "an unknown schema era must contribute zero rows, not "
        "half-parsed ones")
    assert any("unknown fleet schema_version 99" in p["note"]
               for p in L.problems)


def test_fleet_sidecar_naming_rule():
    assert inv.committable_sidecar("GPU_FLEET_r20.json")
    assert not inv.committable_sidecar("GPU_FLEET_rehearse_kill.json")
    assert not inv.committable_sidecar("GPU_FLEET_smoke-fleet.json")
    assert not inv.committable_sidecar("GPU_FLEET_loadgen-abc.json")
