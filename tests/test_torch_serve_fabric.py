"""The port's serving fabric on the CPU: the routes view and publisher,
router replicas as supervised processes, the client tier's failover, the
fabric loadgen and the ``serve_fabric`` validator.

Mirrors ``tests/test_fabric.py`` case for case against the port's
modules, with stub workers (no torch in any spawned process).  Two of its
cases are left out because the module they test is not ported:
``test_ledger_refuses_unknown_serve_fabric_schema`` and
``test_fabric_committable_sidecar_naming`` belong to the ledger and the
committable-artifact rules (ROADMAP.md, Queue 1 item 8c); the
double-kill case builds its artifact without the ledger's ingest for the
same reason.  Added here:

- the port's ``FabricClient`` against the reference's replica
  (``python -m csmom_tpu.serve.router``, stdlib and numpy only) and the
  reference's client against the port's replica: one wire format, closed
  books on both sides;
- a fabric of 2 router replicas x 2 torch workers on the CPU whose five
  endpoints equal ``csmom_tpu``'s ``serve_entry_fn`` (f32 ``rtol=1e-4,
  atol=1e-6``, as ``test_torch_serve_pool.py`` holds the pool);
- a replica process never imports torch (``-X importtime`` and its
  ``stats`` reply's ``torch_loaded``).

Every wait is bounded, and every spawned process is stopped in a
``finally``.
"""

import copy
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.serve import fabric as ref_fabric
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.serve import fabric, health, proto
from csmom_tpu_torch.serve.fabric import (
    FabricClient,
    FabricClientConfig,
    RoutesPublisher,
    RoutesView,
    write_routes,
)
from csmom_tpu_torch.serve.loadgen import (
    LoadConfig,
    run_fabric_loadgen,
    write_artifact,
)
from csmom_tpu_torch.serve.supervisor import PoolConfig

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": _REPO}

_SMOKE = dict(profile="serve-smoke", engine="stub", ready_timeout_s=30.0,
              poll_interval_s=0.05, backoff_base_s=0.05, backoff_cap_s=0.5)

F32 = dict(rtol=1e-4, atol=1e-6)
KINDS = ("momentum", "turnover", "backtest", "low_volatility", "zscore_combo")


def _panel(n_assets: int, months: int, seed: int = 0):
    r = np.random.default_rng(seed)
    v = 100.0 * np.exp(np.cumsum(r.normal(0, 0.03, (n_assets, months)),
                                 axis=1)).astype(np.float32)
    return v, np.ones((n_assets, months), bool)


def _wait_for(pred, timeout_s: float, what: str) -> None:
    give_up = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > give_up:
            raise AssertionError(f"timed out after {timeout_s}s: {what}")
        time.sleep(0.02)


# ---------------------------------------------------------------- routes ----

def test_routes_roundtrip_and_view(tmp_path):
    path = str(tmp_path / "routes.json")
    write_routes(path, [("w0", "unix:/tmp/w0.sock"),
                        ("w1", "tcp:127.0.0.1:9001")],
                 retry_after_s=None, cache_version="cv-1")
    view = RoutesView(path)
    workers = view.workers()
    assert [(w.worker_id, w.socket_path) for w in workers] == [
        ("w0", "unix:/tmp/w0.sock"), ("w1", "tcp:127.0.0.1:9001")]
    assert view.retry_after_s() is None
    assert view.cache_version() == "cv-1"
    ok, reason = view.status()
    assert ok and reason is None
    # an empty fleet publishes the backoff hint instead
    write_routes(path, [], retry_after_s=0.8)
    assert view.workers() == []
    assert view.retry_after_s() == 0.8
    # the reference reads the port's file, and the other way round
    ref_fabric.write_routes(path, [("w2", "/w2.sock")], retry_after_s=None,
                            cache_version="cv-2")
    assert [w.worker_id for w in view.workers()] == ["w2"]
    write_routes(path, [("w3", "/w3.sock")], retry_after_s=None)
    assert [w.worker_id for w in ref_fabric.RoutesView(path).workers()] == [
        "w3"]


def test_routes_view_degrades_on_garbage_with_reason(tmp_path):
    path = str(tmp_path / "routes.json")
    view = RoutesView(path)
    ok, reason = view.status()
    assert not ok and "unreadable" in reason
    with open(path, "w") as f:
        f.write("{torn")
    assert view.workers() == []
    ok, reason = view.status()
    assert not ok and "unparseable" in reason
    # a later good write recovers the view
    write_routes(path, [("w0", "/x.sock")], retry_after_s=None)
    assert [w.worker_id for w in view.workers()] == ["w0"]
    assert view.status()[0]


class _FakeSup:
    """Duck-typed supervisor for the publisher: ready set + hint."""

    expect_cache_version = "cv-test"

    def __init__(self):
        self.ready: list = []
        self.hint = 1.5

    def ready_workers(self):
        return list(self.ready)

    def retry_after_s(self):
        return self.hint


class _H:
    def __init__(self, wid, addr):
        self.worker_id = wid
        self.socket_path = addr


def test_routes_view_error_clears_hint_and_version(tmp_path):
    """A broken routes file invalidates the whole view: a retry-after
    hint or cache version surviving from the last good parse would stamp
    outdated state onto every no-worker rejection."""
    path = str(tmp_path / "routes.json")
    write_routes(path, [], retry_after_s=0.8, cache_version="cv-1")
    view = RoutesView(path)
    assert view.retry_after_s() == 0.8
    assert view.cache_version() == "cv-1"
    os.unlink(path)
    assert view.workers() == []
    assert view.retry_after_s() is None, (
        "an unreadable routes file must not keep serving the stale hint")
    assert view.cache_version() is None
    with open(path, "w") as f:
        f.write("{torn")
    assert view.retry_after_s() is None
    assert view.cache_version() is None


def test_routes_publisher_writes_only_on_change(tmp_path):
    path = str(tmp_path / "routes.json")
    sup = _FakeSup()
    sup.ready = [_H("w0", "/a.sock")]
    pub = RoutesPublisher(sup, path, interval_s=10.0)
    assert pub.publish_once() is True
    assert pub.publish_once() is False, "an unchanged fleet must not churn"
    sup.ready = []
    assert pub.publish_once() is True
    view = RoutesView(path)
    assert view.workers() == []
    assert view.retry_after_s() == 1.5, (
        "an empty fleet must publish the backoff hint")
    sup.ready = [_H("w0", "/a.sock")]
    assert pub.publish_once() is True
    assert view.retry_after_s() is None, (
        "a healthy fleet publishes no hint")
    assert pub.publishes == 3


# ----------------------------------------------------------- client tier ----

class _FakeReplica:
    """A hand-rolled router replica speaking the persistent-channel
    serve loop (or resetting every connection when ``reset=True``): the
    controllable peer the failover tests need."""

    def __init__(self, tmp, rid: str, reset: bool = False):
        self.worker_id = rid
        self.socket_path = os.path.join(tmp, f"{rid}.sock")
        self.reset = reset
        self.scores = 0
        self._stop = threading.Event()
        self._srv = proto.listen(self.socket_path)
        self._srv.settimeout(0.1)
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        import socket as _socket

        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except _socket.timeout:
                continue
            except OSError:
                return
            if self.reset:
                conn.close()  # the SIGKILLed replica, as seen by a peer
                continue
            threading.Thread(target=proto.serve_connection,
                             args=(conn, self._handle),
                             daemon=True).start()

    def _handle(self, obj, arrays):
        if obj.get("op") == "score":
            self.scores += 1
            n = arrays["values"].shape[0]
            return ({"state": "served", "router_id": self.worker_id,
                     "worker_id": "w0", "cache_hit": False,
                     "hedged": False},
                    {"result": np.zeros(n, np.float32)})
        return {"ok": True}, None

    def close(self):
        self._stop.set()
        self._srv.close()


def test_fabric_client_fails_over_on_replica_reset(tmp_path):
    """A reset replica (the wire face of a SIGKILL) costs each request
    one failover to the survivor, never a lost request, and the client's
    books close over every attempt."""
    dead = _FakeReplica(str(tmp_path), "r0", reset=True)
    live = _FakeReplica(str(tmp_path), "r1")
    client = FabricClient(lambda: [dead, live], FabricClientConfig(
        default_deadline_s=5.0))
    try:
        v, m = _panel(4, 24)
        reqs = [client.submit("momentum", v, m) for _ in range(6)]
        for r in reqs:
            assert r.wait(8.0) and r.state == "served", (r.state, r.error)
        a = client.accounting()
        assert a["served"] == 6 and a["admitted"] == 6
        assert a["router_conn_failures"] >= 1, (
            "the reset replica never registered as a connection failure")
        assert a["failovers"] >= 1
        assert all(r.router_id == "r1" for r in reqs)
        assert client.invariant_violations() == []
        assert client.availability() == 1.0
    finally:
        client.close()
        dead.close()
        live.close()


def test_fabric_client_rejects_infra_when_no_replica_lives(tmp_path):
    client = FabricClient(lambda: [], FabricClientConfig(
        default_deadline_s=1.0))
    v, m = _panel(4, 24)
    r = client.submit("momentum", v, m)
    assert r.wait(3.0) and r.state == "rejected"
    assert "no ready router replica" in (r.error or "")
    a = client.accounting()
    assert a["rejected_infra"] == 1
    assert client.availability() == 0.0
    assert client.invariant_violations() == []


class _RejectingReplica(_FakeReplica):
    """A replica replying a fixed rejection to every ``score``."""

    def __init__(self, tmp, rid, error, retry_after_s=None, infra=None):
        self.error = error
        self.retry_after_s = retry_after_s
        self.infra = infra
        super().__init__(tmp, rid)

    def _handle(self, obj, arrays):
        if obj.get("op") == "score":
            self.scores += 1
            reply = {
                "state": "rejected", "router_id": self.worker_id,
                "error": self.error,
                "retry_after_s": self.retry_after_s}
            if self.infra is not None:
                reply["infra"] = self.infra
            return reply, None
        return {"ok": True}, None


def test_fabric_client_settles_parked_fleet_rejection_in_one_attempt(
        tmp_path):
    """The door's no-ready-worker rejection mentions "draining": it must
    settle as rejected_infra on the first replica, not be misread as a
    draining replica and fanned across the whole fabric mid-outage."""
    door = ("no ready worker in the pool (all crashed, parked, or "
            "draining); retry after 0.5s")
    r0 = _RejectingReplica(str(tmp_path), "r0", door, retry_after_s=0.5)
    r1 = _RejectingReplica(str(tmp_path), "r1", door, retry_after_s=0.5)
    client = FabricClient(lambda: [r0, r1], FabricClientConfig(
        default_deadline_s=5.0))
    try:
        v, m = _panel(4, 24)
        req = client.submit("momentum", v, m)
        assert req.wait(8.0) and req.state == "rejected"
        assert req.retry_after_s == 0.5
        assert r0.scores + r1.scores == 1, (
            "a parked-fleet door rejection fanned out across replicas")
        assert client.accounting()["rejected_infra"] == 1
    finally:
        client.close()
        r0.close()
        r1.close()


def test_fabric_client_reads_infra_flag_from_the_wire(tmp_path):
    """A replica whose attempts all died on dead wires replies with its
    infra classification on the reply: the client counts it into
    rejected_infra (availability drops) instead of matching error text
    that does not say "no ready worker"."""
    err = "all 3 attempt(s) failed: w0: connection failed (reset)"
    r0 = _RejectingReplica(str(tmp_path), "r0", err, infra=True)
    client = FabricClient(lambda: [r0], FabricClientConfig(
        default_deadline_s=5.0))
    try:
        v, m = _panel(4, 24)
        req = client.submit("momentum", v, m)
        assert req.wait(8.0) and req.state == "rejected"
        a = client.accounting()
        assert a["rejected_infra"] == 1, (
            "an infra rejection crossed the wire unclassified: "
            "availability would read 1.0 over lost requests")
        assert client.availability() == 0.0
    finally:
        client.close()
        r0.close()


def test_fabric_client_fails_over_a_genuinely_draining_replica(tmp_path):
    """The replica's own drain refusal (a rolling restart) is a routing
    miss: the client tries a survivor and serves."""
    draining = _RejectingReplica(str(tmp_path), "r0", "router draining")
    live = _FakeReplica(str(tmp_path), "r1")
    client = FabricClient(lambda: [draining, live],
                          FabricClientConfig(default_deadline_s=5.0))
    try:
        v, m = _panel(4, 24)
        reqs = [client.submit("momentum", v, m) for _ in range(4)]
        for r in reqs:
            assert r.wait(8.0) and r.state == "served", (r.state, r.error)
        assert live.scores == 4
        assert client.accounting()["served"] == 4
    finally:
        client.close()
        draining.close()
        live.close()


# ------------------------------------------------------------ end to end ----

def test_fabric_three_tiers_over_tcp_survive_double_kill(tmp_path):
    """The reference's acceptance shape in miniature: tcp everywhere, 2
    router replicas x 2 workers, one router and one worker SIGKILLed
    mid-burst: availability 1.0 (no admitted request dies with a
    process), closed client books, a GPU_SERVE_FABRIC artifact valid
    under both packages' validators."""
    wsup, pub, rsup, client = fabric.build_fabric(
        PoolConfig(n_workers=2, transport="tcp", **_SMOKE),
        PoolConfig(n_workers=2, transport="tcp", **_SMOKE),
        str(tmp_path), deadline_ms=3000.0, client_deadline_s=3.0)
    try:
        load = LoadConfig(schedule="1.4x40", seed=5, deadline_s=3.0,
                          reuse_fraction=0.5, run_id="r99")

        def double_kill():
            time.sleep(0.3)
            rsup.kill_worker(rsup.handles[0].worker_id)
            time.sleep(0.2)
            wsup.kill_worker(wsup.handles[0].worker_id)
            give_up = time.monotonic() + 30.0
            while time.monotonic() < give_up:
                if all(any(h.generation >= 1 and h.state == "ready"
                           for h in sup.handles)
                       for sup in (rsup, wsup)):
                    return
                time.sleep(0.05)

        art = run_fabric_loadgen(client, rsup, wsup, load,
                                 concurrent=double_kill)
    finally:
        fabric.stop_fabric(pub, rsup, wsup)
        client.close()
    assert all(h.proc.poll() is not None
               for h in rsup.handles + wsup.handles)
    assert inv.validate(art, "serve_fabric") == []
    req = art["requests"]
    assert req["admitted"] == req["served"] + req["rejected"] + \
        req["expired"]
    assert art["availability"] == 1.0, (art["availability"], req)
    assert art["routers"]["kills"] == 1 and art["workers"]["kills"] == 1
    assert art["routers"]["restarts"] >= 1
    assert art["workers"]["restarts"] >= 1
    assert req["served"] > 0
    assert art["transport"]["scheme"] == "tcp"
    # repeats exist (reuse 0.5) and affinity lands them on one worker's
    # cache: the plumbing reports pool-level hits
    assert req["served_cache_hits"] > 0, (
        "no pool-level cache hit despite 50% panel reuse: the cache_hit "
        "flag or the affinity routing broke")
    assert client.invariant_violations() == []

    path = write_artifact(str(tmp_path), art, prefix="GPU_SERVE_FABRIC")
    assert os.path.basename(path) == "GPU_SERVE_FABRIC_r99.json"
    assert inv.validate_file(path) == []
    assert ref_inv.validate_file(path) == []
    assert inv.detect_kind(art) == ref_inv.detect_kind(art) == "serve_fabric"
    assert art["extra"]["samples"]["serve_fabric_total_ms"]


@pytest.mark.parametrize("knobs", [
    {},
    dict(max_attempts=2, fair_slots=8, affinity=False),
    dict(max_attempts=5, fair_slots=3, affinity=True, trace=True),
])
def test_router_supervisor_argv_equals_the_references(tmp_path, knobs):
    """Fault 2 repaired: the replica argv of both packages' router
    supervisors carries the same knobs, flag for flag, after the module
    name (the replica parses every one of them)."""
    cfg = PoolConfig(n_workers=1, **_SMOKE)
    kw = dict(deadline_ms=250.0, hedge_fraction=0.2, **knobs)
    ours = fabric.RouterSupervisor(cfg, str(tmp_path / "p"), "routes.json",
                                   **kw)
    ref = ref_fabric.RouterSupervisor(
        ref_fabric.PoolConfig(n_workers=1, profile="serve-smoke",
                              engine="stub"),
        str(tmp_path / "r"), "routes.json", **kw)
    ours.expect_cache_version = ref.expect_cache_version = "v0"
    h = fabric.WorkerHandle(slot=0, worker_id="r0", socket_path="s.sock")
    a, b = ours._slot_argv(h), ref._slot_argv(h)
    assert a[1:3] == ["-m", "csmom_tpu_torch.serve.router"]
    assert b[1:3] == ["-m", "csmom_tpu.serve.router"]
    assert a[3:] == b[3:]


def test_build_fabric_configures_the_router_tier_before_it_spawns(tmp_path):
    """``configure_router(rsup)`` runs after the router supervisor is
    built and before its first replica spawns (a spy on ``start``); the
    mesh pool's pinning reaches the worker tier (slot k owns ``k*2:2``),
    and every process stops."""
    order = []

    def hook(rsup):
        assert isinstance(rsup, fabric.RouterSupervisor) and not rsup.handles
        order.append("configure_router")
        start = rsup.start

        def spy(*a, **k):
            order.append("start")
            return start(*a, **k)

        rsup.start = spy

    wsup = pub = rsup = None
    try:
        wsup, pub, rsup, client = fabric.build_fabric(
            PoolConfig(n_workers=2, devices_per_worker=2, **_SMOKE),
            PoolConfig(n_workers=2, **_SMOKE), str(tmp_path),
            deadline_ms=500.0, configure_router=hook)
        assert order == ["configure_router", "start"]
        assert [h.device_slice for h in wsup.handles] == ["0:2", "2:2"]
        assert [h.device_slice for h in rsup.handles] == [None, None]
        assert all("--device-slice" in wsup._slot_argv(h) for h in wsup.handles)
        v, m = _panel(8, 24)
        req = client.submit("momentum", v, m, deadline_s=5.0)
        assert req.wait(10.0) and req.state == "served"
    finally:
        fabric.stop_fabric(pub, rsup, wsup)
    for sup in (wsup, rsup):
        assert all(h.proc is None or h.proc.poll() is not None
                   for h in sup.handles)


def test_build_fabric_fleet_config_promotes_a_spare_on_a_worker_kill(
        tmp_path):
    """``fleet_config`` attaches the elastic tier: a parked spare fills a
    SIGKILLed worker's slot, the routes file names the promoted process
    under the victim's id, the client keeps serving through it, and the
    teardown stops every process, the spares included."""
    from csmom_tpu_torch.serve.fleet import FleetConfig

    wsup, publisher, rsup, client = fabric.build_fabric(
        PoolConfig(n_workers=2, **_SMOKE), PoolConfig(**_SMOKE),
        str(tmp_path), deadline_ms=5000.0,
        fleet_config=FleetConfig(spares=1, min_workers=2, max_workers=3))
    spare_pids = []
    try:
        ctl = wsup.fleet
        assert ctl is not None and len(ctl.spares) == 1
        spare = ctl.spares[0]
        spare_pids.append(spare.proc.pid)
        routes = RoutesView(publisher.path)
        assert spare.socket_path not in [w.socket_path
                                         for w in routes.workers()]
        assert wsup.kill_worker("w0")
        _wait_for(lambda: ctl.counts["promoted"] == 1, 10.0, "promotion")
        assert wsup.handles[0].proc.pid == spare.proc.pid
        assert wsup.handles[0].spawn_kind == "spare-promotion"
        _wait_for(lambda: ("w0", spare.socket_path) in
                  [(w.worker_id, w.socket_path)
                   for w in RoutesView(publisher.path).workers()], 10.0,
                  "the routes name the promoted spare as w0")
        v, m = _panel(5, 24)
        req = client.submit("momentum", v, m, deadline_s=5.0)
        assert req.wait(10.0) and req.state == "served", req.error
        _wait_for(lambda: any(s.state == "ready" for s in ctl.spares), 20.0,
                  "the backfill spare ready")
        spare_pids += [s.proc.pid for s in ctl.spares]
    finally:
        fabric.stop_fabric(publisher, rsup, wsup)
        client.close()
    procs = [h.proc for h in rsup.handles + wsup.handles]
    assert all(p.poll() is not None for p in procs)
    _wait_for(lambda: not any(os.path.exists(f"/proc/{p}")
                              for p in spare_pids), 10.0, "spares stopped")


# -------------------------------------------------------------- contracts ----

def _min_fabric_art() -> dict:
    """A minimal valid serve_fabric artifact (hand-rolled so the
    rejection tests mutate known-good ground)."""
    return {
        "kind": "serve_fabric",
        "schema_version": 1,
        "run_id": "r99",
        "metric": "serve_fabric_throughput_rps",
        "value": 50.0,
        "unit": "req/s",
        "vs_baseline": 1.0,
        "wall_s": 2.0,
        "offered_limited": True,
        "transport": {"scheme": "tcp", "routers": 2, "workers": 2},
        "requests": {"admitted": 10, "served": 9, "rejected": 1,
                     "expired": 0, "rejected_infra": 0,
                     "served_cache_hits": 3, "served_hedged": 1,
                     "router_conn_failures": 1, "failovers": 1},
        "availability": 1.0,
        "cache": {"pool_hit_rate": round(3 / 9, 4),
                  "served_cache_hits": 3, "served": 9,
                  "per_worker_baseline": 0.246,
                  "workers": {"hits": 3, "misses": 6, "lookups": 9,
                              "stale_hits": 0, "stale_blocked": 0,
                              "reporting": 2, "lost": []}},
        "hedge": {"served_hedged": 1, "rate": 0.1,
                  "router_tier": {"hedged": 2, "wins": 1,
                                  "suppressed": 1, "books_lost": []}},
        "latency_ms": {"total": {"p50": 3.0, "p95": 8.0, "p99": 9.0}},
        "routers": {"replicas": [{"router_id": "r0"}, {"router_id": "r1"}],
                    "n_slots": 2, "ready_end": 2, "kills": 1,
                    "restarts": 1, "rolls_completed": 0, "events": []},
        "workers": {"stats": [{"worker_id": "w0"}, {"worker_id": "w1"}],
                    "n_slots": 2, "ready_end": 2, "kills": 1,
                    "restarts": 1, "rolls_completed": 0, "events": []},
        "compile": {"in_window_fresh_compiles": 0},
        "offered": {"schedule": "1x10", "offered_rps": 10.0},
        "extra": {"platform": "stub", "workload": "test"},
    }


_VALIDATORS = pytest.mark.parametrize("validator", [inv, ref_inv],
                                      ids=["port", "reference"])


@_VALIDATORS
def test_serve_fabric_validator_accepts_minimal(validator):
    assert validator.validate(_min_fabric_art(), "serve_fabric") == []
    assert validator.detect_kind(_min_fabric_art()) == "serve_fabric"
    # fabric before pool: without its kind, the signature decides
    art = _min_fabric_art()
    del art["kind"]
    assert validator.detect_kind(art) == "serve_fabric"
    assert validator.validate(art) == []


@_VALIDATORS
def test_serve_fabric_validator_rejects_broken_books(validator):
    art = _min_fabric_art()
    art["requests"]["served"] = 8  # 8 + 1 + 0 != 10
    viols = validator.validate(art, "serve_fabric")
    assert any("client books broken" in v for v in viols), viols


@_VALIDATORS
def test_serve_fabric_validator_rejects_single_router(validator):
    art = _min_fabric_art()
    art["transport"]["routers"] = 1
    viols = validator.validate(art, "serve_fabric")
    assert any(">= 2 router replicas" in v for v in viols), viols


@_VALIDATORS
def test_serve_fabric_validator_rejects_stale_hit_anywhere(validator):
    art = _min_fabric_art()
    art["cache"]["workers"]["stale_hits"] = 1
    viols = validator.validate(art, "serve_fabric")
    assert any("stale_hits" in v and "structurally" in v
               for v in viols), viols


@_VALIDATORS
def test_serve_fabric_validator_rejects_unreconciled_figures(validator):
    art = _min_fabric_art()
    art["availability"] = 0.5
    viols = validator.validate(art, "serve_fabric")
    assert any("does not reconcile" in v for v in viols), viols
    art = _min_fabric_art()
    art["cache"]["pool_hit_rate"] = 0.9
    viols = validator.validate(art, "serve_fabric")
    assert any("pool_hit_rate" in v for v in viols), viols
    art = _min_fabric_art()
    art["hedge"]["rate"] = 0.9
    viols = validator.validate(art, "serve_fabric")
    assert any("hedge.rate" in v for v in viols), viols
    art = copy.deepcopy(_min_fabric_art())
    art["schema_version"] = 77
    viols = validator.validate(art, "serve_fabric")
    assert any("unknown schema_version" in v for v in viols), viols


@_VALIDATORS
def test_serve_fabric_validator_reports_malformed_counters(validator):
    """Malformed request counters come back as violations, not a
    TypeError out of validate(): the reconcile blocks divide by them."""
    for bad in ("10", None, 10.5, True):
        art = _min_fabric_art()
        art["requests"]["admitted"] = bad
        viols = validator.validate(art, "serve_fabric")
        assert any("requests.admitted" in v for v in viols), (bad, viols)


class _KHandle:
    def __init__(self, wid, generation=0):
        self.worker_id = wid
        self.generation = generation
        self.state = "ready"


def test_kill_mid_burst_tied_offsets_do_not_crash():
    """Tied kill offsets must not fall through the tuple sort to
    comparing unorderable supervisors: the TypeError would surface only
    after the whole load burst, losing the artifact."""

    class _Sup:
        def __init__(self, *handles):
            self.handles = list(handles)
            self.killed = []

        def kill_worker(self, wid):
            self.killed.append(wid)
            self.handles[0].generation += 1  # "replacement" is ready

    r, w = _Sup(_KHandle("r0")), _Sup(_KHandle("w0"))
    assert fabric.kill_mid_burst([(0.01, r, "router"), (0.01, w, "worker")],
                                 settle_timeout_s=5.0) is True
    assert r.killed == ["r0"] and w.killed == ["w0"]
    # falsy offsets are dropped (the single-kill CLI paths)
    r2 = _Sup(_KHandle("r0"))
    assert fabric.kill_mid_burst([(0.0, r2, "router")], settle_timeout_s=1.0)
    assert r2.killed == []


def test_kill_mid_burst_settles_on_the_victims_slot_only():
    """A previously flaky non-victim slot already at generation >= 1 must
    not read as settled while the victim's replacement is still
    spawning: books are built only from a settled fleet."""

    class _Sup:
        def __init__(self, *handles):
            self.handles = list(handles)

        def kill_worker(self, wid):
            pass  # the replacement never arrives

    sup = _Sup(_KHandle("w0"), _KHandle("w1", generation=1))
    assert fabric.kill_mid_burst([(0.01, sup, "worker")],
                                 settle_timeout_s=0.3,
                                 poll_interval_s=0.02) is False, (
        "the flaky non-victim slot must not satisfy the settle check")


@pytest.mark.parametrize("name", [f"SERVE_FABRIC_r{n}.json"
                                  for n in (18, 19, 20, 21)])
def test_committed_serve_fabric_artifacts_validate(name):
    """The reference's committed fabric artifacts pass the port's
    validator and are detected as fabric, not pool."""
    path = os.path.join(_REPO, name)
    assert inv.validate_file(path) == []
    with open(path) as f:
        art = json.load(f)
    assert inv.detect_kind(art) == "serve_fabric"
    assert art["transport"]["routers"] >= 2


# --------------------------------------------------------- cross-package ----

def _spawn(module, argv, tmp_path, name, python_flags=()):
    log = open(tmp_path / f"{name}.log", "wb")
    try:
        return subprocess.Popen(
            [sys.executable, *python_flags, "-m", module, *argv],
            stdout=log, stderr=log, env=_ENV, cwd=str(tmp_path))
    finally:
        log.close()


def _stop(proc, address):
    """Stop a worker or replica by its ``stop`` op, then make sure it is
    gone."""
    try:
        proto.request_once(address, {"op": "stop"}, timeout_s=5.0)
    except (OSError, proto.ProtocolError):
        pass
    try:
        proc.wait(timeout=10.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5.0)


def _ready(address, timeout_s=60.0):
    _wait_for(lambda: health.readiness(address, timeout_s=2.0).get("ok"),
              timeout_s, f"process at {address} ready")


class _Stack:
    """One stub worker of the port and one router replica of the given
    package over it, in ``tmp_path``; ``close`` stops both."""

    def __init__(self, tmp_path, replica_pkg, python_flags=()):
        self.worker_addr = str(tmp_path / "w0.sock")
        self.addr = str(tmp_path / "r0.sock")
        self.worker_id = "r0"
        self.socket_path = self.addr
        self.procs = []
        self.worker = _spawn("csmom_tpu_torch.serve.worker",
                             ["--socket", self.worker_addr, "--engine",
                              "stub", "--profile", "serve-smoke",
                              "--worker-id", "w0"], tmp_path, "worker")
        self.procs.append((self.worker, self.worker_addr))
        _ready(self.worker_addr)
        routes = str(tmp_path / "routes.json")
        write_routes(routes, [("w0", self.worker_addr)], retry_after_s=None)
        self.replica = _spawn(f"{replica_pkg}.serve.router",
                              ["--listen", self.addr, "--routes", routes,
                               "--router-id", "r0", "--profile",
                               "serve-smoke", "--deadline-ms", "5000"],
                              tmp_path, "replica", python_flags)
        self.procs.append((self.replica, self.addr))
        _ready(self.addr)

    def close(self):
        for proc, addr in reversed(self.procs):
            _stop(proc, addr)


@pytest.mark.parametrize("replica_pkg,client_mod", [
    ("csmom_tpu", fabric), ("csmom_tpu_torch", ref_fabric)],
    ids=["port-client-reference-replica", "reference-client-port-replica"])
def test_clients_and_replicas_interoperate_across_packages(
        tmp_path, replica_pkg, client_mod):
    """One package's fabric client scores through the other package's
    router replica (over a port stub worker): the frames interoperate,
    and the client's books and the replica's close over the same
    requests."""
    stack = _Stack(tmp_path, replica_pkg)
    client = client_mod.FabricClient(
        lambda: [stack], client_mod.FabricClientConfig(
            default_deadline_s=5.0))
    try:
        reqs = []
        for i, kind in enumerate(KINDS):
            v, m = _panel(3 + i, 24, seed=i)
            reqs.append(client.submit(kind, v, m))
        for r in reqs:
            assert r.wait(10.0) and r.state == "served", (r.state, r.error)
            assert r.router_id == "r0" and r.worker_id == "w0"
        assert isinstance(reqs[2].result, dict)  # backtest's summary
        assert np.asarray(reqs[0].result).shape == (3,)
        assert client.invariant_violations() == []
        a = client.accounting()
        assert a["admitted"] == a["served"] == len(KINDS)
        stats, _ = proto.request_once(stack.addr, {"op": "stats"},
                                      timeout_s=5.0)
        b = stats["accounting"]
        assert b["admitted"] == b["served"] == len(KINDS)
        assert stats["invariant_violations"] == []
    finally:
        client.close()
        stack.close()
    assert all(p.poll() is not None for p, _ in stack.procs)


def test_router_replica_never_imports_torch(tmp_path):
    """Every module a port replica imports while it starts and routes
    each endpoint is listed by ``-X importtime``: neither torch nor
    pandas, and its ``stats`` reply says so."""
    stack = _Stack(tmp_path, "csmom_tpu_torch", ("-X", "importtime"))
    client = FabricClient(lambda: [stack], FabricClientConfig(
        default_deadline_s=5.0))
    try:
        v, m = _panel(6, 24, seed=3)
        reqs = [client.submit(kind, v, m) for kind in KINDS]
        for r in reqs:
            assert r.wait(10.0) and r.state == "served", (r.state, r.error)
        stats, _ = proto.request_once(stack.addr, {"op": "stats"},
                                      timeout_s=5.0)
        assert stats["tier"] == "router" and stats["torch_loaded"] is False
    finally:
        client.close()
        stack.close()
    log = (tmp_path / "replica.log").read_text()
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in log.splitlines()
                if ln.startswith("import time:")]
    assert "csmom_tpu_torch.serve.fabric" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("torch", "pandas", "jax")]


def test_router_replica_trace_flag_exits_2_naming_6d(tmp_path):
    """A replica's ``--trace`` arms its own trace book: its ``stats``
    reply carries the book's snapshot (closed, empty), and the replica
    still never loads torch."""
    write_routes(str(tmp_path / "routes.json"), [], None, "v0")
    addr = f"unix:{tmp_path / 'r.sock'}"
    p = subprocess.Popen(
        [sys.executable, "-m", "csmom_tpu_torch.serve.router", "--listen",
         addr, "--routes", str(tmp_path / "routes.json"), "--trace"],
        env=_ENV, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        _wait_for(lambda: (tmp_path / "r.sock").exists(), 60.0, "replica bind")
        obj, _ = proto.request_once(addr, {"op": "stats"}, timeout_s=10.0)
        tr = obj["trace"]
        assert tr["invariant_violations"] == []
        assert tr["snapshot"]["books"]["opened"] == 0
        assert obj["torch_loaded"] is False
    finally:
        p.terminate()
        p.wait(timeout=30)


@pytest.fixture(scope="module")
def cpu_fabric(tmp_path_factory):
    """Two router replicas in front of two torch-engine workers on the
    CPU at ``serve-smoke``; every tier stopped in the fixture's
    finally."""
    run_dir = str(tmp_path_factory.mktemp("fabric"))
    wsup, pub, rsup, client = fabric.build_fabric(
        PoolConfig(n_workers=2, profile="serve-smoke", engine="torch",
                   device="cpu", ready_timeout_s=120.0,
                   poll_interval_s=0.05),
        PoolConfig(n_workers=2, profile="serve-smoke", engine="stub",
                   ready_timeout_s=60.0, poll_interval_s=0.05),
        run_dir, deadline_ms=30000.0, client_deadline_s=30.0)
    try:
        yield wsup, rsup, client
    finally:
        fabric.stop_fabric(pub, rsup, wsup)
        client.close()
    assert all(h.proc.poll() is not None
               for h in rsup.handles + wsup.handles)


@pytest.mark.parametrize("kind", KINDS)
def test_torch_fabric_on_the_cpu_equals_the_reference(cpu_fabric, kind):
    """Requests through the client, a replica and a torch worker on the
    CPU, against ``csmom_tpu``'s ``serve_entry_fn`` scoring each alone
    (padded to its bucket as the batcher pads it)."""
    import random

    from csmom_tpu.serve.engine import serve_entry_fn
    from csmom_tpu.serve.loadgen import synth_panel
    from csmom_tpu_torch.serve.buckets import bucket_spec

    wsup, rsup, client = cpu_fabric
    assert {h.ready_report["platform"] for h in wsup.handles} == {"cpu"}
    spec = bucket_spec("serve-smoke")
    A, M = spec.max_assets, spec.months
    r = random.Random(len(kind))
    panels = [synth_panel(r, n, M, kind) for n in (2, 5, A - 1, A)]
    reqs = [client.submit(kind, v, m) for v, m in panels]
    fn = serve_entry_fn(kind, 12, 1, 10, "rank")
    for (v, m), req in zip(panels, reqs):
        assert req.wait(60.0) and req.state == "served", (req.state,
                                                          req.error)
        vb = np.zeros((1, A, M), np.float32)
        mb = np.zeros((1, A, M), bool)
        vb[0, :len(v)], mb[0, :len(v)] = v, m
        want = np.asarray(fn(vb, mb))[0]
        if isinstance(req.result, dict):
            got = np.array(list(req.result.values()))
        else:
            got = np.asarray(req.result)
            want = want[:len(v)]
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], **F32)
    assert client.invariant_violations() == []
    replicas = rsup.router_stats()
    assert [s["torch_loaded"] for s in replicas] == [False, False]
    assert all(s["invariant_violations"] == [] for s in replicas)
    stats = [proto.request_once(h.socket_path, {"op": "stats"},
                                timeout_s=5.0)[0] for h in wsup.handles]
    assert all(s["kernel_launches"]["cohort_partial_sums"] == 0
               for s in stats)
