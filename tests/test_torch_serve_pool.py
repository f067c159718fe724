"""The port's multi-process serving pool on the CPU: protocol, health,
worker, supervisor, router, pool loadgen and validator.

Mirrors ``tests/test_serve_pool.py`` case for case against the port's
modules, with stub workers (no torch in any spawned process), plus the
cross-package cases:

- the same header and arrays encode to identical frame bytes in both
  ``proto`` modules;
- a reference ``proto.request_once`` is answered by a port worker, and a
  port client by a reference worker;
- a 2-worker pool with ``--engine torch --device cpu`` serves each of the
  five endpoints at ``serve-smoke`` shapes, every result equal to
  ``csmom_tpu``'s ``serve_entry_fn`` on the CPU (f32 ``rtol=1e-4,
  atol=1e-6``, as ``test_torch_serve_engine.py`` holds);
- a stub worker's process never imports torch.

Every test that spawns workers bounds each wait and stops every worker in
a ``finally``.
"""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu.serve import proto as ref_proto
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.serve import health, proto
from csmom_tpu_torch.serve.router import Router, RouterConfig
from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": _REPO}

_SMOKE_POOL = dict(profile="serve-smoke", engine="stub",
                   ready_timeout_s=30.0, poll_interval_s=0.05)

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


def _spawn(argv, tmp_path, name, module="csmom_tpu_torch.serve.worker",
           python_flags=()):
    log = open(tmp_path / f"{name}.log", "wb")
    try:
        return subprocess.Popen(
            [sys.executable, *python_flags, "-m", module, *argv],
            stdout=log, stderr=log, env=_ENV, cwd=str(tmp_path))
    finally:
        log.close()


def _stop(proc, address):
    """Stop a worker by its ``stop`` op, then make sure it is gone."""
    try:
        proto.request_once(address, {"op": "stop"}, timeout_s=5.0)
    except (OSError, proto.ProtocolError):
        pass
    try:
        proc.wait(timeout=10.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5.0)


# ------------------------------------------------------------- protocol ----

def test_proto_roundtrips_json_and_arrays():
    a, b = socket.socketpair()
    try:
        values = np.arange(12, dtype=np.float32).reshape(3, 4)
        mask = values > 4
        proto.send_msg(a, {"op": "score", "kind": "momentum"},
                       {"values": values, "mask": mask})
        obj, arrays = proto.recv_msg(b)
        assert obj == {"op": "score", "kind": "momentum"}
        np.testing.assert_array_equal(arrays["values"], values)
        np.testing.assert_array_equal(arrays["mask"], mask)
        assert arrays["values"].dtype == np.float32
    finally:
        a.close()
        b.close()


def test_proto_refuses_malformed_frames():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", proto.MAX_FRAME_BYTES + 1))
        with pytest.raises(proto.ProtocolError, match="MAX_FRAME_BYTES"):
            proto.recv_msg(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        # an array spec whose byte count disagrees with its shape refuses
        # the frame: half a panel never scores
        hdr = json.dumps({"op": "score", "_arrays": [
            {"name": "values", "dtype": "float32", "shape": [2, 2],
             "nbytes": 999}]}).encode()
        payload = struct.pack("!I", len(hdr)) + hdr + b"\x00" * 16
        a.sendall(struct.pack("!I", len(payload)) + payload)
        with pytest.raises(proto.ProtocolError, match="inconsistent"):
            proto.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_proto_recv_deadline_bounds_a_stalled_peer():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", 64))  # declares 64 bytes, sends none
        t0 = time.monotonic()
        with pytest.raises(proto.ProtocolError, match="deadline"):
            proto.recv_msg(b, deadline_s=0.4)
        assert time.monotonic() - t0 < 2.0
    finally:
        a.close()
        b.close()


def test_proto_recv_deadline_bounds_a_trickling_peer():
    """The deadline is TOTAL: one byte per window does not reset it."""
    a, b = socket.socketpair()
    stop = threading.Event()

    def trickle():
        a.sendall(struct.pack("!I", 1 << 20))
        while not stop.is_set():
            try:
                a.sendall(b"\x00")
            except OSError:
                return
            stop.wait(0.05)

    t = threading.Thread(target=trickle, daemon=True)
    t.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(proto.ProtocolError, match="deadline"):
            proto.recv_msg(b, deadline_s=0.4)
        assert time.monotonic() - t0 < 2.0
    finally:
        stop.set()
        a.close()
        b.close()
        t.join(timeout=1.0)
    assert not t.is_alive()


def test_chaos_env_duration_defaults_on_malformed_value(monkeypatch):
    monkeypatch.setenv(proto.NET_DELAY_ENV, "250ms")
    assert proto._chaos_env_s(proto.NET_DELAY_ENV, 1.5) == 1.5
    monkeypatch.setenv(proto.NET_DELAY_ENV, "0.25")
    assert proto._chaos_env_s(proto.NET_DELAY_ENV, 1.5) == 0.25
    monkeypatch.setenv(proto.NET_DELAY_ENV, "")
    assert proto._chaos_env_s(proto.NET_DELAY_ENV, 1.5) == 1.5
    monkeypatch.delenv(proto.NET_DELAY_ENV)
    assert proto._chaos_env_s(proto.NET_DELAY_ENV, 1.5) == 1.5


def test_proto_recv_restores_caller_socket_timeout():
    a, b = socket.socketpair()
    try:
        b.settimeout(60.0)
        proto.send_msg(a, {"op": "ping"})
        obj, _ = proto.recv_msg(b, deadline_s=5.0)
        assert obj == {"op": "ping"}
        assert b.gettimeout() == 60.0
        a.sendall(struct.pack("!I", 64))
        with pytest.raises(proto.ProtocolError, match="deadline"):
            proto.recv_msg(b, deadline_s=0.2)
        assert b.gettimeout() == 60.0
    finally:
        a.close()
        b.close()


def test_proto_frame_bound_refuses_before_allocating():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", 0xFFFFFFFF))  # a 4 GiB claim
        with pytest.raises(proto.ProtocolError,
                           match="Refusing before allocating"):
            proto.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_parse_address_schemes_and_errors():
    assert proto.parse_address("/tmp/w0.sock") == ("unix", "/tmp/w0.sock")
    assert proto.parse_address("unix:/tmp/w0.sock") == ("unix",
                                                        "/tmp/w0.sock")
    assert proto.parse_address("tcp:127.0.0.1:9001") == (
        "tcp", ("127.0.0.1", 9001))
    for bad in ("unix:", "tcp:nohost", "tcp:h:notaport", "tcp:h:70000"):
        with pytest.raises(ValueError):
            proto.parse_address(bad)


def test_proto_tcp_roundtrip_with_arrays():
    addr = f"tcp:127.0.0.1:{proto.free_tcp_port()}"
    srv = proto.listen(addr)
    srv.settimeout(2.0)

    def serve_one():
        conn, _ = srv.accept()
        try:
            obj, arrays = proto.recv_msg(conn)
            proto.send_msg(conn, {"echo": obj["op"]},
                           {"values": arrays["values"] * 2})
        finally:
            conn.close()

    t = threading.Thread(target=serve_one, daemon=True)
    t.start()
    try:
        v = np.arange(6, dtype=np.float32).reshape(2, 3)
        obj, arrays = proto.request(addr, {"op": "probe"},
                                    arrays={"values": v}, timeout_s=5.0)
        assert obj == {"echo": "probe"}
        np.testing.assert_array_equal(arrays["values"], v * 2)
    finally:
        srv.close()
        t.join(timeout=2.0)
    assert not t.is_alive()


def _frame(mod, header, arrays, mux):
    buffers, total = mod._encode_frame(header, arrays, mux)
    out = b"".join(bytes(b) for b in buffers)
    assert len(out) == 4 + total
    return out


@pytest.mark.parametrize("case", ["score", "reply", "empty", "template"])
def test_frames_are_byte_identical_across_packages(case):
    """The port's encoder writes the reference's bytes, header splice,
    ``_mux`` tag and array payloads included."""
    v, m = _panel(5, 24, seed=3)
    if case == "score":
        hdr = json.dumps({"op": "score", "kind": "backtest",
                          "priority": "bulk", "deadline_rel_s": 0.5,
                          "panel_version": 7}).encode()
        cases = [(hdr, {"values": v, "mask": m}, 17)]
    elif case == "reply":
        hdr = json.dumps({"state": "served", "worker_id": "w1",
                          "queue_wait_s": 0.001, "cache_hit": False}).encode()
        cases = [(hdr, {"result": v[:, 0].astype(np.float64)}, None),
                 (hdr, None, 3)]
    elif case == "empty":
        cases = [(b"{}", None, None), (b"{}", {"values": v}, 1)]
    else:
        want_t = ref_proto.ScoreHeaderCache().render(
            "momentum", "interactive", None, 42, 0.25)
        got_t = proto.ScoreHeaderCache().render(
            "momentum", "interactive", None, 42, 0.25)
        assert got_t == want_t
        cases = [(got_t, {"values": v, "mask": m}, 9)]
    for header, arrays, mux in cases:
        assert _frame(proto, header, arrays, mux) == \
            _frame(ref_proto, header, arrays, mux)
    # and over a socket: the one-shot writer sends the same bytes
    a, b = socket.socketpair()
    try:
        proto.send_msg(a, {"op": "score", "kind": "turnover"},
                       {"values": v, "mask": m})
        ref_proto.send_msg(a, {"op": "score", "kind": "turnover"},
                           {"values": v, "mask": m})
        a.shutdown(socket.SHUT_WR)
        got = b""
        while chunk := b.recv(1 << 16):
            got += chunk
        half = len(got) // 2
        assert got[:half] == got[half:]
    finally:
        a.close()
        b.close()


# --------------------------------------------------------------- health ----

def test_cache_version_fingerprints_the_built_world(tmp_path, monkeypatch):
    """The token moves with the bucket grid, the engine params, torch's
    release, and a kernel's source (its library digest)."""
    import importlib.metadata

    from csmom_tpu_torch.ops import build

    v1 = health.aot_cache_version("serve")
    assert v1 == health.aot_cache_version("serve"), "must be deterministic"
    assert v1 != health.aot_cache_version("serve-smoke")
    assert v1 != health.aot_cache_version("serve", lookback=6)
    assert v1 != health.aot_cache_version("serve", engine="stub")
    assert health.aot_cache_version("serve", engine="jax") == v1

    real_version = importlib.metadata.version
    monkeypatch.setattr(importlib.metadata, "version",
                        lambda name: "9.9.9" if name == "torch"
                        else real_version(name))
    assert health.aot_cache_version("serve") != v1
    monkeypatch.setattr(importlib.metadata, "version", real_version)
    assert health.aot_cache_version("serve") == v1

    src = tmp_path / "csrc"
    src.mkdir()
    text = (build.SRC_DIR / "decile_partial_sums.cu").read_text()
    (src / "decile_partial_sums.cu").write_text(text)
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    assert health.aot_cache_version("serve") == v1, (
        "the digest is of the source and flags, not of where they live")
    (src / "decile_partial_sums.cu").write_text(text + "\n// edited\n")
    assert health.aot_cache_version("serve") != v1, (
        "an edited kernel must read as version skew")
    (src / "decile_partial_sums.cu").write_text(text)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert health.aot_cache_version("serve") != v1, (
        "changed nvcc flags must read as version skew")


def test_expected_entry_names_name_the_kernel_libraries(tmp_path, monkeypatch):
    from csmom_tpu_torch.ops import build
    from csmom_tpu_torch.serve.engine import KERNELS

    names = health.expected_entry_names()
    assert names == {build.library_path(n).name for n in KERNELS}
    assert len(names) == 1 and next(iter(names)).startswith(
        "decile_partial_sums-")


def test_cache_readiness_cold_build_dir_points_at_the_build(tmp_path,
                                                            monkeypatch):
    from csmom_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "empty")
    ready, reason = health.cache_readiness()
    assert not ready
    assert health.BUILD_POINTER in reason and "decile_partial_sums" in reason
    lib = build.library_path("decile_partial_sums")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"\x7fELF")
    ready, reason = health.cache_readiness()
    assert ready and "decile_partial_sums" in reason


def test_cold_cache_exits_3_before_any_spawn(tmp_path, monkeypatch, capsys):
    """On the card the cold-cache gate runs once in the CLI's process,
    before a worker is spawned: N workers never race N builds."""
    import torch

    from csmom_tpu_torch.cli.main import main
    from csmom_tpu_torch.ops import build
    from csmom_tpu_torch.serve import supervisor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "empty")

    def no_spawn(self, h):
        raise AssertionError("a worker was spawned past a cold build")

    monkeypatch.setattr(supervisor.PoolSupervisor, "_spawn", no_spawn)
    for argv in (["serve", "--workers", "2"], ["loadgen", "--pool"]):
        assert main(argv) == 3
        err = capsys.readouterr().err
        assert "NOT READY" in err and health.BUILD_POINTER in err


def test_worker_refuses_version_skew_with_pointed_message(tmp_path):
    from csmom_tpu_torch.serve.worker import RC_VERSION_SKEW

    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.serve.worker",
         "--socket", str(tmp_path / "w.sock"), "--engine", "stub",
         "--profile", "serve-smoke",
         "--expect-cache-version", "deadbeef0000"],
        capture_output=True, text=True, timeout=60, cwd=str(tmp_path),
        env=_ENV)
    assert p.returncode == RC_VERSION_SKEW, p.stderr
    assert "skew" in p.stderr and health.BUILD_POINTER in p.stderr
    assert not (tmp_path / "w.sock").exists(), "refused before binding"


def test_pick_transport_by_socket_path_length(tmp_path):
    from csmom_tpu_torch.serve.supervisor import pick_transport

    assert pick_transport("/tmp/csmom-pool-x") == "unix"
    long_dir = "/tmp/" + "d" * 100
    assert pick_transport(long_dir) == "tcp"
    with pytest.raises(ValueError, match="too long"):
        PoolSupervisor(PoolConfig(**_SMOKE_POOL), long_dir)


# ------------------------------------------------- supervisor degradation ---

def test_supervisor_backoff_caps_a_crash_looping_worker(tmp_path,
                                                        monkeypatch):
    """A worker that dies at every spawn is restarted with growing
    backoff and PARKED after max_restarts, its stderr kept as reason."""
    monkeypatch.setenv("CSMOM_SERVE_WORKER_FAULT", "exit:1")
    cfg = PoolConfig(n_workers=1, backoff_base_s=0.02, backoff_cap_s=0.2,
                     max_restarts=2, min_uptime_s=5.0, **_SMOKE_POOL)
    sup = PoolSupervisor(cfg, str(tmp_path))
    try:
        sup.start(require_ready=False)
        h = sup.handles[0]
        _wait_for(lambda: h.state == "failed", 30.0, "crash-loop park")
        assert "crash loop" in (h.reason or "")
        events = sup.summary()["events"]
        spawns = [e for e in events if e["event"] == "spawn"]
        assert len(spawns) == 1 + cfg.max_restarts, events
        scheduled = [e for e in events if e["event"] == "restart_scheduled"]
        bases = [e["backoff_base_s"] for e in scheduled]
        assert bases == sorted(bases) and len(bases) == cfg.max_restarts
        assert any(e["event"] == "crash_loop_parked" for e in events)
        died = [e for e in events if e["event"] == "died_starting"]
        assert died and "CSMOM_SERVE_WORKER_FAULT" in died[0]["stderr"], (
            "the worker's stderr must surface in the supervisor's events")
    finally:
        sup.stop()
    assert all(h.proc.poll() is not None for h in sup.handles)


def test_supervisor_parks_a_refusing_worker_at_once(tmp_path):
    """A worker that exits RC_VERSION_SKEW is parked, not restarted."""
    cfg = PoolConfig(n_workers=1, expect_cache_version="deadbeef0000",
                     **_SMOKE_POOL)
    sup = PoolSupervisor(cfg, str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="no worker became ready"):
            sup.start()
        h = sup.handles[0]
        assert h.state == "failed" and "skew" in h.reason
        events = [e["event"] for e in sup.summary()["events"]]
        assert "refused_ready" in events and "restart_scheduled" not in events
    finally:
        sup.stop()


def test_supervisor_retry_after_reflects_backoff_state(tmp_path):
    from csmom_tpu_torch.serve.supervisor import WorkerHandle
    from csmom_tpu_torch.utils.deadline import mono_now_s

    sup = PoolSupervisor(PoolConfig(n_workers=2, **_SMOKE_POOL),
                         str(tmp_path))
    h0 = WorkerHandle(slot=0, worker_id="w0", socket_path="x")
    h1 = WorkerHandle(slot=1, worker_id="w1", socket_path="y")
    sup.handles = [h0, h1]
    h0.state, h1.state = "ready", "dead"
    assert sup.retry_after_s() is None, "a ready worker needs no hint"
    h0.state = "dead"
    h0.next_restart_at = mono_now_s() + 3.0
    h1.next_restart_at = mono_now_s() + 1.2
    hint = sup.retry_after_s()
    assert hint is not None and 0.9 <= hint <= 1.3, hint
    h0.state = h1.state = "failed"
    h0.next_restart_at = h1.next_restart_at = None
    assert sup.retry_after_s() is None


def test_tcp_crash_restart_probes_a_fresh_port(tmp_path):
    from csmom_tpu_torch.serve.supervisor import WorkerHandle

    sup = PoolSupervisor(PoolConfig(n_workers=1, transport="tcp",
                                    engine="stub", profile="serve-smoke"),
                         str(tmp_path))
    spawned = []
    sup._spawn = lambda h: spawned.append(h.socket_path)
    sup._probe_until_ready = lambda *a, **k: None
    h = WorkerHandle(slot=0, worker_id="w0",
                     socket_path="tcp:127.0.0.1:1")
    sup.handles.append(h)
    sup._restart(h)
    assert h.generation == 1
    assert spawned == [h.socket_path]
    assert h.socket_path != "tcp:127.0.0.1:1"
    assert h.socket_path.startswith("tcp:127.0.0.1:")


class _FakeWorker:
    """A hand-rolled protocol speaker on the persistent-channel serve
    loop: answers ready/score with a configurable delay."""

    def __init__(self, tmp, worker_id: str, delay_s: float):
        self.worker_id = worker_id
        self.socket_path = os.path.join(tmp, f"{worker_id}.sock")
        self.delay_s = delay_s
        self.scores = 0
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(self.socket_path)
        self._srv.listen(8)
        self._srv.settimeout(0.1)
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=proto.serve_connection,
                             args=(conn, self._handle),
                             daemon=True).start()

    def _handle(self, obj, arrays):
        if obj.get("op") == "score":
            self.scores += 1
            time.sleep(self.delay_s)
            n = arrays["values"].shape[0]
            return ({"state": "served", "worker_id": self.worker_id},
                    {"result": np.zeros(n, np.float32)})
        return {"ok": True, "worker_id": self.worker_id}, None

    def close(self):
        self._stop.set()
        self._srv.close()


def test_hedged_duplicate_suppression_exactly_one_terminal(tmp_path):
    """Slow primary, fast hedge: BOTH answer, one terminal state, the
    loser counted duplicates_suppressed."""
    slow = _FakeWorker(str(tmp_path), "slow", delay_s=0.8)
    fast = _FakeWorker(str(tmp_path), "fast", delay_s=0.05)
    try:
        router = Router(lambda: [slow, fast], RouterConfig(
            profile="serve-smoke", default_deadline_s=3.0,
            hedge_fraction=0.1, hedge_floor_s=0.05, affinity=False))
        v, m = _panel(4, 24)
        req = router.submit("momentum", v, m)
        assert req.wait(5.0)
        assert req.state == "served"
        assert req.worker_id == "fast", "the hedge should have won"
        assert req.hedged
        _wait_for(lambda: router.accounting()["duplicates_suppressed"] >= 1,
                  3.0, "the slow primary's duplicate")
        a = router.accounting()
        assert a["admitted"] == 1 and a["served"] == 1
        assert a["hedged"] == 1 and a["hedge_wins"] == 1
        assert a["duplicates_suppressed"] == 1, a
        assert slow.scores == 1 and fast.scores == 1
        assert router.invariant_violations() == []
    finally:
        slow.close()
        fast.close()


def test_router_rejects_unserveable_at_the_door(tmp_path):
    fake = _FakeWorker(str(tmp_path), "w", delay_s=0.0)
    try:
        router = Router(lambda: [fake], RouterConfig(profile="serve-smoke"))
        v, m = _panel(3, 24)
        r1 = router.submit("nope", v, m)
        r2 = router.submit("momentum", v, np.ones(3, bool))
        for r in (r1, r2):
            assert r.wait(2.0) and r.state == "rejected", (r.state, r.error)
        a = router.accounting()
        assert a["rejected_unserveable"] == 2
        assert fake.scores == 0, "door rejections must not burn dispatches"
        assert router.invariant_violations() == []
        assert router.availability() == 1.0
    finally:
        fake.close()


def test_router_with_no_workers_rejects_infra():
    router = Router(lambda: [], RouterConfig(profile="serve-smoke"))
    v, m = _panel(3, 24)
    r = router.submit("momentum", v, m)
    assert r.wait(2.0) and r.state == "rejected"
    assert "no ready worker" in (r.error or "")
    a = router.accounting()
    assert a["rejected_infra"] == 1
    assert router.availability() == 0.0
    assert router.invariant_violations() == []


def test_router_parked_fleet_rejects_fast_with_retry_after():
    router = Router(lambda: [], RouterConfig(profile="serve-smoke",
                                             default_deadline_s=5.0),
                    retry_after_fn=lambda: 1.7)
    v, m = _panel(3, 24)
    t0 = time.monotonic()
    r = router.submit("momentum", v, m)
    assert r.wait(2.0) and r.state == "rejected"
    assert time.monotonic() - t0 < 1.0
    assert r.retry_after_s == 1.7
    assert "retry after 1.7s" in (r.error or "")
    a = router.accounting()
    assert a["rejected_no_worker"] == 1 and a["rejected_infra"] == 1
    assert router.invariant_violations() == []


def test_drain_on_stop_strands_no_request_across_processes(tmp_path):
    """A burst is in flight when the fleet stops: every request still
    reaches exactly one terminal state and the books balance."""
    sup = PoolSupervisor(PoolConfig(n_workers=2, **_SMOKE_POOL),
                         str(tmp_path))
    try:
        sup.start()
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve-smoke", default_deadline_s=5.0))
        months = router.spec.months
        reqs = []
        for i in range(30):
            v, m = _panel(3, months, seed=i)
            reqs.append(router.submit("momentum", v, m))
        sup.stop()  # drain-stop mid-burst
        for r in reqs:
            assert r.wait(10.0), f"request {r.req_id} stranded: {r.state}"
            assert r.state in ("served", "rejected", "expired")
        assert router.invariant_violations() == [], router.accounting()
        a = router.accounting()
        assert a["admitted"] == 30
        assert a["served"] > 0, "the drain must finish accepted work"
    finally:
        sup.stop()
    assert all(h.proc.poll() is not None for h in sup.handles)


def test_sigkilled_worker_mid_burst_loses_no_request(tmp_path):
    """SIGKILL one worker process while its queue holds work: the books
    close, the pool keeps serving on the survivor and the restart."""
    cfg = PoolConfig(n_workers=2, backoff_base_s=0.05, backoff_cap_s=0.2,
                     **_SMOKE_POOL)
    sup = PoolSupervisor(cfg, str(tmp_path))
    try:
        sup.start()
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve-smoke", default_deadline_s=5.0))
        months = router.spec.months
        reqs = []
        for i in range(10):
            v, m = _panel(3, months, seed=i)
            reqs.append(router.submit("momentum", v, m))
        assert sup.kill_worker("w0", signal.SIGKILL)
        for i in range(10, 24):
            v, m = _panel(3, months, seed=i)
            reqs.append(router.submit("momentum", v, m))
        for r in reqs:
            assert r.wait(10.0), f"request {r.req_id} never terminal"
        assert router.invariant_violations() == [], router.accounting()
        a = router.accounting()
        assert a["admitted"] == 24
        assert a["served"] >= 20, a
        assert router.availability() >= 0.99, a
        _wait_for(lambda: sup.summary()["restarts"] >= 1, 20.0, "restart")
    finally:
        sup.stop()
    assert all(h.proc.poll() is not None for h in sup.handles)


# ---------------------------------------------- ring and fair gate ---------

def test_hash_ring_is_stable_and_moves_minimally():
    from csmom_tpu_torch.serve.router import HashRing

    ids = ["w0", "w1", "w2", "w3"]
    ring = HashRing(ids)
    keys = [f"req-{i}" for i in range(400)]
    before = {k: ring.pick(k) for k in keys}
    again = HashRing(ids)
    assert before == {k: again.pick(k) for k in keys}
    ring3 = HashRing([i for i in ids if i != "w2"])
    moved = sum(1 for k in keys
                if before[k] != "w2" and ring3.pick(k) != before[k])
    assert moved == 0
    assert all(ring3.pick(k) in ("w0", "w1", "w3")
               for k in keys if before[k] == "w2")
    assert HashRing([]).pick("anything") is None


def test_hash_ring_equals_the_reference():
    from csmom_tpu.serve.router import HashRing as RefRing
    from csmom_tpu_torch.serve.router import HashRing

    ids = ["w0", "w1", "w2"]
    keys = [f"momentum|{i}|abc|None" for i in range(300)]
    assert [HashRing(ids).pick(k) for k in keys] == \
        [RefRing(ids).pick(k) for k in keys]


def test_affinity_routes_identical_requests_to_one_worker(tmp_path):
    fakes = [_FakeWorker(str(tmp_path), f"w{i}", delay_s=0.0)
             for i in range(3)]
    try:
        router = Router(lambda: fakes, RouterConfig(
            profile="serve-smoke", default_deadline_s=5.0))
        v, m = _panel(7, 24, seed=3)
        reqs = []
        for _ in range(6):
            r = router.submit("momentum", v, m)
            assert r.wait(3.0) and r.state == "served", (r.state, r.error)
            reqs.append(r)
        assert len({r.worker_id for r in reqs}) == 1
        assert router.accounting()["affinity_routed"] >= 6
        v2, m2 = _panel(5, 24, seed=4)
        r2 = router.submit("momentum", v2, m2)
        assert r2.wait(3.0) and r2.state == "served"
    finally:
        for f in fakes:
            f.close()


def test_weighted_fair_gate_enforces_rank_and_bounds():
    from csmom_tpu_torch.serve.router import WeightedFairGate
    from csmom_tpu_torch.serve.slo import default_policy

    gate = WeightedFairGate(default_policy(), slots=1)
    assert gate.acquire("interactive", 0.5)
    got = []

    def waiter(cls):
        if gate.acquire(cls, 2.0):
            got.append(cls)
            gate.release()

    tb = threading.Thread(target=waiter, args=("bulk",), daemon=True)
    tb.start()
    time.sleep(0.05)
    ti = threading.Thread(target=waiter, args=("interactive",), daemon=True)
    ti.start()
    time.sleep(0.05)
    gate.release()
    ti.join(3.0)
    tb.join(3.0)
    assert not ti.is_alive() and not tb.is_alive()
    assert got == ["interactive", "bulk"], got
    s = gate.stats()
    assert s["slots"] == 1 and s["in_use"] == 0
    assert s["granted"]["interactive"] >= 2


def test_weighted_fair_gate_timeout_is_honest_backpressure():
    from csmom_tpu_torch.serve.router import WeightedFairGate
    from csmom_tpu_torch.serve.slo import default_policy

    gate = WeightedFairGate(default_policy(), slots=1)
    assert gate.acquire("interactive", 0.5)
    t0 = time.monotonic()
    assert not gate.acquire("bulk", 0.2)
    assert 0.15 <= time.monotonic() - t0 < 1.0
    assert gate.stats()["timeouts"]["bulk"] == 1
    gate.release()
    assert gate.acquire("bulk", 0.5)
    gate.release()


# ------------------------------------------------------------ contracts ----

def _pool_artifact(run_id="r99", value=50.0, availability=1.0,
                   infra=0, hedged=2, wins=1, suppressed=1):
    admitted = 20
    return {
        "kind": "serve_pool", "schema_version": 1, "run_id": run_id,
        "metric": "serve_pool_throughput_rps", "value": value,
        "unit": "req/s", "vs_baseline": 1.0, "wall_s": 1.0,
        "requests": {"admitted": admitted, "served": admitted - infra,
                     "rejected": infra, "expired": 0,
                     "rejected_infra": infra, "rejected_unserveable": 0,
                     "hedged": hedged, "hedge_wins": wins,
                     "duplicates_suppressed": suppressed, "retries": 0,
                     "worker_conn_failures": 0},
        "availability": availability,
        "hedge": {"hedged": hedged, "rate": round(hedged / admitted, 4),
                  "wins": wins, "suppressed": suppressed},
        "latency_ms": {"total": {"p50": 5.0, "p95": 10.0, "p99": 20.0}},
        "pool": {"n_workers": 3, "ready_workers_end": 3, "kills": 1,
                 "restarts": 1, "rolls_completed": 0, "events": []},
        "workers": [{"worker_id": f"w{i}", "state": "ready",
                     "fresh_compiles": 0} for i in range(3)],
        "compile": {"in_window_fresh_compiles": 0},
        "extra": {"platform": "gpu", "engine": "torch", "workload": "w"},
    }


@pytest.mark.parametrize("validator", [inv, ref_inv], ids=["port", "reference"])
def test_serve_pool_validator_accepts_and_detects(validator):
    art = _pool_artifact()
    assert validator.detect_kind(art) == "serve_pool"
    assert validator.validate(art) == []


@pytest.mark.parametrize("validator", [inv, ref_inv], ids=["port", "reference"])
def test_serve_pool_validator_rejects_broken_books(validator):
    art = _pool_artifact()
    art["requests"]["served"] += 1
    assert any("accounting broken" in v for v in validator.validate(art))
    art = _pool_artifact()
    art["requests"]["duplicates_suppressed"] = 99
    assert any("exactly-once" in v for v in validator.validate(art))
    art = _pool_artifact(infra=2, availability=1.0)
    assert any("reconcile" in v for v in validator.validate(art))
    art = _pool_artifact()
    art["hedge"]["rate"] = 0.9
    assert any("hedge.rate" in v for v in validator.validate(art))
    art = _pool_artifact()
    art["schema_version"] = 77
    assert any("unknown schema_version" in v for v in validator.validate(art))
    art = _pool_artifact()
    art["latency_ms"]["total"]["p95"] = 99.0
    assert any("non-decreasing" in v for v in validator.validate(art))


@pytest.mark.parametrize("name", ["SERVE_POOL_r11.json", "SERVE_POOL_r17.json"])
def test_committed_reference_pool_artifacts_pass_the_port_validator(name):
    path = os.path.join(_REPO, name)
    assert inv.validate_file(path) == []
    art = json.loads(open(path).read())
    assert art["availability"] >= 0.99
    assert art["compile"]["in_window_fresh_compiles"] == 0
    assert art["pool"]["kills"] >= 1


# ----------------------------------------------------------- acceptance ----

def test_pool_smoke_acceptance_end_to_end(tmp_path, monkeypatch):
    """``loadgen --pool --smoke --stub``: supervisor spawn → demonstrated
    ready → hedging router → closed books → a GPU_SERVE_POOL artifact
    valid under both packages' validators."""
    from csmom_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    rc = main(["loadgen", "--pool", "--smoke", "--stub", "--workers", "2",
               "--schedule", "0.5x50", "--seed", "6"])
    assert rc == 0
    path = tmp_path / "GPU_SERVE_POOL_smoke.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    art = json.loads(path.read_text())
    req = art["requests"]
    assert req["admitted"] > 0
    assert req["served"] + req["rejected"] + req["expired"] == req["admitted"]
    assert art["availability"] == 1.0
    assert art["compile"]["in_window_fresh_compiles"] == 0
    assert art["pool"]["n_workers"] == 2
    assert art["extra"]["platform"] == "stub"
    assert "smoke" in art["extra"]
    assert not list(tmp_path.glob("SERVE_POOL_*")), "the reference's prefix"


# ------------------------------------------------------- cross-package -----

def _ready(address, timeout_s=60.0):
    _wait_for(lambda: health.readiness(address, timeout_s=2.0).get("ok"),
              timeout_s, f"worker at {address} ready")


@pytest.mark.parametrize("server", ["port", "reference"])
def test_clients_and_workers_interoperate_across_packages(tmp_path, server):
    """A reference client scores on a port worker, and a port client on a
    reference worker (stub engines): one wire format."""
    address = str(tmp_path / "w.sock")
    module = ("csmom_tpu_torch.serve.worker" if server == "port"
              else "csmom_tpu.serve.worker")
    client = ref_proto if server == "port" else proto
    proc = _spawn(["--socket", address, "--engine", "stub",
                   "--profile", "serve-smoke", "--worker-id", "x0"],
                  tmp_path, server, module=module)
    try:
        _ready(address)
        v, m = _panel(6, 24, seed=5)
        obj, arrays = client.request_once(
            address, {"op": "score", "kind": "momentum",
                      "priority": "interactive", "deadline_rel_s": 5.0},
            arrays={"values": v, "mask": m}, timeout_s=10.0)
        assert obj["state"] == "served" and obj["worker_id"] == "x0"
        assert arrays["result"].shape == (6,)
        obj, _ = client.request_once(
            address, {"op": "score", "kind": "backtest",
                      "priority": "bulk", "deadline_rel_s": 5.0},
            arrays={"values": v, "mask": m}, timeout_s=10.0)
        assert obj["state"] == "served" and "result_obj" in obj
        # the multiplexed channel path too
        pool = client.ChannelPool()
        try:
            obj, arrays = pool.request(
                address, {"op": "score", "kind": "turnover",
                          "deadline_rel_s": 5.0},
                arrays={"values": v, "mask": m}, timeout_s=10.0)
            assert obj["state"] == "served"
        finally:
            pool.close()
    finally:
        _stop(proc, address)
    assert proc.poll() is not None


def test_stub_worker_never_imports_torch(tmp_path):
    """Every module a stub worker imports, while it starts, warms and
    serves each endpoint, is listed by ``-X importtime``: torch is not."""
    address = str(tmp_path / "w.sock")
    proc = _spawn(["--socket", address, "--engine", "stub",
                   "--profile", "serve-smoke"], tmp_path, "stub",
                  python_flags=("-X", "importtime"))
    try:
        _ready(address)
        v, m = _panel(5, 24, seed=1)
        for kind in KINDS:
            obj, _ = proto.request_once(
                address, {"op": "score", "kind": kind,
                          "deadline_rel_s": 5.0},
                arrays={"values": v, "mask": m}, timeout_s=10.0)
            assert obj["state"] == "served", obj
        stats, _ = proto.request_once(address, {"op": "stats"}, timeout_s=5.0)
        assert stats["kernel_launches"] is None
    finally:
        _stop(proc, address)
    log = (tmp_path / "stub.log").read_text()
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in log.splitlines()
                if ln.startswith("import time:")]
    assert "csmom_tpu_torch.serve.service" in imported
    assert not [m for m in imported if m.split(".")[0] == "torch"]


@pytest.fixture(scope="module")
def cpu_pool(tmp_path_factory):
    """Two torch-engine workers on the CPU at ``serve-smoke``, behind a
    router; stopped in the fixture's finally."""
    run_dir = tmp_path_factory.mktemp("pool")
    sup = PoolSupervisor(PoolConfig(
        n_workers=2, profile="serve-smoke", engine="torch", device="cpu",
        ready_timeout_s=120.0, poll_interval_s=0.05), str(run_dir))
    try:
        sup.start()
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve-smoke", default_deadline_s=30.0))
        yield sup, router
        router.channels.close()
    finally:
        sup.stop()
    assert all(h.proc.poll() is not None for h in sup.handles)


@pytest.mark.parametrize("kind", KINDS)
def test_torch_pool_on_the_cpu_equals_the_reference(cpu_pool, kind):
    """Requests through the router of a 2-worker torch pool on the CPU,
    against ``csmom_tpu``'s ``serve_entry_fn`` scoring each alone (padded
    to its bucket as the batcher pads it)."""
    import random

    from csmom_tpu.serve.engine import serve_entry_fn
    from csmom_tpu.serve.loadgen import synth_panel

    sup, router = cpu_pool
    assert {h.ready_report["platform"] for h in sup.handles} == {"cpu"}
    assert {h.ready_report["fresh_compiles"] for h in sup.handles} == {0}
    spec = router.spec
    A, M = spec.max_assets, spec.months
    r = random.Random(len(kind))
    panels = [synth_panel(r, n, M, kind) for n in (2, 5, A - 1, A)]
    reqs = [router.submit(kind, v, m) for v, m in panels]
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
    stats = [proto.request_once(h.socket_path, {"op": "stats"},
                                timeout_s=5.0)[0] for h in sup.handles]
    assert all(s["kernel_launches"]["cohort_partial_sums"] == 0
               for s in stats)
    assert router.invariant_violations() == []


def test_weighted_fair_gate_withdraws_the_timed_out_waiters_own_ticket():
    """Two waiters of one class queue behind a held slot; the second
    times out first.  It must withdraw its own ticket, so the slot goes to
    the first when it frees.  (The reference's dict tickets compare equal:
    its ``list.remove`` withdraws the first waiter's ticket instead, the
    freed slot is granted to the waiter that left and never released, and
    the first waiter's own withdrawal raises ``ValueError``.)"""
    from csmom_tpu_torch.serve.router import WeightedFairGate
    from csmom_tpu_torch.serve.slo import default_policy

    gate = WeightedFairGate(default_policy(), slots=1)
    assert gate.acquire("interactive", 0.5)
    got, errors = {}, []

    def waiter(name, timeout_s):
        try:
            got[name] = gate.acquire("interactive", timeout_s)
        except Exception as e:  # the reference's failure, recorded
            errors.append(e)

    ta = threading.Thread(target=waiter, args=("a", 3.0), daemon=True)
    ta.start()
    time.sleep(0.05)
    tb = threading.Thread(target=waiter, args=("b", 0.2), daemon=True)
    tb.start()
    tb.join(3.0)
    assert got.get("b") is False
    gate.release()
    ta.join(5.0)
    assert not ta.is_alive() and not tb.is_alive()
    assert errors == [] and got.get("a") is True
    gate.release()
    s = gate.stats()
    assert s["in_use"] == 0 and s["timeouts"]["interactive"] == 1
    assert gate.acquire("bulk", 0.1), "no slot may leak"
    gate.release()


def test_rolling_restart_is_warm_before_ready_and_aborts_on_skew(tmp_path):
    """Each replacement must report ready before its predecessor drains;
    a replacement that refuses (version skew) aborts the roll and the
    predecessor keeps serving."""
    sup = PoolSupervisor(PoolConfig(n_workers=2, **_SMOKE_POOL),
                         str(tmp_path))
    try:
        sup.start()
        old = {h.worker_id: h.proc.pid for h in sup.handles}
        out = sup.rolling_restart()
        assert out["aborted"] is None
        assert [r["generation"] for r in out["rolled"]] == [1, 1]
        assert all(r["fresh_compiles"] == 0 for r in out["rolled"])
        assert {h.worker_id: h.proc.pid for h in sup.handles} != old
        assert [h.state for h in sup.handles] == ["ready", "ready"]
        sup.expect_cache_version = "deadbeef0000"  # a skewed deploy
        serving = sup.handles[0].proc.pid
        out = sup.rolling_restart()
        assert out["rolled"] == [] and "skew" in out["aborted"]
        assert sup.handles[0].proc.pid == serving
        assert sup.handles[0].state == "ready"
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve-smoke", default_deadline_s=5.0))
        v, m = _panel(3, router.spec.months)
        r = router.submit("momentum", v, m)
        assert r.wait(10.0) and r.state == "served"
        router.channels.close()
        events = [e["event"] for e in sup.summary()["events"]]
        assert events.count("roll_done") == 2 and "roll_aborted" in events
    finally:
        sup.stop()
    assert all(h.proc.poll() is not None for h in sup.handles)


# --------------------------------------------------------------- ledger ----

def test_ledger_ingests_serve_pool_rows(tmp_path):
    from csmom_tpu_torch.obs import ledger as ld

    with open(tmp_path / "GPU_SERVE_POOL_r11.json", "w") as f:
        json.dump(_pool_artifact("r11", availability=0.995, infra=0), f)
    # reconcile availability with the books for this fixture
    art = _pool_artifact("r12", infra=1)
    art["availability"] = round(1 - 1 / 20, 6)
    with open(tmp_path / "GPU_SERVE_POOL_r12.json", "w") as f:
        json.dump(art, f)
    smoke = _pool_artifact("smoke")
    smoke["extra"]["smoke"] = "smoke run"
    with open(tmp_path / "GPU_SERVE_POOL_smoke.json", "w") as f:
        json.dump(smoke, f)
    L = ld.load(str(tmp_path))
    metrics = {r.metric for r in L.rows}
    assert {"serve_pool_throughput_rps", "serve_pool_p99_ms",
            "serve_pool_availability", "serve_pool_hedge_rate",
            "serve_pool_in_window_fresh_compiles"} <= metrics
    avail = [r for r in L.rows if r.metric == "serve_pool_availability"]
    assert {r.run for r in avail} == {"r11", "r12"}
    assert all(r.direction == "higher" for r in avail)
    assert {r.platform for r in avail} == {"gpu"}
    hedge = [r for r in L.rows if r.metric == "serve_pool_hedge_rate"]
    assert all(r.direction == "lower" for r in hedge)
    # the smoke artifact has no round id -> scratch, skipped with a note
    assert any("scratch" in p["note"] for p in L.problems)


def test_ledger_refuses_unknown_serve_pool_schema(tmp_path):
    from csmom_tpu_torch.obs import ledger as ld

    art = _pool_artifact("r13")
    art["schema_version"] = 42
    with open(tmp_path / "GPU_SERVE_POOL_r13.json", "w") as f:
        json.dump(art, f)
    L = ld.load(str(tmp_path))
    assert L.rows == []
    assert any("unknown serve_pool schema_version" in p["note"]
               for p in L.problems)
