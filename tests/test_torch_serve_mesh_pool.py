"""The port's mesh serving engine across processes, on the CPU: pinned
pool workers, the worker's ``--device-slice``, and the CLI.

Mirrors the pinning cases of ``tests/test_mesh.py`` and
``tests/test_serve_pool.py`` against the port.  A pool of two
``torch-mesh`` workers with ``devices_per_worker=2`` on the CPU pins
slot k to ``k*2:2`` (two logical CPU shards each, the form
``auto_mesh(n, device="cpu")`` takes): the argv carries
``--device-slice``, each ready report its slice and a d2 mesh, a
SIGKILLed worker respawns on its own slice, and results equal the
single-device engine.  The worker exports ``CSMOM_MESH_DEVICE_SLICE``
before it builds its engine.  The CLI's ``serve --mesh``, ``loadgen
--mesh`` (an artifact valid under both packages' validators) and
``--devices-per-worker``.  Every spawned process is stopped in a
``finally``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.cli.main import main
from csmom_tpu_torch.mesh import DEVICE_SLICE_ENV
from csmom_tpu_torch.serve import health, proto
from csmom_tpu_torch.serve.router import Router, RouterConfig
from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": _REPO}
KINDS = ("momentum", "turnover", "backtest", "low_volatility", "zscore_combo")


def _wait_for(pred, timeout_s: float, what: str) -> None:
    give_up = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > give_up:
            raise AssertionError(f"timed out after {timeout_s}s: {what}")
        time.sleep(0.02)


@pytest.fixture(scope="module")
def mesh_pool(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("mpool")
    sup = PoolSupervisor(PoolConfig(
        n_workers=2, profile="serve-smoke", engine="torch-mesh", device="cpu",
        devices_per_worker=2, ready_timeout_s=120.0, poll_interval_s=0.05,
        backoff_base_s=0.05, min_uptime_s=0.0), str(run_dir))
    try:
        sup.start()
        router = Router(sup.ready_workers, RouterConfig(
            profile="serve-smoke", default_deadline_s=30.0))
        yield sup, router
        router.channels.close()
    finally:
        sup.stop()
    assert all(h.proc.poll() is not None for h in sup.handles)


def test_pinned_workers_own_their_slot_slices(mesh_pool):
    sup, _ = mesh_pool
    assert [h.device_slice for h in sup.handles] == ["0:2", "2:2"]
    for h in sup.handles:
        argv = sup._slot_argv(h)
        assert argv[argv.index("--device-slice") + 1] == h.device_slice
        assert argv[argv.index("--engine") + 1] == "torch-mesh"
        rep = h.ready_report
        assert rep["ok"] and rep["device_slice"] == h.device_slice
        assert rep["warm"]["mesh"]["devices"] == 2
        assert rep["fresh_compiles"] == 0 and rep["platform"] == "cpu"
    assert sup.expect_cache_version == health.aot_cache_version(
        "serve-smoke", engine="torch-mesh", mesh_devices=2)
    assert [w["device_slice"] for w in sup.worker_stats()] == ["0:2", "2:2"]


def test_pinned_pool_results_equal_the_single_device_engine(mesh_pool):
    from csmom_tpu_torch.serve.engine import TorchEngine, unpack_result

    _, router = mesh_pool
    single = TorchEngine(device="cpu")
    rng = np.random.default_rng(3)
    for kind in KINDS:
        v = (100.0 * np.exp(np.cumsum(rng.normal(0, 0.03, (8, 24)), axis=1))
             ).astype(np.float32)
        m = np.ones((8, 24), bool)
        req = router.submit(kind, v, m)
        assert req.wait(60.0) and req.state == "served", (req.state, req.error)
        want = unpack_result(kind, single.score(kind, v[None], m[None]), 0, 8)
        if isinstance(want, dict):
            for f in want:
                np.testing.assert_array_equal(req.result[f], want[f])
        else:
            np.testing.assert_array_equal(np.asarray(req.result), want)


def test_a_killed_worker_respawns_on_its_own_slice(mesh_pool):
    sup, _ = mesh_pool
    h = sup.handles[0]
    gen, pid = h.generation, h.proc.pid
    os.kill(pid, 9)
    _wait_for(lambda: h.generation > gen and h.state == "ready", 120.0,
              "w0 respawned ready")
    assert h.device_slice == "0:2" and h.ready_report["device_slice"] == "0:2"
    spawns = [e for e in sup.events if e["event"] == "spawn"
              and e["worker_id"] == "w0"]
    assert [e["device_slice"] for e in spawns] == ["0:2"] * len(spawns)
    assert len(spawns) >= 2


def test_the_worker_exports_its_slice_before_building_its_engine(
        tmp_path, monkeypatch):
    """``--device-slice`` reaches the environment before the engine is
    built: the engine meshes the slice's count of logical shards."""
    from csmom_tpu_torch.serve import worker

    seen = {}

    class Probe:
        def __init__(self, socket_path, config, worker_id="w0",
                     device_slice=None):
            from csmom_tpu_torch.serve.engine import make_engine

            seen["env"] = os.environ.get(DEVICE_SLICE_ENV)
            seen["devices"] = make_engine(config.engine,
                                          device=config.device).devices
            seen["slice"] = device_slice
            raise SystemExit(0)

    monkeypatch.delenv(DEVICE_SLICE_ENV, raising=False)
    monkeypatch.setattr(worker, "WorkerServer", Probe)
    with pytest.raises(SystemExit):
        worker.main(["--socket", str(tmp_path / "w.sock"), "--engine",
                     "jax-mesh", "--device", "cpu", "--profile", "serve-smoke",
                     "--device-slice", "4:4"])
    assert seen["env"] == seen["slice"] == "4:4"
    assert len(seen["devices"]) == 4
    os.environ.pop(DEVICE_SLICE_ENV, None)


@pytest.mark.parametrize("bad", ["x", "0", "-1:2", "1:0"])
def test_the_worker_refuses_a_malformed_slice_with_exit_2(tmp_path, bad):
    p = subprocess.run(
        [sys.executable, "-m", "csmom_tpu_torch.serve.worker",
         "--socket", str(tmp_path / "w.sock"), "--engine", "stub",
         f"--device-slice={bad}"],
        capture_output=True, text=True, timeout=60, cwd=str(tmp_path),
        env=_ENV)
    assert p.returncode == 2 and "bad device slice" in p.stderr
    assert not (tmp_path / "w.sock").exists()


def test_a_stub_worker_reports_its_slice(tmp_path):
    """The slice is the pinning contract's evidence in any engine's
    ready report."""
    addr = str(tmp_path / "w.sock")
    log = open(tmp_path / "w.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "csmom_tpu_torch.serve.worker", "--socket",
         addr, "--engine", "stub", "--profile", "serve-smoke",
         "--device-slice", "2:2"], stdout=log, stderr=log, env=_ENV,
        cwd=str(tmp_path))
    log.close()
    try:
        _wait_for(lambda: health.readiness(addr, timeout_s=2.0).get("ok"),
                  60.0, "stub worker ready")
        assert health.readiness(addr)["device_slice"] == "2:2"
    finally:
        try:
            proto.request_once(addr, {"op": "stop"}, timeout_s=5.0)
        except (OSError, proto.ProtocolError):
            pass
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_pool_config_takes_the_warm_up_report_subdir(tmp_path):
    """``cache_subdir`` names the warm-up report the workers read their
    evidence from; it rides the worker argv as ``--cache-subdir``."""
    sup = PoolSupervisor(PoolConfig(n_workers=1, profile="serve-smoke",
                                    engine="stub", cache_subdir="mesh"),
                         str(tmp_path))
    from csmom_tpu_torch.serve.supervisor import WorkerHandle

    argv = sup._slot_argv(WorkerHandle(slot=0, worker_id="w0",
                                       socket_path="s.sock"))
    assert argv[argv.index("--cache-subdir") + 1] == "mesh"
    assert "--device-slice" not in argv


def test_cache_readiness_reports_the_mesh_warm_up_coverage(tmp_path,
                                                           monkeypatch):
    from csmom_tpu_torch.compile import aot
    from csmom_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    lib = build.library_path("decile_partial_sums")
    lib.parent.mkdir(parents=True, exist_ok=True)
    lib.write_bytes(b"\x7fELF")
    names = sorted(health.expected_entry_names("serve-smoke", mesh_devices=2))
    d = aot.report_dir("mesh")
    os.makedirs(d)
    with open(os.path.join(d, aot.REPORT_NAME), "w") as f:
        json.dump({"entries": [{"name": n} for n in names[:3]]}, f)
    ready, reason = health.cache_readiness("serve-smoke", "mesh",
                                           mesh_devices=2)
    assert ready and "d2 mesh" in reason
    assert f"covers 3 of the {len(names)} entries" in reason
    ready, reason = health.cache_readiness("serve-smoke", "nowhere",
                                           mesh_devices=2)
    assert ready and "no warm-up report" in reason


# ------------------------------------------------------------------- CLI ---

def test_serve_mesh_on_logical_cpu_shards(capsys):
    assert main(["serve", "--mesh", "--profile", "serve-smoke", "--device",
                 "cpu", "--shards", "4",
                 "--duration", "0.1"]) == 0
    out = capsys.readouterr().out
    assert "engine torch-mesh" in out and "'devices': 4" in out
    assert "all endpoints served" in out


def test_loadgen_mesh_lands_a_mesh_artifact_valid_under_both_validators(
        tmp_path, capsys):
    assert main(["loadgen", "--mesh", "--smoke", "--device", "cpu",
                 "--shards", "8", "--out", str(tmp_path),
                 "--run-id", "m"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 8 devices" in out
    path = tmp_path / "GPU_SERVE_MESH_m.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    art = json.loads(path.read_text())
    mesh = art["extra"]["mesh"]
    assert mesh["devices"] == 8
    assert {k: v for k, v in mesh.items() if k != "scaling"} == \
        art["extra"]["warm_report"]["mesh"]
    assert mesh["scaling"]["shards"] == 8
    assert art["extra"]["workload"].endswith("torch-mesh engine, mesh d8)")
    assert art["compile"]["in_window_fresh_compiles"] == 0
    assert not list(tmp_path.glob("GPU_SERVE_m.json"))


def test_loadgen_pool_with_devices_per_worker(tmp_path, capsys):
    assert main(["loadgen", "--pool", "--mesh", "--smoke", "--device", "cpu",
                 "--devices-per-worker", "2", "--out", str(tmp_path),
                 "--run-id", "mp"]) == 0
    path = tmp_path / "GPU_SERVE_POOL_mp.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    art = json.loads(path.read_text())
    assert art["extra"]["workload"].endswith("torch-mesh engine, 2 dev/worker)")
    assert art["requests"]["rejected_infra"] == 0


@pytest.mark.parametrize("argv,needle", [
    (["serve", "--mesh", "--stub"], "--mesh has no effect with --stub"),
    (["serve", "--devices-per-worker", "2", "--device", "cpu"],
     "without --mesh"),
])
def test_mesh_flags_without_the_mesh_engine_warn_and_serve(argv, needle,
                                                           capsys):
    """The flags the port once refused with exit 2 now run, warning as the
    reference warns where they do nothing."""
    assert main([*argv, "--profile", "serve-smoke", "--duration", "0.05"]) == 0
    assert needle in capsys.readouterr().err


@pytest.mark.parametrize("argv,needle", [
    (["serve", "--mesh", "--shards", "2"], "exceeds the 1 visible"),
    (["loadgen", "--pool", "--mesh", "--devices-per-worker", "2"],
     "more than the 1 visible"),
    (["serve", "--mesh", "--shards", "0", "--device", "cpu"], "at least 1"),
])
def test_mesh_flags_asking_for_absent_cards_exit_2(argv, needle, capsys,
                                                   monkeypatch):
    import torch

    # one card, as on the chip machine: the checks run before any is used
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main(argv) == 2
    assert needle in capsys.readouterr().err


def test_warmup_serve_mesh_profile_runs_and_is_read_back(tmp_path, monkeypatch,
                                                         capsys):
    from csmom_tpu_torch.compile.aot import read_warmup_report
    from csmom_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert main(["warmup", "--profiles", "serve-mesh-smoke", "--device", "cpu",
                 "--strict", "--no-golden-event", "--cache-subdir", "m"]) == 0
    rep = read_warmup_report("m")
    names = {e["name"] for e in rep["entries"] if not e.get("error")}
    assert names == health.expected_entry_names("serve-smoke", mesh_devices=1)
