"""The port's ``serve`` and ``loadgen`` commands on the CPU:
``loadgen --smoke --device cpu`` lands a ``GPU_SERVE_smoke.json`` valid
under both packages' validators with no kernel built in the window,
``serve --stub`` self-probes every endpoint, the pool (``serve --workers
N``, ``loadgen --pool``, ``--kill-worker-after``, ``--transport tcp``)
runs on stub and CPU workers and lands a valid ``GPU_SERVE_POOL_*.json``,
the fabric (``loadgen --fabric``, ``--kill-router-after``) lands a valid
``GPU_SERVE_FABRIC_*.json`` through a router and a worker kill, the fleet
flags (``--fleet``, ``--spares``, ``--autoscale``, ``--prefork``) land a
``GPU_FLEET_*.json`` valid under both packages' validators and ``fleet
<run>`` renders it, the reference's flags the port does not have yet
exit 2 naming their ROADMAP item, the
cold-cache gate exits 3, and no card means exit 2 naming ``--device
cpu``."""

import json

import pytest
import torch

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.cli.main import main

torch.set_num_threads(2)


def test_loadgen_smoke_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["loadgen", "--smoke", "--device", "cpu", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "signal service ready: engine torch, bucket profile serve-smoke" in out
    assert "in-window fresh compiles: 0" in out
    path = tmp_path / "GPU_SERVE_smoke.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    art = json.loads(path.read_text())
    assert art["compile"]["in_window_fresh_compiles"] == 0
    assert art["extra"]["platform"] == "cpu" and "smoke" in art["extra"]
    req = art["requests"]
    assert req["admitted"] > 0 and req["expired_dispatched"] == 0
    for leg in ("queue", "service", "total"):
        assert all(isinstance(art["latency_ms"][leg][q], (int, float))
                   for q in ("p50", "p95", "p99"))


def test_loadgen_named_schedule_with_reuse(tmp_path, capsys):
    assert main(["loadgen", "--stub", "--smoke", "--schedule", "0.4x100",
                 "--reuse-fraction", "0.5", "--out", str(tmp_path),
                 "--run-id", "reuse"]) == 0
    art = json.loads((tmp_path / "GPU_SERVE_reuse.json").read_text())
    assert art["offered"]["reuse_fraction"] == 0.5
    assert art["cache"]["hits"] > 0 and art["extra"]["platform"] == "stub"
    assert main(["loadgen", "--stub", "--schedule", "2q5"]) == 2


def test_serve_stub_self_probes_every_endpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["serve", "--stub", "--duration", "0.2"]) == 0
    out = capsys.readouterr().out
    assert "self-probe: all endpoints served" in out
    assert ("endpoints: momentum, turnover, backtest, low_volatility, "
            "zscore_combo") in out
    assert "in-window fresh compiles: 0" in out


def test_serve_on_the_cpu(capsys):
    assert main(["serve", "--device", "cpu", "--profile", "serve-smoke",
                 "--duration", "0.1"]) == 0
    assert "self-probe: all endpoints served" in capsys.readouterr().out


def test_serve_pool_of_stub_workers(capsys):
    assert main(["serve", "--workers", "2", "--stub", "--duration", "0.5",
                 "--hedge-fraction", "0.3"]) == 0
    out = capsys.readouterr().out
    assert "serving pool ready: 2/2 workers (engine stub" in out
    assert "hedging: fraction 0.3" in out
    assert "self-probe: all endpoints served" in out
    assert "availability: 1.0" in out


def test_serve_pool_on_the_cpu(capsys):
    assert main(["serve", "--workers", "2", "--device", "cpu", "--profile",
                 "serve-smoke", "--duration", "0.2"]) == 0
    out = capsys.readouterr().out
    assert "serving pool ready: 2/2 workers (engine torch" in out
    assert out.count("platform cpu fresh_compiles 0") == 2
    assert "self-probe: all endpoints served" in out


def test_loadgen_pool_lands_a_valid_artifact(tmp_path, capsys):
    assert main(["loadgen", "--pool", "--stub", "--smoke", "--schedule",
                 "0.6x60", "--out", str(tmp_path), "--run-id", "pool"]) == 0
    path = tmp_path / "GPU_SERVE_POOL_pool.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    art = json.loads(path.read_text())
    assert art["kind"] == "serve_pool" and art["pool"]["n_workers"] == 2
    assert art["hedge"] == {"hedged": art["requests"]["hedged"],
                            "rate": art["hedge"]["rate"],
                            "wins": art["requests"]["hedge_wins"],
                            "suppressed":
                                art["requests"]["duplicates_suppressed"]}
    assert art["compile"]["in_window_fresh_compiles"] == 0


def test_loadgen_pool_survives_a_worker_kill(tmp_path, capsys):
    assert main(["loadgen", "--pool", "--stub", "--smoke", "--schedule",
                 "1.2x50", "--kill-worker-after", "0.5", "--out",
                 str(tmp_path), "--run-id", "kill"]) == 0
    out = capsys.readouterr().out
    assert "[chaos] SIGKILL worker w0" in out
    art = json.loads((tmp_path / "GPU_SERVE_POOL_kill.json").read_text())
    req = art["requests"]
    assert req["served"] + req["rejected"] + req["expired"] == req["admitted"]
    assert req["rejected_infra"] == 0 and art["availability"] == 1.0
    assert art["pool"]["kills"] == 1 and art["pool"]["restarts"] == 1
    assert art["pool"]["ready_workers_end"] == 2
    assert inv.validate_file(str(tmp_path / "GPU_SERVE_POOL_kill.json")) == []


def test_loadgen_pool_over_tcp(tmp_path, capsys):
    assert main(["loadgen", "--pool", "--stub", "--smoke", "--transport",
                 "tcp", "--schedule", "0.4x40", "--out", str(tmp_path),
                 "--run-id", "tcp"]) == 0
    assert ("serving pool ready: 2/2 workers (engine stub, profile "
            "serve-smoke, tcp sockets)") in capsys.readouterr().out
    path = tmp_path / "GPU_SERVE_POOL_tcp.json"
    assert inv.validate_file(str(path)) == []
    art = json.loads(path.read_text())
    assert art["requests"]["served"] == art["requests"]["admitted"] > 0


def test_loadgen_fabric_lands_a_valid_artifact(tmp_path, capsys):
    assert main(["loadgen", "--fabric", "--stub", "--smoke", "--schedule",
                 "0.6x50", "--out", str(tmp_path), "--run-id", "fab"]) == 0
    out = capsys.readouterr().out
    assert "fabric ready: 2 router replicas over unix, 2/2 workers" in out
    assert "self-probe: all endpoints served" in out
    path = tmp_path / "GPU_SERVE_FABRIC_fab.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    art = json.loads(path.read_text())
    assert inv.detect_kind(art) == "serve_fabric"
    assert art["transport"] == {"scheme": "unix", "routers": 2, "workers": 2}
    assert art["extra"]["platform"] == "stub"
    assert art["compile"]["in_window_fresh_compiles"] == 0
    assert [r["torch_loaded"] for r in art["routers"]["replicas"]] == [
        False, False]
    assert main(["loadgen", "--fabric", "--stub", "--routers", "1"]) == 2
    assert "at least 2 router replicas" in capsys.readouterr().err


def test_loadgen_fabric_survives_a_router_and_a_worker_kill(tmp_path,
                                                            capsys):
    assert main(["loadgen", "--fabric", "--stub", "--smoke", "--transport",
                 "tcp", "--schedule", "1.4x40", "--kill-router-after", "0.3",
                 "--kill-worker-after", "0.5", "--out", str(tmp_path),
                 "--run-id", "kill"]) == 0
    out = capsys.readouterr().out
    assert "[chaos] SIGKILL router r0" in out
    assert "[chaos] SIGKILL worker w0" in out
    art = json.loads((tmp_path / "GPU_SERVE_FABRIC_kill.json").read_text())
    req = art["requests"]
    assert req["served"] + req["rejected"] + req["expired"] == req["admitted"]
    assert req["rejected_infra"] == 0 and art["availability"] == 1.0
    for tier in ("routers", "workers"):
        assert art[tier]["kills"] == 1 and art[tier]["restarts"] == 1
        assert art[tier]["ready_end"] == 2
    assert art["transport"]["scheme"] == "tcp"
    assert inv.validate_file(str(tmp_path / "GPU_SERVE_FABRIC_kill.json")) == []


def test_loadgen_trace_lands_a_valid_trace_artifact(tmp_path, capsys):
    """``--trace`` arms the book once the service is ready and lands
    ``GPU_TRACE_<run>.json`` beside the serve artifact, valid under both
    packages' validators, its books equal to the run's request books."""
    assert main(["loadgen", "--stub", "--smoke", "--trace", "--out",
                 str(tmp_path), "--run-id", "traced"]) == 0
    assert "trace artifact: " in capsys.readouterr().out
    path = tmp_path / "GPU_TRACE_traced.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    books = json.loads(path.read_text())["books"]
    req = json.loads((tmp_path / "GPU_SERVE_traced.json").read_text())["requests"]
    assert (books["opened"], books["complete"]) == (req["admitted"], req["served"])


def _fleet_art(tmp_path, run_id):
    """The landed ``GPU_FLEET_<run_id>.json`` and its serve artifact, each
    checked under both packages' validators."""
    path = tmp_path / f"GPU_FLEET_{run_id}.json"
    assert inv.validate_file(str(path)) == []
    assert ref_inv.validate_file(str(path)) == []
    fleet = json.loads(path.read_text())
    serve = json.loads(next(tmp_path.glob(
        f"GPU_SERVE_*_{run_id}.json")).read_text())
    assert ref_inv.validate(serve) == []
    return fleet, serve


def test_loadgen_fabric_fleet_lands_a_valid_fleet_artifact(tmp_path, capsys):
    assert main(["loadgen", "--fabric", "--stub", "--smoke", "--fleet",
                 "--schedule", "0.6x50", "--out", str(tmp_path), "--run-id",
                 "fl"]) == 0
    out = capsys.readouterr().out
    assert "fleet observatory armed: aggregator at" in out
    assert "reason-closed" in out and "fleet artifact:" in out
    fleet, serve = _fleet_art(tmp_path, "fl")
    assert serve["extra"]["observatory_armed"] is True
    books = fleet["series"]["books"]
    # the load generator, two replicas and two workers streamed, and
    # every stream closed with a fin
    assert books["procs_opened"] == books["procs_closed"] == 5
    assert books["seq_gaps"] == 0
    assert all(b["close_reason"].startswith("fin:")
               for b in fleet["series"]["processes"].values())
    demand = fleet["demand"]["classes"]
    assert (sum(c.get("offered", 0) for c in demand.values())
            == serve["requests"]["admitted"])
    assert fleet["elastic"] is None and fleet["extra"]["platform"] == "stub"


def test_loadgen_spares_promotes_a_spare_on_a_kill(tmp_path, capsys):
    assert main(["loadgen", "--fabric", "--stub", "--smoke", "--fleet",
                 "--spares", "1", "--schedule", "1.0x40",
                 "--kill-worker-after", "0.3", "--out", str(tmp_path),
                 "--run-id", "spare"]) == 0
    out = capsys.readouterr().out
    assert "elastic: 1 hot spare(s) parked out of the ring" in out
    assert "elastic: 1 promotion(s)" in out
    fleet, serve = _fleet_art(tmp_path, "spare")
    el = fleet["elastic"]
    (promo,) = el["promotions"]
    assert promo["victim"] == "w0" and promo["spare"] == "s0"
    assert el["spares"]["promoted"] == 1 and el["spare_ids"][0] == "s0"
    kinds = {(e["worker_id"], e["kind"]) for e in fleet["lifecycle"]["events"]}
    assert ("w0", "spare-promotion") in kinds
    assert serve["availability"] == 1.0
    # the promotion refills the reserve off the hot path
    assert el["spares"]["backfills"] == 1 and el["spares"]["spawned"] >= 1


def test_loadgen_autoscale_fills_a_reasoned_elastic_block(tmp_path, capsys):
    assert main(["loadgen", "--pool", "--stub", "--smoke", "--fleet",
                 "--autoscale", "--schedule", "2.5x20", "--out",
                 str(tmp_path), "--run-id", "auto"]) == 0
    fleet, _ = _fleet_art(tmp_path, "auto")
    el = fleet["elastic"]
    assert el["autoscale"] is True and el["spares_configured"] == 0
    assert el["bounds"] == {"min_workers": 2, "max_workers": 4}
    assert el["decisions"], "the control loop ran"
    assert all(d["reason"].strip() for d in el["decisions"])
    assert {d["action"] for d in el["decisions"]} <= {
        "scale_up", "scale_down", "hold", "tune_quota"}
    for q in el["quota"]["applied"]:
        assert 8.0 <= q["quota_rps"] <= 64.0


def test_loadgen_prefork_spawns_spares_through_the_parent(tmp_path, capsys):
    assert main(["loadgen", "--pool", "--stub", "--smoke", "--fleet",
                 "--spares", "1", "--prefork", "--schedule", "0.6x30",
                 "--out", str(tmp_path), "--run-id", "pre"]) == 0
    out = capsys.readouterr().out
    assert "prefork warm path" in out
    fleet, serve = _fleet_art(tmp_path, "pre")
    assert fleet["elastic"]["prefork"] is True
    events = serve["pool"]["events"]
    (ready,) = [e for e in events if e["event"] == "prefork_ready"]
    assert ready["native_threads"] == 1 and ready["cuda_initialized"] is False
    spawns = [e for e in events if e["event"] == "spare_spawn"]
    assert spawns and all(e["via"] == "prefork" and e["native_threads"] == 1
                          for e in spawns)


def test_fleet_command_renders_a_landed_artifact(tmp_path, capsys):
    assert main(["loadgen", "--fabric", "--stub", "--smoke", "--fleet",
                 "--schedule", "0.5x40", "--kill-worker-after", "0.2",
                 "--out", str(tmp_path), "--run-id", "show"]) == 0
    capsys.readouterr()
    assert main(["fleet", "show", "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for header in ("worker-tier capacity account", "lifecycle walls",
                   "demand book", "stream books"):
        assert header in out
    assert "stream severed" in out, "the killed worker's book"
    path = tmp_path / "GPU_FLEET_show.json"
    bad = json.loads(path.read_text())
    bad["capacity"]["kill_window_loss_frac"] = 1.5
    path.write_text(json.dumps(bad))
    assert main(["fleet", str(path)]) == 1
    assert "kill_window_loss_frac" in capsys.readouterr().err
    assert main(["fleet", "nothing-here", "--root", str(tmp_path)]) == 2


def test_fleet_flags_without_a_card_exit_2_naming_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    assert main(["loadgen", "--fabric", "--fleet", "--spares", "1",
                 "--autoscale", "--prefork"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_cold_cache_gate_exits_3(tmp_path, monkeypatch, capsys):
    """With a card and no built K1, serving would build inside the ready
    probe: both commands refuse with exit 3 before touching the card."""
    from csmom_tpu_torch.ops import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "empty")
    for cmd in ("serve", "loadgen"):
        assert main([cmd, "--device", "cuda"]) == 3
        err = capsys.readouterr().err
        assert "NOT READY" in err and "decile_partial_sums" in err
        assert "python -m csmom_tpu_torch.ops.build" in err


def test_no_card_exits_2_naming_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for cmd in ("serve", "loadgen"):
        assert main([cmd]) == 2
        assert "--device cpu" in capsys.readouterr().err


def test_serve_and_loadgen_are_listed():
    from csmom_tpu_torch.cli.main import build_parser

    epilog = build_parser().epilog
    assert "  serve " in epilog and "  loadgen " in epilog
