"""Meshes over several processes (ROADMAP.md item 7c) on the CPU.

Two processes of 4 logical CPU shards each, joined over gloo on a free
loopback port (:mod:`csmom_tpu_torch.parallel.multihost_dryrun`), run the
sharded monthly and banded engines on the seeded 96 x 72 f64 panel and
the time-sharded online ridge at 4 x 64 x 3.  Their results are held
bit-equal to the one-process 8-shard run of the same engines, within the
dry run's tolerances of the port's single-device engines, and within f64
``rtol=1e-10, atol=1e-13`` of ``csmom_tpu``'s single-device engines.
Every test that starts processes bounds them (at most 170 s) and kills
them at the end.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from csmom_tpu_torch.mesh.rules import P
from csmom_tpu_torch.parallel import multihost_dryrun as mh
from csmom_tpu_torch.parallel.collectives import (
    sharded_banded_backtest,
    sharded_monthly_spread_backtest,
)
from csmom_tpu_torch.parallel.mesh import (
    Mesh,
    backend,
    distributed_init,
    distributed_shutdown,
    make_hybrid_mesh,
    make_mesh,
    mesh_topology,
    pick_backend,
    process_count,
    process_index,
)
from csmom_tpu_torch.parallel.online_ridge import time_sharded_online_ridge_scores

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_LIMIT_S = 170.0
TOL = dict(rtol=1e-10, atol=1e-13)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bits_equal(a, b) -> bool:
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One 2 x 4 run: the processes' records, their saved results, and
    the summary line."""
    save = tmp_path_factory.mktemp("multihost")
    records = mh.launch(device="cpu", save=str(save), timeout=TIME_LIMIT_S)
    saved = [dict(np.load(save / f"rank{r}.npz")) for r in range(mh.N_PROC)]
    return records, saved, mh.summary(records, "cpu")


@pytest.fixture(scope="module")
def one_process():
    """The same engines on one process's 8-shard meshes."""
    prices, mask = mh.dryrun_panel()
    mesh_a = Mesh(["cpu"] * 8, ("assets",))
    spread, valid, mean, sh, ts = sharded_monthly_spread_backtest(prices, mask, mesh_a)
    b = sharded_banded_backtest(prices, mask, mesh_a, lookback=12, skip=1,
                                n_bins=5, band=1)
    feats, y, yv = (torch.as_tensor(x) for x in mh.ridge_inputs())
    fit = time_sharded_online_ridge_scores(feats, y, yv, Mesh(["cpu"] * 8, ("time",)),
                                           alpha=mh.RIDGE_ALPHA,
                                           burn_in=mh.RIDGE_BURN_IN)
    return {"spread": spread.numpy(), "valid": valid.numpy(),
            "stats": np.array([float(mean), float(sh), float(ts)]),
            "b_spread": b[0].numpy(), "b_valid": b[1].numpy(),
            "b_stats": np.array([float(b[2]), float(b[3]), float(b[4])]),
            "scores": fit.scores.numpy(), "cv_mse": fit.cv_mse.numpy(),
            "coef": fit.coef.numpy()}


def test_two_processes_are_bit_equal_to_the_one_process_eight_shard_run(run,
                                                                        one_process):
    """Every output of either process equals the one-process run's bit for
    bit: the groups combine in global shard order across the boundary."""
    _, saved, _ = run
    for rank, got in enumerate(saved):
        for key, want in one_process.items():
            assert _bits_equal(got[key], want), (rank, key)


def test_two_processes_hold_the_dry_runs_tolerances(run):
    """Process 0's checks against the port's single-device engines pass,
    the backend is named (gloo: the shards are CPU devices), the one mesh
    axis crosses processes, each process holds only its own input blocks
    and gathers the whole panel, and CPU tensors launch no kernel."""
    records, _, line = run
    assert line["value"] == 1.0 and line["metric"] == "multihost_sharded_equals_single"
    extra = line["extra"]
    assert extra["monthly_equal"] and extra["banded_equal"] and extra["online_ridge_equal"]
    assert extra["backend"] == "gloo" and "gloo" in extra["topology"]
    for rank, rec in enumerate(records):
        assert rec["backend"] == "gloo"
        assert rec["topology"] == {
            "assets": {"size": 8, "crosses_hosts": True, "backend": "gloo"},
            "time": {"size": 8, "crosses_hosts": True, "backend": "gloo"}}
        assert rec["local_shards"] == list(range(4 * rank, 4 * rank + 4))
        assert rec["gathered_equal"] is True
        assert rec["monthly_launches"] == 0
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}


def test_two_processes_match_the_references_single_device_engines(run):
    """In this process: both processes' results against csmom_tpu's
    single-device monthly, banded and online-ridge engines in f64."""
    import jax.numpy as jnp

    from csmom_tpu.backtest import banded_monthly_backtest, monthly_spread_backtest
    from csmom_tpu.models.online_ridge import online_ridge_scores

    prices, mask = mh.dryrun_panel()
    feats, y, yv = mh.ridge_inputs()
    ref = monthly_spread_backtest(prices, mask)
    ref_b = banded_monthly_backtest(prices, mask, lookback=12, skip=1, n_bins=5, band=1)
    ref_r = online_ridge_scores(jnp.asarray(feats), jnp.asarray(y), jnp.asarray(yv),
                                alpha=mh.RIDGE_ALPHA, burn_in=mh.RIDGE_BURN_IN)
    _, saved, _ = run
    for got in saved:
        np.testing.assert_array_equal(got["valid"], np.asarray(ref.spread_valid))
        np.testing.assert_allclose(got["spread"], np.asarray(ref.spread),
                                   equal_nan=True, **TOL)
        np.testing.assert_allclose(got["stats"][0], float(ref.mean_spread), **TOL)
        np.testing.assert_array_equal(got["b_valid"], np.asarray(ref_b.spread_valid))
        np.testing.assert_allclose(got["b_spread"], np.asarray(ref_b.spread),
                                   equal_nan=True, **TOL)
        np.testing.assert_allclose(got["b_stats"][2], float(ref_b.tstat_nw), **TOL)
        np.testing.assert_allclose(got["scores"], np.asarray(ref_r.scores),
                                   equal_nan=True, **TOL)


def test_a_dead_peer_raises_and_never_hangs(tmp_path):
    """Process 1 dies after joining; process 0's next collective that
    crosses to it raises (within the group's timeout), it does not
    wait for ever."""
    script = tmp_path / "dead_peer.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        import torch
        from csmom_tpu_torch.parallel import compat
        from csmom_tpu_torch.parallel.compat import P, psum, shard_map
        from csmom_tpu_torch.parallel.mesh import Mesh, distributed_init, global_devices

        compat.BARRIER_TIMEOUT_S = 30.0
        rank, port = int(sys.argv[1]), int(sys.argv[2])
        distributed_init(f"127.0.0.1:{port}", 2, rank, devices=["cpu"] * 2)
        devices, procs = global_devices()
        mesh = Mesh(devices, ("assets",), processes=procs)
        if rank == 1:
            os._exit(3)
        t0 = time.monotonic()
        try:
            shard_map(lambda x: psum(x, "assets"), mesh=mesh, in_specs=(P("assets"),),
                      out_specs=P())(torch.ones(4))
        except Exception as e:
            print("RAISED", type(e).__name__, round(time.monotonic() - t0, 1), flush=True)
            os._exit(0)
        print("RETURNED", flush=True)
        os._exit(1)
    """))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": _REPO}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(2)]
    try:
        out0, _ = procs[0].communicate(timeout=TIME_LIMIT_S)
        procs[1].wait(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[0].returncode == 0, out0
    assert "RAISED" in out0
    assert procs[1].returncode == 3


def test_world_size_one_changes_nothing():
    """Joined at world size 1, a process's meshes are its own, and the
    sharded monthly engine's result is the unjoined one's, bit for bit."""
    prices, mask = mh.dryrun_panel()
    before = sharded_monthly_spread_backtest(prices, mask, Mesh(["cpu"] * 4, ("assets",)))
    assert distributed_init(f"127.0.0.1:{_free_port()}", 1, 0,
                            devices=["cpu"] * 4) is True
    try:
        assert distributed_init("127.0.0.1:1", 1, 0, devices=["cpu"]) is False
        assert (process_index(), process_count(), backend()) == (0, 1, "gloo")
        mesh = make_mesh(axis_names=("grid", "assets"))
        assert mesh.size == 4 and mesh.processes == (0,) * 4
        assert mesh_topology(mesh)["assets"] == {"size": 4, "crosses_hosts": False}
        after = sharded_monthly_spread_backtest(prices, mask, mesh)
    finally:
        distributed_shutdown()
    assert (process_index(), process_count(), backend()) == (0, 1, None)
    for a, b in zip(before, after):
        assert _bits_equal(a.numpy(), b.numpy())


def test_the_backend_is_named_never_guessed():
    """gloo for CPU shards and for processes sharing a card, nccl when
    every process owns cards of its own; nccl where NCCL refuses raises."""
    cpu = [("h", ["cpu", "cpu"]), ("h", ["cpu", "cpu"])]
    shared = [("h", ["cuda:0"] * 4), ("h", ["cuda:0"] * 4)]
    distinct = [("h", ["cuda:0", "cuda:1"]), ("h", ["cuda:2", "cuda:3"])]
    hosts = [("a", ["cuda:0"]), ("b", ["cuda:0"])]
    assert [pick_backend(p) for p in (cpu, shared, distinct, hosts)] == [
        "gloo", "gloo", "nccl", "nccl"]
    assert pick_backend(distinct, "gloo") == "gloo"
    for peers, why in ((shared, "share a card"), (cpu, "CPU devices")):
        with pytest.raises(ValueError, match=why):
            pick_backend(peers, "nccl")
    with pytest.raises(ValueError, match="backend must be one of"):
        pick_backend(cpu, "mpi")


def test_an_nccl_exchange_runs_on_the_card_bound_at_the_join(monkeypatch):
    """Over nccl every exchange of a process runs on its first card,
    whichever card the calling shard thread is on, so a process owning
    several cards uses one communicator; over gloo (host memory) each
    thread's own card stays current."""
    import contextlib
    import threading

    import torch.distributed as dist

    from csmom_tpu_torch.parallel import mesh as mesh_mod

    current = threading.local()

    @contextlib.contextmanager
    def on(dev):
        prev, current.dev = getattr(current, "dev", None), torch.device(dev)
        try:
            yield
        finally:
            current.dev = prev

    seen = []

    def gather(out, obj):
        seen.append(getattr(current, "dev", None))
        out[:] = [obj] * len(out)

    monkeypatch.setattr(torch.cuda, "device", on)
    monkeypatch.setattr(dist, "all_gather_object", gather)
    cards = ("cuda:1", "cuda:3")
    pinned = [torch.device("cuda:1")] * 2
    for name, expect in (("nccl", pinned), ("gloo", [torch.device(d) for d in cards])):
        monkeypatch.setattr(mesh_mod, "_JOINED", mesh_mod._Joined(
            rank=1, world=2, backend=name,
            devices=(("cuda:0", "cuda:2"), ("cuda:1", "cuda:3"))))
        seen.clear()

        def shard(dev):
            with torch.cuda.device(dev):
                assert mesh_mod.process_allgather(7) == [7, 7]

        threads = [threading.Thread(target=shard, args=(d,))
                   for d in cards]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(seen, key=str) == expect, (name, seen)


def test_the_dry_run_gives_each_process_its_device_list():
    """``--device`` names one device for every process, or one comma list
    a process separated by ';'; any other count is refused."""
    assert mh._process_devices("cpu", 1) == [torch.device("cpu")]
    spec = "cuda:0,cuda:1;cuda:2,cuda:3"
    assert [mh._process_devices(spec, r) for r in (0, 1)] == [
        [torch.device("cuda:0"), torch.device("cuda:1")],
        [torch.device("cuda:2"), torch.device("cuda:3")]]
    with pytest.raises(ValueError, match="separated by ';'"):
        mh._process_devices("cpu;cpu;cpu", 0)
    assert mh._no_card("cpu;cpu") is None


def test_topology_names_the_axes_that_cross_processes():
    """A hybrid mesh's host rows are processes: its first axis crosses
    them and the asset axis stays within one, as the reference lays out
    a pod; the process owning no entry of a mesh cannot build it."""
    mesh = make_hybrid_mesh(["cpu"] * 8, processes=[0] * 4 + [1] * 4)
    assert dict(mesh.shape) == {"grid": 2, "assets": 4}
    assert mesh.local_shards == (0, 1, 2, 3) and mesh.n_processes == 2
    topo = mesh_topology(mesh)
    assert topo["grid"]["crosses_hosts"] is True
    assert topo["assets"] == {"size": 4, "crosses_hosts": False}
    with pytest.raises(ValueError, match="2 processes present"):
        make_hybrid_mesh(["cpu"] * 8, n_hosts=4, processes=[0] * 4 + [1] * 4)
    with pytest.raises(ValueError, match="no shard of process 0"):
        Mesh(["cpu"] * 2, ("assets",), processes=[1, 1])


def test_a_mesh_over_processes_refuses_to_run_unjoined():
    """A collective that crosses processes needs the joined group: without
    it the shard raises, naming distributed_init."""
    from csmom_tpu_torch.parallel.compat import psum, shard_map

    mesh = Mesh(["cpu"] * 4, ("assets",), processes=[0, 0, 1, 1])
    fn = shard_map(lambda x: psum(x, "assets"), mesh=mesh, in_specs=(P("assets"),),
                   out_specs=P())
    with pytest.raises(RuntimeError, match="distributed_init"):
        fn(torch.ones(4))


def test_the_dry_run_cli_prints_one_line(capsys):
    """``main`` with ``--device cpu`` runs the two processes and prints
    one JSON object with the reference's fields, exit 0 when it holds."""
    rc = mh.main(["--device", "cpu", "--timeout", str(TIME_LIMIT_S)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1, lines
    line = json.loads(lines[0])
    assert line["value"] == 1.0 and line["extra"]["backend"] == "gloo"
    for key in ("topology", "workload", "monthly_equal", "banded_equal",
                "online_ridge_equal", "monthly_wall_s", "banded_wall_s",
                "online_ridge_wall_s", "note"):
        assert key in line["extra"]


def test_the_dry_run_runs_on_the_card_unless_asked_for_the_cpu(capsys):
    """The default device is ``cuda:0``: with no card visible the command
    exits 2 naming ``--device cpu`` and starts no process, and ``launch``
    raises the same."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs on it")
    rc = mh.main([])
    err = capsys.readouterr()
    assert rc == 2 and err.out == "" and "--device cpu" in err.err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mh.launch()
