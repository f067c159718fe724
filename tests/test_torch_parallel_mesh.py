"""The port's mesh layer against csmom_tpu's: mesh construction, hybrid
emulation, topology, padding, device-slice pinning and the partition-rule
tables name for name; the single-controller ``shard_map`` (collectives
against hand results, the device each shard runs under, a raising shard);
and the kernels' launch counters under threads."""

import threading
import time

import numpy as np
import pytest
import torch

from csmom_tpu.mesh import pinning as ref_pinning
from csmom_tpu.mesh import rules as ref_rules
from csmom_tpu.parallel import mesh as ref_mesh
from csmom_tpu_torch.mesh import pinning, rules
from csmom_tpu_torch.mesh.shard import gather, mesh_size, shard_args, sharded_call
from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.parallel import compat
from csmom_tpu_torch.parallel.compat import (
    P,
    all_gather,
    axis_index,
    axis_size,
    ppermute,
    psum,
    shard_map,
)
from csmom_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    distributed_init,
    make_hybrid_mesh,
    make_mesh,
    mesh_topology,
    pad_assets,
)

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _shard_threads():
    return [t for t in threading.enumerate() if t.name.startswith("shard_map-")]


@pytest.mark.parametrize("grid_axis,names", [
    (1, ("grid", "assets")), (2, ("grid", "assets")), (4, ("assets", "time")),
    (8, ("grid", "time"))])
def test_make_mesh_shapes_equal_the_references(grid_axis, names):
    import jax

    ref = ref_mesh.make_mesh(jax.devices()[:8], grid_axis=grid_axis,
                             axis_names=names)
    port = make_mesh(CPU8, grid_axis=grid_axis, axis_names=names)
    assert dict(port.shape) == dict(ref.shape)
    assert tuple(port.shape) == tuple(ref.shape) == names
    assert port.size == 8 and port.devices.shape == ref.devices.shape
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(CPU8[:6], grid_axis=4)


def test_meshes_hash_alike_and_devices_may_repeat():
    a = make_mesh(["cpu", "cpu"])
    b = Mesh([[torch.device("cpu"), torch.device("cpu")]], ("grid", "assets"))
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != make_mesh(["cpu", "cpu"], axis_names=("assets", "time"))
    assert auto_mesh(6, device="cpu").shape == {"grid": 1, "assets": 6}
    assert auto_mesh(4, prefer_grid=True, device="cpu").shape == {"grid": 2, "assets": 2}
    assert auto_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        for fn in (lambda: make_mesh(), lambda: auto_mesh(2),
                   lambda: rules.named_mesh("assets", 1)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_hybrid_mesh_and_topology_equal_the_references(n_hosts):
    import jax

    ref = ref_mesh.make_hybrid_mesh(jax.devices()[:8], n_hosts=n_hosts)
    port = make_hybrid_mesh(CPU8, n_hosts=n_hosts)
    assert dict(port.shape) == dict(ref.shape)
    assert mesh_topology(port) == ref_mesh.mesh_topology(ref)
    with pytest.raises(ValueError, match="not divisible"):
        make_hybrid_mesh(CPU8, n_hosts=3)


@pytest.mark.parametrize("A,n", [(37, 8), (40, 8), (5, 3), (1, 1)])
def test_pad_assets_equals_the_references(A, n):
    rng = np.random.default_rng(A)
    v = rng.normal(size=(A, 6))
    m = rng.random((A, 6)) > 0.3
    got, want = pad_assets(v, m, n), ref_mesh.pad_assets(v, m, n)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == A and got[0].shape[0] % n == 0


def test_distributed_init_is_false_alone_and_refuses_a_coordinator(monkeypatch):
    """The reference's contract: ``False`` for a plain run (a one-host
    image's variables included); given a coordinator or a cluster
    environment it joins (item 7c), and what it cannot join with
    raises: no card and no devices named, or a rank it cannot find.
    Joined, a second call is ``False``."""
    import socket

    from csmom_tpu_torch.parallel.mesh import distributed_shutdown, process_count

    for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR",
              "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
              "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS", "WORLD_SIZE",
              "JAX_NUM_PROCESSES", "RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK",
              "SLURM_PROCID", "JAX_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert distributed_init() is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            distributed_init("localhost:1234", num_processes=2, process_id=0)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed_init()
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    assert distributed_init() is False
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert distributed_init(devices=["cpu"]) is True
    try:
        assert process_count() == 1
        assert distributed_init(devices=["cpu"]) is False
    finally:
        distributed_shutdown()


@pytest.mark.parametrize("slot,per", [(0, 1), (3, 2), (1, 4)])
def test_pinning_arithmetic_equals_the_references(slot, per):
    assert pinning.slice_for_slot(slot, per) == ref_pinning.slice_for_slot(slot, per)
    s = pinning.slice_for_slot(slot, per)
    assert pinning.parse_device_slice(s) == ref_pinning.parse_device_slice(s)
    for n in range(0, 13):
        assert pinning.shards_for(n, per) == ref_pinning.shards_for(n, per)
    assert pinning.DEVICE_SLICE_ENV == ref_pinning.DEVICE_SLICE_ENV
    for bad in ("x", "1", "-1:2", "2:0"):
        with pytest.raises(ValueError):
            pinning.parse_device_slice(bad)


def _table(t):
    return [(rule, tuple(spec)) for rule, spec in t]


@pytest.mark.parametrize("name,args", [
    ("grid_rules", ()), ("panel_asset_rules", ()), ("serve_rules", ("batch",)),
    ("serve_rules", ("assets",))])
def test_rule_tables_equal_the_references(name, args):
    assert _table(getattr(rules, name)(*args)) == _table(getattr(ref_rules, name)(*args))


def test_rule_resolution_equals_the_references():
    tree = {"prices": np.zeros((8, 6)), "mask": np.zeros((8, 6), bool),
            "Js": np.zeros(4), "Ks": np.zeros(4), "n": np.zeros(()),
            "out": [np.zeros((4, 2, 6))]}
    tree["out"] = {"spreads": np.zeros((4, 2, 6))}
    got = rules.match_partition_rules(rules.grid_rules(), tree)
    want = ref_rules.match_partition_rules(ref_rules.grid_rules(), tree)
    assert {k: tuple(v) for k, v in got.items() if k != "out"} == \
        {k: tuple(v) for k, v in want.items() if k != "out"}
    assert tuple(got["out"]["spreads"]) == tuple(want["out"]["spreads"])
    with pytest.raises(ValueError, match="no partition rule"):
        rules.match_partition_rules(rules.grid_rules(), {"other": np.zeros(3)})
    for ep in ("momentum", "turnover", "backtest", "zscore_combo", "plugin"):
        assert rules.serve_axis_for(ep) == ref_rules.serve_axis_for(ep)
    with pytest.raises(ValueError, match="unknown serve placement"):
        rules.serve_rules("time")
    assert rules.grid_asset_mesh(2, 4, CPU8).shape == {"grid": 2, "assets": 4}
    assert rules.named_mesh("time", 3, CPU8).shape == {"time": 3}
    with pytest.raises(ValueError, match="visible"):
        rules.grid_asset_mesh(4, 4, CPU8)


def test_shard_helpers():
    mesh = make_mesh(CPU8[:4])
    x = torch.arange(8.0).reshape(4, 2)
    (placed,) = shard_args(mesh, (P("assets", None),), x)
    assert placed.device == mesh.device_list[0] and torch.equal(placed, x)
    with pytest.raises(ValueError, match="does not divide"):
        shard_args(mesh, (P("assets"),), torch.zeros(6))
    assert mesh_size(mesh) == 4
    np.testing.assert_array_equal(gather(x), x.numpy())

    def double(a):
        return a * 2

    one = make_mesh(["cpu"])
    assert sharded_call(double, one, (P("assets"),), P("assets"),
                        collective_free=True) is double
    out = sharded_call(double, mesh, (P("assets", None),), P("assets", None),
                       collective_free=True)(x)
    assert torch.equal(out, 2 * x)


def test_collectives_against_hand_results():
    mesh = make_mesh(CPU8, grid_axis=2)            # grid 2 x assets 4
    x = torch.arange(24, dtype=torch.float64).reshape(8, 3)
    js = torch.arange(4)

    def local(xl, jl):
        i, g = axis_index("assets"), axis_index("grid")
        return (psum(xl.sum(dim=0), "assets"),
                all_gather(xl, "assets", tiled=True),
                all_gather(xl[:1], "assets"),
                ppermute(xl, "assets", [(k, k + 1) for k in range(3)]),
                torch.tensor([[i, g, axis_size("assets"), axis_size(("grid", "assets")),
                               axis_index(("grid", "assets"))]]),
                psum(jl, "grid"),
                xl * 10)

    s, g_tiled, g_stacked, shifted, ids, jsum, x10 = shard_map(
        local, mesh=mesh, in_specs=(P("assets", None), P("grid")),
        out_specs=(P(), P(), P(), P("assets"), P(("grid", "assets")), P(),
                   P("assets")))(x, js)
    assert torch.equal(s, x.sum(dim=0))
    assert torch.equal(g_tiled, x)
    assert torch.equal(g_stacked, x[0::2][:, None, :])
    assert torch.equal(shifted, torch.cat([torch.zeros(2, 3, dtype=x.dtype), x[:6]]))
    assert ids.tolist() == [[i, g, 4, 8, 4 * g + i] for g in range(2) for i in range(4)]
    assert torch.equal(jsum, js[:2] + js[2:])
    assert torch.equal(x10, x * 10)
    with pytest.raises(ValueError, match="does not divide"):
        shard_map(lambda a: a, mesh=mesh, in_specs=(P("assets"),),
                  out_specs=P("assets"))(torch.zeros(6))
    with pytest.raises(RuntimeError, match="outside shard_map"):
        psum(torch.zeros(1), "assets")
    assert _shard_threads() == []


def test_each_shard_runs_under_its_own_device(monkeypatch):
    """A shard thread enters ``torch.cuda.device`` of its device before it
    runs (the CUDA runtime launches on the thread's current device): a
    recorder stands in for the context manager, and the shards take only
    non-array inputs, so nothing needs a card."""
    seen, current = {}, threading.local()

    class Recorder:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            current.dev = self.dev

        def __exit__(self, *exc):
            current.dev = None

    monkeypatch.setattr(torch.cuda, "device", Recorder)
    devs = [torch.device("cuda", i % 3) for i in range(6)]
    mesh = Mesh([devs[:3], devs[3:]], ("grid", "assets"))

    def local(tag):
        k = axis_index(("grid", "assets"))
        seen[k] = (current.dev, compat._shard().device,
                   threading.current_thread().name)
        psum(tag, "assets")  # the shards meet at a collective
        return tag

    assert shard_map(local, mesh=mesh, in_specs=(P(),), out_specs=P())(7) == 7
    assert {k: v[:2] for k, v in seen.items()} == {k: (d, d) for k, d in enumerate(devs)}
    assert len({v[2] for v in seen.values()}) == 6
    assert _shard_threads() == []


def test_a_raising_shard_raises_in_the_caller_and_leaves_no_thread():
    mesh = make_mesh(CPU8)

    class Boom(Exception):
        pass

    def local(xl):
        if axis_index("assets") == 5:
            raise Boom("shard 5")
        for _ in range(50):  # the others wait at collectives
            xl = xl + psum(xl, "assets")
        return xl

    t0 = time.perf_counter()
    with pytest.raises(Boom, match="shard 5"):
        shard_map(local, mesh=mesh, in_specs=(P("assets"),),
                  out_specs=P("assets"))(torch.zeros(8))
    assert time.perf_counter() - t0 < 5.0
    assert _shard_threads() == []

    def slow_then_raise(xl):
        if axis_index("assets") == 0:
            time.sleep(0.2)
            raise ValueError("late")
        return psum(xl, "assets")

    with pytest.raises(ValueError, match="late"):
        shard_map(slow_then_raise, mesh=mesh, in_specs=(P("assets"),),
                  out_specs=P())(torch.zeros(8))
    assert _shard_threads() == []


def test_a_broken_barrier_times_out_in_the_caller(monkeypatch):
    monkeypatch.setattr(compat, "BARRIER_TIMEOUT_S", 0.3)
    mesh = make_mesh(CPU8[:2])

    def local(xl):
        if axis_index("assets") == 1:
            time.sleep(1.0)   # misses the others' collective
        return psum(xl, "assets")

    with pytest.raises(TimeoutError, match="collective"):
        shard_map(local, mesh=mesh, in_specs=(P("assets"),), out_specs=P())(
            torch.zeros(2))
    assert _shard_threads() == []


def test_launch_counters_are_exact_under_threads():
    """Eight threads each add 1,000 launches to each wrapper's count."""
    kernels.reset_launches()
    wrappers = (kernels.decile_partial_sums, kernels.cohort_partial_sums)

    def bump():
        for _ in range(1000):
            for w in wrappers:
                kernels.count_launch(w)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [w.launches for w in wrappers] == [8000, 8000]
    kernels.reset_launches()
    assert [w.launches for w in wrappers] == [0, 0]


def test_the_first_cuda_linalg_call_is_made_before_the_shard_threads(monkeypatch):
    """torch loads its CUDA linear-algebra library at a process's first
    linalg call, and shard threads making that call together raise (met
    on the card by the time-sharded online ridge in a fresh process):
    ``shard_map`` makes one such call on the caller's thread, once a
    process, on a CUDA device of the mesh, before its threads start."""
    seen = []
    monkeypatch.setattr(compat, "_load_cuda_linalg", lambda devs: seen.append(list(devs)))
    fn = shard_map(lambda x: psum(x, "assets"), mesh=make_mesh(["cpu"] * 2),
                   in_specs=(P("assets"),), out_specs=P())
    assert torch.equal(fn(torch.ones(4)), torch.full((2,), 2.0))
    assert seen == [[torch.device("cpu")] * 2]
    monkeypatch.undo()

    calls = []
    monkeypatch.setattr(compat, "_CUDA_LINALG_LOADED", False)
    monkeypatch.setattr(compat.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(compat.torch, "ones",
                        lambda shape, device=None: ("ones", str(device)))
    monkeypatch.setattr(compat.torch.linalg, "inv", calls.append)
    compat._load_cuda_linalg([torch.device("cpu")] * 2)
    assert calls == []
    compat._load_cuda_linalg([torch.device("cpu"), torch.device("cuda", 1)])
    compat._load_cuda_linalg([torch.device("cuda", 0)])
    assert calls == [("ones", "cuda:1")]
