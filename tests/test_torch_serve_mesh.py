"""The port's mesh serving engine on the CPU, in one process.

Mirrors the serve half of ``tests/test_mesh.py`` against the port: the
sharded micro-batch scorers of :mod:`csmom_tpu_torch.mesh.variants` on
1, 2, 4 and 8 logical CPU shards equal the single-device scorer bit for
bit (``assert_array_equal``), for all five endpoints in f32 and f64, at
a shape that really shards on both placements, and for a toy endpoint
registered at run time; the same inputs through the reference's
``sharded_serve_entry_fn`` on the 8 host devices ``conftest.py`` forces
agree within f64 ``rtol=1e-10, atol=1e-13`` and f32 ``rtol=1e-4,
atol=1e-6``, NaN in the same places.  Also: the placement rule and the
summary-axis refusal, pinning, the ``serve-mesh`` profile's names against
the reference's health check at d1, d2 and d8, the topology-keyed cache
version, and a ``SignalService`` on ``engine="torch-mesh"`` over 8
logical CPU shards serving every endpoint with nothing built in the
window, results bit-equal to the single-device engine and traces
carrying the mesh attributes.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from csmom_tpu.mesh.variants import sharded_serve_entry_fn as ref_sharded
from csmom_tpu.serve import health as ref_health
from csmom_tpu_torch.mesh import DEVICE_SLICE_ENV
from csmom_tpu_torch.mesh.rules import serve_axis_for
from csmom_tpu_torch.mesh.variants import (
    ShardedServeEntry,
    sharded_serve_entry_fn,
    sharded_serve_jit_for,
)
from csmom_tpu_torch.registry import (
    ServeSurface,
    get_engine,
    register_engine,
    serve_endpoints,
    unregister_engine,
)
from csmom_tpu_torch.serve import health
from csmom_tpu_torch.serve.engine import (
    MeshTorchEngine,
    TorchEngine,
    make_engine,
    serve_entry_fn,
)

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-13)
F32 = dict(rtol=1e-4, atol=1e-6)
KINDS = ("momentum", "turnover", "backtest", "low_volatility", "zscore_combo")
PARAMS = (12, 1, 10, "rank")


def _batch(seed, B=8, A=16, M=24, dtype=np.float32):
    """Seeded month-end prices with 5% holes and one all-masked row and
    asset, as the batcher pads them."""
    rng = np.random.default_rng(seed)
    v = 100.0 * np.exp(np.cumsum(rng.normal(0, 0.03, (B, A, M)), axis=2))
    m = rng.random((B, A, M)) > 0.05
    m[-1] = False
    m[:, -1] = False
    return np.where(m, v, np.nan).astype(dtype), m


def _single(kind, v, m):
    return serve_entry_fn(kind, *PARAMS)(torch.as_tensor(v),
                                         torch.as_tensor(m)).numpy()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_entry_is_bit_equal_to_the_single_device_scorer(kind, dtype, n):
    v, m = _batch(len(kind) + n, dtype=dtype)
    entry = sharded_serve_entry_fn(kind, *PARAMS, devices=["cpu"] * n)
    assert entry.n_devices == n and entry.axis == serve_axis_for(kind)
    # B = 8 and A = 16 divide over every n: the shape really shards
    assert entry.shards_for_shape(*v.shape[:2]) == n
    got = entry(v, m)
    assert got.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(got.numpy(), _single(kind, v, m))


def test_a_shape_that_does_not_divide_takes_the_largest_divisor():
    """B = 4 on 8 shards splits 4 ways; the bucket axis is never padded."""
    v, m = _batch(3, B=4, A=12)
    for kind, want in (("backtest", 4), ("momentum", 6)):
        entry = sharded_serve_entry_fn(kind, *PARAMS, devices=["cpu"] * 8)
        assert entry.shards_for_shape(4, 12) == want
        np.testing.assert_array_equal(entry(v, m).numpy(), _single(kind, v, m))


def test_one_shard_is_the_single_device_scorer():
    entry, n = sharded_serve_jit_for("backtest", 8, 32, *PARAMS, devices=["cpu"])
    assert n == 1 and isinstance(entry, ShardedServeEntry)
    assert entry.call_for(8, 32) is serve_entry_fn("backtest", *PARAMS)
    entry8 = sharded_serve_entry_fn("backtest", *PARAMS, devices=["cpu"] * 8)
    assert entry8.call_for(1, 32) is serve_entry_fn("backtest", *PARAMS)
    assert entry8.call_for(8, 32) is not serve_entry_fn("backtest", *PARAMS)


def test_the_shards_run_on_the_callers_thread(monkeypatch):
    """A serve entry's shards never meet, so they run in order on the
    calling thread: no ``shard_map-*`` thread starts, and a collective
    called inside raises."""
    from csmom_tpu_torch.mesh.rules import P, named_mesh
    from csmom_tpu_torch.parallel import compat

    started = []
    real_start = threading.Thread.start
    monkeypatch.setattr(threading.Thread, "start",
                        lambda self: (started.append(self.name), real_start(self))[1])
    v, m = _batch(1)
    sharded_serve_entry_fn("momentum", *PARAMS, devices=["cpu"] * 8)(v, m)
    sharded_serve_entry_fn("backtest", *PARAMS, devices=["cpu"] * 8)(v, m)
    assert not [t for t in started if t.startswith("shard_map")]
    fn = compat.shard_map(lambda x: compat.psum(x, "batch"),
                          mesh=named_mesh("batch", 2, ["cpu"] * 2),
                          in_specs=(P("batch"),), out_specs=P("batch"),
                          collective_free=True)
    with pytest.raises(RuntimeError, match="collective-free"):
        fn(torch.ones(4))


def test_a_runtime_registered_endpoint_gets_its_sharded_surface():
    """The catch-all serve rule: a toy engine registered at run time is
    batch-sharded with no edit anywhere, bit-equal to its scorer."""
    def batch(params):
        return lambda v, m: torch.where(m[..., -1], v[..., -1], torch.nan)

    def stub(params):
        return lambda v, m: np.where(m[:, :, -1], v[:, :, -1], np.nan)

    name = "toy_mesh_last_price"
    spec = register_engine(name=name, kind="serve",
                           serve=ServeSurface(batch_fn=batch, stub_fn=stub))
    try:
        entry = spec.sharded(devices=["cpu"] * 8)
        assert entry.axis == "batch" and entry.kind == name
        v, m = _batch(9, B=8, A=4)
        np.testing.assert_array_equal(entry(v, m).numpy(), _single(name, v, m))
    finally:
        unregister_engine(name, kind="serve")


@pytest.mark.parametrize("kind", KINDS)
def test_every_serve_endpoint_resolves_its_sharded_entry(kind):
    entry = get_engine(kind, kind="serve").sharded(devices=["cpu"] * 4)
    assert isinstance(entry, ShardedServeEntry) and entry.kind == kind
    bucket_feeder = get_engine("serve.buckets", kind="compile").sharded(
        kind, devices=["cpu"] * 4)
    assert bucket_feeder.axis == entry.axis == serve_axis_for(kind)
    mesh_feeder = get_engine("mesh.serve", kind="compile").sharded(
        kind, devices=["cpu"] * 4)
    assert mesh_feeder.n_devices == 4


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_entry_agrees_with_the_reference_on_eight_devices(kind, dtype):
    if len(jax.devices()) < 8:
        pytest.skip("the 8 host devices conftest.py forces are absent")
    v, m = _batch(40 + len(kind), dtype=dtype)
    want = np.asarray(ref_sharded(kind)(v, m))
    got = sharded_serve_entry_fn(kind, *PARAMS, devices=["cpu"] * 8)(v, m).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok],
                               **(F64 if dtype == np.float64 else F32))


def test_the_placement_rule_and_the_summary_axis_refusal():
    for kind in (*KINDS, "some_runtime_plugin"):
        from csmom_tpu.mesh.rules import serve_axis_for as ref_axis

        assert serve_axis_for(kind) == ref_axis(kind)
    assert serve_axis_for("momentum") == serve_axis_for("turnover") == "assets"
    assert serve_axis_for("backtest") == serve_axis_for("zscore_combo") == "batch"
    with pytest.raises(ValueError, match="reduction order"):
        sharded_serve_entry_fn("backtest", axis="assets", devices=["cpu"])
    with pytest.raises(ValueError, match="unknown endpoint"):
        sharded_serve_entry_fn("nope", devices=["cpu"])


def test_a_pinned_slice_counts_logical_shards_of_a_single_device(monkeypatch):
    monkeypatch.setenv(DEVICE_SLICE_ENV, "2:2")
    entry = sharded_serve_entry_fn("momentum", device="cpu")
    assert entry.devices == (torch.device("cpu"),) * 2
    engine = MeshTorchEngine(device="cpu")
    assert engine.devices == (torch.device("cpu"),) * 2
    monkeypatch.setenv(DEVICE_SLICE_ENV, "2")
    with pytest.raises(ValueError, match="bad device slice"):
        sharded_serve_entry_fn("momentum", device="cpu")
    monkeypatch.delenv(DEVICE_SLICE_ENV)
    assert sharded_serve_entry_fn("momentum", device="cpu").n_devices == 1
    if not torch.cuda.is_available():
        # no card: the visible cards are none, and the engine says so
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MeshTorchEngine()


@pytest.mark.parametrize("profile", ["serve", "serve-smoke"])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_mesh_profile_names_equal_the_references(profile, d, monkeypatch):
    from csmom_tpu_torch.registry.builtin import mesh_serve_profile_entries

    want = ref_health.expected_entry_names(profile, mesh_devices=d)
    assert health.expected_entry_names(profile, mesh_devices=d) == want
    # the manifest on d logical CPU shards, as a worker pinned to d sees it
    monkeypatch.setenv(DEVICE_SLICE_ENV, f"0:{d}")
    mesh_profile = "serve-mesh-smoke" if profile.endswith("smoke") else "serve-mesh"
    entries = mesh_serve_profile_entries(mesh_profile)
    assert {e.name for e in entries} == want
    assert len(entries) == len(want)
    for e in entries:
        e.validate()
        assert e.kernels == (("decile_partial_sums", "rank_labels")
                             if ".backtest." in e.name else ())
    assert health.expected_entry_names(profile) == ref_health.expected_entry_names(
        profile)


def test_the_cache_version_is_keyed_by_the_mesh_size():
    base = health.aot_cache_version("serve")
    assert health.aot_cache_version("serve") == base
    tokens = {d: health.aot_cache_version("serve", engine="torch-mesh",
                                          mesh_devices=d) for d in (1, 2, 8)}
    assert len({base, *tokens.values()}) == 4
    assert tokens[2] == health.aot_cache_version("serve", engine="jax-mesh",
                                                 mesh_devices=2)
    assert health.aot_cache_version("serve", engine="jax") == base


def test_make_engine_resolves_both_mesh_names():
    for name in ("torch-mesh", "jax-mesh"):
        eng = make_engine(name, device="cpu")
        assert isinstance(eng, MeshTorchEngine) and eng.name == "torch-mesh"
        assert eng.devices == (torch.device("cpu"),)
    eng = make_engine("torch-mesh", devices=["cpu"] * 4)
    assert eng.devices == (torch.device("cpu"),) * 4 and eng.device.type == "cpu"


def test_the_mesh_engine_serves_every_endpoint_from_its_warmed_shapes():
    """The serving tier's mesh claim end to end, on 8 logical CPU shards:
    warm, dispatch every endpoint through its sharded scorer, nothing
    built in the window, each result bit-equal to the single-device
    engine's, each trace's dispatch stage carrying the mesh size and the
    shard count."""
    from csmom_tpu_torch.obs import trace as obs_trace
    from csmom_tpu_torch.serve.engine import unpack_result
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    svc = SignalService(ServeConfig(profile="serve-smoke", engine="torch-mesh",
                                    device="cpu", devices=("cpu",) * 8,
                                    max_wait_s=0.005)).start()
    months = svc.spec.months
    mesh = svc.warm_report["mesh"]
    assert mesh["devices"] == 8 and svc.warm_report["n_shapes_warmed"] == 10
    assert mesh["endpoints"]["backtest"] == {"axis": "batch",
                                             "shards": {"b1@8": 1, "b4@8": 4}}
    assert mesh == svc.engine.mesh_info(svc.spec)
    book = obs_trace.arm_tracing(seed=0)
    try:
        rng = np.random.default_rng(7)
        panels, reqs = {}, {}
        for kind in serve_endpoints():
            v = (100.0 * np.exp(np.cumsum(rng.normal(0, 0.03, (5, months)),
                                          axis=1))).astype(np.float32)
            m = np.ones((5, months), bool)
            panels[kind] = (v, m)
            reqs[kind] = svc.submit(kind, v, m)
        for kind, r in reqs.items():
            assert r.wait(30.0) and r.state == "served", (kind, r.state, r.error)
    finally:
        svc.stop()
        obs_trace.disarm_tracing()
    assert svc.invariant_violations() == []
    assert svc.fresh_compiles() == 0
    single = TorchEngine(device="cpu")
    for kind, (v, m) in panels.items():
        out = single.score(kind, v[None], m[None])
        want = unpack_result(kind, out, 0, 5)
        got = reqs[kind].result
        if isinstance(want, dict):
            assert set(got) == set(want)
            for f in want:
                np.testing.assert_array_equal(got[f], want[f])
        else:
            np.testing.assert_array_equal(np.asarray(got), want)
    slowest = book.snapshot()["slowest"]
    assert sorted(e["endpoint"] for e in slowest) == sorted(KINDS)
    for e in slowest:
        # one request a micro-batch: bucket B = 1, A = 8
        want = svc.engine.dispatch_shards(e["endpoint"], 1, 8)
        assert (e["attrs"]["mesh_devices"], e["attrs"]["mesh_shards"]) == want
        assert want == (8, 8 if serve_axis_for(e["endpoint"]) == "assets" else 1)


def test_the_scaling_probe_times_both_scorers_at_the_largest_bucket():
    eng = MeshTorchEngine(devices=["cpu"] * 4)
    from csmom_tpu_torch.serve.buckets import bucket_spec

    spec = bucket_spec("serve-smoke")
    eng.warm(spec)
    row = eng.scaling_probe(spec, reps=2)
    assert row["probe_endpoint"] == "momentum" and row["probe_shape"] == [4, 8, 24]
    assert row["devices"] == 4 and row["shards"] == 4
    assert row["single_device_dispatch_ms"] > 0 and row["sharded_dispatch_ms"] > 0
    assert eng.fresh_compiles() == 0
    assert eng.dispatch_shards("backtest", 4, 8) == (4, 4)
    assert eng.dispatch_shards("backtest", 1, 8) == (4, 1)
