"""The port's serve engine against csmom_tpu's, on the CPU.

Every registered endpoint's ``TorchEngine(device="cpu").score`` against
``csmom_tpu.serve.engine.serve_entry_fn(kind, 12, 1, 10, "rank")`` (the
reference's jitted vmap) on the same seeded micro-batches, padded as the
batcher pads them (all-masked rows and assets), at both ``serve-smoke``
shapes and the full-width ``serve`` shape B = 8, A = 128 x 60: f64 within
``rtol=1e-10, atol=1e-13`` and f32 within ``rtol=1e-4, atol=1e-6``, NaN in
the same places.  Also: a batch row equals that row scored with other
requests around it, the backtest endpoint aggregates a whole batch in one
K1 call, the stubs equal the reference's bit for bit, the registry's
endpoints and surfaces equal the reference's, and a toy endpoint
registered at run time is served."""

import random

import numpy as np
import pytest
import torch

from csmom_tpu.registry import serve_endpoints as ref_endpoints
from csmom_tpu.registry import serve_surface as ref_surface
from csmom_tpu.serve.engine import StubEngine as RefStub
from csmom_tpu.serve.engine import serve_entry_fn
from csmom_tpu.serve.loadgen import synth_panel
from csmom_tpu_torch.registry import (
    EngineSpec,
    ServeSurface,
    register_engine,
    serve_endpoints,
    serve_surface,
    unregister_engine,
    workload_kinds,
)
from csmom_tpu_torch.serve.engine import StubEngine, TorchEngine, make_engine
from csmom_tpu_torch.serve.engine import serve_entry_fn as port_entry_fn
from csmom_tpu_torch.utils.donation import is_deleted

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-13)
F32 = dict(rtol=1e-4, atol=1e-6)
KINDS = ("momentum", "turnover", "backtest", "low_volatility", "zscore_combo")
# (B, A, M): both serve-smoke shapes and the full-width serve shape
SHAPES = ((1, 8, 24), (4, 8, 24), (8, 128, 60))


def _batch(kind, B, A, M, dtype, seed):
    """A micro-batch as the batcher pads it: ``max(1, B-1)`` requests of
    the loadgen's synthetic panels (the first with A-2 assets when A > 2,
    the others 2..A), every other row and asset all-masked."""
    r = random.Random(seed)
    values = np.zeros((B, A, M), dtype)
    mask = np.zeros((B, A, M), bool)
    for b in range(max(1, B - 1)):
        n = max(2, A - 2) if b == 0 else r.randint(2, A)
        v, m = synth_panel(r, n, M, kind)
        values[b, :n], mask[b, :n] = v, m
    return values, mask


def _hold(got, want, tol):
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **tol)


@pytest.fixture(scope="module")
def cpu_engine():
    return TorchEngine(device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}xA{}xM{}".format(*s))
@pytest.mark.parametrize("kind", KINDS)
def test_endpoint_equals_the_reference(cpu_engine, kind, shape, dtype):
    v, m = _batch(kind, *shape, dtype, seed=sum(shape) + len(kind))
    want = np.asarray(serve_entry_fn(kind, 12, 1, 10, "rank")(v, m))
    got = cpu_engine.score(kind, v, m)
    assert got.dtype == want.dtype
    _hold(got, want, F64 if dtype == np.float64 else F32)
    # the padded rows score as the reference scores them: NaN throughout
    assert np.isnan(got[max(1, shape[0] - 1):]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_a_row_does_not_see_its_batchmates(cpu_engine, kind):
    """Row 2 of a batch of 8 scores the same with other requests around
    it and alone, so no step reads across the batch axis."""
    v, m = _batch(kind, 8, 32, 60, np.float64, seed=11)
    v2, m2 = _batch(kind, 8, 32, 60, np.float64, seed=12)
    v2[2], m2[2] = v[2], m[2]
    a = cpu_engine.score(kind, v, m)[2]
    b = cpu_engine.score(kind, v2, m2)[2]
    alone = cpu_engine.score(kind, v[2:3], m[2:3])[0]
    for other in (b, alone):
        _hold(other, a, F64)


def test_backtest_aggregates_a_batch_in_one_kernel_call(cpu_engine, monkeypatch):
    """The backtest endpoint folds the batch into the month axis: one K1
    call on ``[A, B*M]`` a micro-batch, whatever B."""
    from csmom_tpu_torch.ops import kernels

    calls = []
    real = kernels.decile_partial_sums

    def counting(ret, labels, n_bins):
        calls.append(tuple(ret.shape))
        return real(ret, labels, n_bins)

    monkeypatch.setattr(kernels, "decile_partial_sums", counting)
    for B in (1, 4, 8):
        calls.clear()
        cpu_engine.score("backtest", *_batch("backtest", B, 32, 60, np.float32, B))
        assert calls == [(32, B * 60)]
    for kind in ("momentum", "turnover", "low_volatility", "zscore_combo"):
        calls.clear()
        cpu_engine.score(kind, *_batch(kind, 8, 32, 60, np.float32, 1))
        assert calls == []


@pytest.mark.parametrize("kind", KINDS)
def test_stub_equals_the_reference_stub(kind):
    v, m = _batch(kind, 4, 8, 24, np.float32, seed=5)
    got = StubEngine().score(kind, v, m)
    want = RefStub().score(kind, v, m)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_registry_matches_the_reference():
    assert serve_endpoints() == ref_endpoints() == KINDS
    assert workload_kinds() == KINDS
    for kind in KINDS:
        ours, ref = serve_surface(kind), ref_surface(kind)
        assert (ours.output, ours.summary_fields, ours.panel_family) == (
            ref.output, ref.summary_fields, ref.panel_family)


def test_registry_refuses_what_is_not_ported():
    from csmom_tpu_torch.registry import get_engine

    spec = get_engine("momentum", kind="serve")
    # the donated surface is ported: the plain scorer's output, with the
    # batch consumed
    rng = np.random.default_rng(5)
    v = torch.from_numpy(100 * np.exp(np.cumsum(rng.normal(0, 0.05, (2, 6, 30)), -1)))
    m = torch.ones(v.shape, dtype=torch.bool)
    plain = port_entry_fn("momentum", 12, 1, 10, "rank")(v, m)
    v1, m1 = v.clone(), m.clone()
    got = spec.donated(lookback=12, skip=1, n_bins=10, mode="rank")(v1, m1)
    assert torch.equal(torch.nan_to_num(got, 7.0), torch.nan_to_num(plain, 7.0))
    assert is_deleted(v1) and is_deleted(m1) and v1.numel() == 0
    # the sharded surface is ported: the endpoint's mesh scorer
    assert spec.sharded(devices=["cpu"] * 2).axis == "assets"
    # kinds lint (item 8d) and strategy are ported: each needs its class
    with pytest.raises(ValueError, match="rule_cls"):
        EngineSpec(name="x", kind="lint")
    with pytest.raises(ValueError, match="manifest_fn"):
        EngineSpec(name="x", kind="compile")
    with pytest.raises(ValueError, match="strategy_cls"):
        EngineSpec(name="x", kind="strategy")
    from csmom_tpu_torch.analysis.rules import ClockDiscipline
    from csmom_tpu_torch.strategy.builtin import Momentum

    assert EngineSpec(name="x", kind="lint", rule_cls=ClockDiscipline).rule_cls \
        is ClockDiscipline
    assert EngineSpec(name="x", kind="strategy",
                      strategy_cls=Momentum).strategy_cls is Momentum
    assert make_engine("jax-mesh", device="cpu").name == "torch-mesh"
    assert isinstance(make_engine("jax", device="cpu"), TorchEngine)
    assert isinstance(make_engine("torch", device="cpu"), TorchEngine)
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine("tpu")


def test_a_registered_toy_endpoint_is_served():
    from csmom_tpu_torch.serve.service import ServeConfig, SignalService

    def batch(params):
        return lambda values, mask: torch.where(mask, values, 0.0).sum(-1)

    def stub(params):
        return lambda values, mask: np.where(mask, values, 0.0).sum(-1)

    register_engine(name="toy_sum", kind="serve",
                    serve=ServeSurface(batch_fn=batch, stub_fn=stub))
    try:
        assert "toy_sum" in serve_endpoints() and "toy_sum" in workload_kinds()
        svc = SignalService(ServeConfig(profile="serve-smoke", engine="torch",
                                        device="cpu")).start()
        assert "toy_sum" in svc.warm_report["endpoints"]
        v = np.arange(5 * 24, dtype=np.float32).reshape(5, 24)
        r = svc.submit("toy_sum", v, np.ones((5, 24), bool), deadline_s=5.0)
        assert r.wait(5.0) and r.state == "served", r.error
        np.testing.assert_allclose(r.result, v.sum(-1))
        svc.stop()
        assert svc.invariant_violations() == []
    finally:
        unregister_engine("toy_sum")
    assert "toy_sum" not in serve_endpoints()


def test_engine_counts_no_build_on_the_cpu(cpu_engine):
    from csmom_tpu_torch.serve.buckets import bucket_spec

    eng = TorchEngine(device="cpu")
    assert isinstance(eng.fresh_compiles(), str)  # never warmed
    rep = eng.warm(bucket_spec("serve-smoke"))
    assert rep["n_shapes_warmed"] == len(KINDS) * 2 and rep["device"] == "cpu"
    eng.score("backtest", *_batch("backtest", 4, 8, 24, np.float32, 3))
    assert eng.fresh_compiles() == 0
