"""The port's serving tier on the CPU: the queue, batcher, cache and
service plumbing (the stub engine, and the torch engine on the CPU),
fault injection, the load generator's request stream against
csmom_tpu's, and the artifact under both packages' validators.

Every service test closes its books: ``served + rejected + expired ==
admitted``, globally and per class."""

import json
import random

import numpy as np
import pytest
import torch

from csmom_tpu.chaos import invariants as ref_inv
from csmom_tpu_torch.chaos import invariants as inv
from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve.buckets import bucket_spec
from csmom_tpu_torch.serve.queue import AdmissionQueue, Request
from csmom_tpu_torch.serve.service import ServeConfig, SignalService
from csmom_tpu_torch.utils.deadline import mono_now_s

torch.set_num_threads(2)

ENDPOINTS = serve_endpoints()
ENGINES = ("stub", "torch")


def _service(engine="stub", **over) -> SignalService:
    kw = dict(profile="serve-smoke", engine=engine, max_wait_s=0.005,
              device="cpu" if engine == "torch" else None)
    kw.update(over)
    return SignalService(ServeConfig(**kw)).start()


def _panel(n_assets: int, months: int, seed: int = 0):
    r = np.random.default_rng(seed)
    v = 100.0 * np.exp(np.cumsum(r.normal(0, 0.03, (n_assets, months)),
                                 axis=1)).astype(np.float32)
    return v, np.ones((n_assets, months), bool)


def _closed(svc: SignalService):
    assert svc.invariant_violations() == [], svc.accounting()


# ------------------------------------------------------------- plumbing ----

@pytest.mark.parametrize("engine", ENGINES)
def test_served_request_roundtrip_and_accounting(engine):
    svc = _service(engine)
    months = svc.spec.months
    reqs = [svc.submit(k, *_panel(5, months, i))
            for i, k in enumerate(ENDPOINTS)]
    for r in reqs:
        assert r.wait(5.0), r.state
        assert r.state == "served", (r.state, r.error)
    assert reqs[0].result.shape == (5,)  # unpadded: the request's assets
    assert set(reqs[2].result) == {"mean_spread", "ann_sharpe"}
    assert reqs[ENDPOINTS.index("low_volatility")].result.shape == (5,)
    assert reqs[ENDPOINTS.index("zscore_combo")].result.shape == (5,)
    assert not reqs[0].result.flags.writeable
    svc.stop()
    _closed(svc)
    a = svc.accounting()
    assert (a["admitted"], a["served"]) == (len(ENDPOINTS), len(ENDPOINTS))


def test_queue_full_rejects_with_retry_after_hint():
    q = AdmissionQueue(capacity=3)

    def mk():
        v, m = _panel(2, 24)
        return Request(kind="momentum", values=v, mask=m, n_assets=2)

    admitted = [q.submit(mk()) for _ in range(3)]
    assert all(r.state == "queued" for r in admitted)
    r = q.submit(mk())
    assert r.state == "rejected"
    assert r.retry_after_s is not None and r.retry_after_s > 0
    assert "retry after" in (r.error or "")
    a = q.accounting()
    assert a["admitted"] == 4 and a["rejected_queue_full"] == 1


def test_retry_after_cold_start_is_bounded():
    from csmom_tpu_torch.serve.queue import RETRY_AFTER_MAX_S, RETRY_AFTER_MIN_S

    def mk():
        v, m = _panel(2, 24)
        return Request(kind="momentum", values=v, mask=m, n_assets=2)

    q = AdmissionQueue(capacity=2)
    for _ in range(2):
        q.submit(mk())
    r = q.submit(mk())
    assert r.state == "rejected" and isinstance(r.retry_after_s, float)
    assert RETRY_AFTER_MIN_S <= r.retry_after_s <= RETRY_AFTER_MAX_S
    q3 = AdmissionQueue(capacity=64)
    q3._ema_per_req_s = 30.0
    for _ in range(64):
        q3.submit(mk())
    assert q3.submit(mk()).retry_after_s == RETRY_AFTER_MAX_S


@pytest.mark.parametrize("engine", ENGINES)
def test_expired_while_queued_is_never_dispatched(engine):
    svc = _service(engine)
    r = svc.submit("momentum", *_panel(3, svc.spec.months), deadline_s=-0.001)
    assert r.wait(5.0)
    assert r.state == "expired" and r.t_dispatch_s is None
    svc.stop()
    _closed(svc)
    a = svc.accounting()
    assert a["expired"] == 1 and a["expired_dispatched"] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_unserveable_requests_reject_at_the_door(engine):
    svc = _service(engine)
    months = svc.spec.months
    r1 = svc.submit("momentum", *_panel(svc.spec.max_assets + 1, months))
    r2 = svc.submit("nope", *_panel(2, months))
    r3 = svc.submit("momentum", *_panel(2, months + 1))
    r4 = svc.submit("momentum", _panel(5, months)[0], np.ones(5, bool))
    for r in (r1, r2, r3, r4):
        assert r.state == "rejected" and r.error
    assert "mask shape" in r4.error
    svc.stop()
    _closed(svc)
    assert svc.accounting()["rejected_unserveable"] == 4


@pytest.mark.parametrize("engine", ENGINES)
def test_worker_crash_rejects_the_batch_and_the_queue_drains(
        engine, tmp_path, monkeypatch):
    """A crash injected through the port's chaos plan at serve.dispatch:
    the batch ends rejected with the crash as its reason, and the next
    request is served."""
    from csmom_tpu_torch.chaos import inject
    from csmom_tpu_torch.chaos.plan import Fault, FaultPlan

    plan = FaultPlan("crash", seed=1, faults=(
        Fault(point="serve.dispatch", action="fail", after=0, max_fires=1),))
    p = tmp_path / "plan.toml"
    p.write_text(plan.to_toml())
    monkeypatch.setenv("CSMOM_FAULT_PLAN", str(p))
    monkeypatch.setenv("CSMOM_FAULT_STATE", str(tmp_path / "state"))
    inject.reset()
    try:
        svc = _service(engine)
        months = svc.spec.months
        first = svc.submit("backtest", *_panel(3, months), deadline_s=5.0)
        assert first.wait(5.0) and first.state == "rejected"
        assert "worker crashed mid-batch" in (first.error or "")
        second = svc.submit("backtest", *_panel(3, months, 1), deadline_s=5.0)
        assert second.wait(5.0) and second.state == "served", second.error
        svc.stop()
        _closed(svc)
        a = svc.accounting()
        assert a["rejected_worker_crash"] == 1 and a["served"] == 1
    finally:
        inject.reset()


def test_a_failing_engine_is_a_rejected_batch_not_a_dead_worker(monkeypatch):
    """Any engine exception (a kernel fault on the card) takes the crash
    path: counted, reasoned, and the worker goes on."""
    svc = _service("torch")
    months = svc.spec.months
    real = svc.engine.score

    def boom(kind, values, mask):
        if kind == "backtest":
            raise RuntimeError("decile_partial_sums: CUDA error 700")
        return real(kind, values, mask)

    monkeypatch.setattr(svc.engine, "score", boom)
    bad = svc.submit("backtest", *_panel(4, months), deadline_s=5.0)
    good = svc.submit("momentum", *_panel(4, months, 2), deadline_s=5.0)
    assert bad.wait(5.0) and good.wait(5.0)
    assert bad.state == "rejected" and "CUDA error 700" in bad.error
    assert good.state == "served"
    svc.stop()
    _closed(svc)
    assert svc.accounting()["rejected_worker_crash"] == 1


def test_idle_service_stops_promptly():
    svc = _service()
    t0 = mono_now_s()
    svc.stop(timeout_s=5.0)
    assert mono_now_s() - t0 < 2.0
    assert not svc._worker.is_alive()


def test_malformed_request_past_the_door_cannot_kill_the_worker():
    svc = _service()
    months = svc.spec.months
    v, _ = _panel(5, months)
    bad = Request(kind="momentum", values=v, mask=np.ones((5,), bool),
                  n_assets=5, deadline_s=None)
    svc.queue.submit(bad)
    assert bad.wait(5.0)
    assert bad.state == "rejected" and "could not pad" in (bad.error or "")
    after = svc.submit("momentum", *_panel(3, months), deadline_s=5.0)
    assert after.wait(5.0) and after.state == "served"
    svc.stop()
    _closed(svc)


def test_percentiles_are_nearest_rank():
    from csmom_tpu_torch.serve.loadgen import _percentiles

    assert _percentiles([0.001, 0.100])["p50"] == 1.0
    got = _percentiles([i / 1000.0 for i in range(1, 101)])
    assert got["p99"] == 99.0 and got["p50"] == 50.0 and got["p95"] == 95.0
    assert _percentiles([])["p99"] is None


def test_batcher_pads_to_nearest_bucket():
    from csmom_tpu_torch.serve.batcher import Batcher

    spec = bucket_spec("serve")
    months = spec.months

    def req(n):
        v, m = _panel(n, months)
        return Request(kind="momentum", values=v, mask=m, n_assets=n)

    mb = Batcher(spec).pad([req(3), req(40)])
    assert (mb.batch_bucket, mb.asset_bucket) == (4, 128)
    assert mb.values.shape == (4, 128, months) and mb.values.dtype == np.float32
    assert not mb.mask[0, 3:].any() and not mb.mask[2:].any()
    assert 0.0 < mb.pad_fraction < 1.0
    assert (mb.batch_bucket, mb.asset_bucket, months) in spec.shapes()


def test_bucket_spec_selection_rules():
    from csmom_tpu.serve.buckets import PROFILES as REF_PROFILES

    from csmom_tpu_torch.serve.buckets import PROFILES

    assert {k: vars(v) for k, v in PROFILES.items()} == {
        k: vars(v) for k, v in REF_PROFILES.items()}
    spec = bucket_spec("serve")
    assert spec.asset_bucket_for(1) == 32 and spec.asset_bucket_for(33) == 128
    assert spec.asset_bucket_for(129) is None
    assert spec.batch_bucket_for(5) == 8
    with pytest.raises(ValueError, match="unknown serve bucket profile"):
        bucket_spec("nope")


@pytest.mark.parametrize("engine", ENGINES)
def test_priorities_interactive_dispatches_first(engine):
    svc = _service(engine, max_wait_s=0.15)
    months = svc.spec.months
    bulk = svc.submit("momentum", *_panel(2, months), priority="batch",
                      deadline_s=5.0)
    inter = svc.submit("momentum", *_panel(2, months, 1),
                       priority="interactive", deadline_s=5.0)
    assert bulk.wait(5.0) and inter.wait(5.0)
    assert bulk.state == inter.state == "served"
    assert inter.t_dispatch_s <= bulk.t_dispatch_s
    svc.stop()
    _closed(svc)


def test_identical_requests_hit_the_cache_and_a_version_bump_evicts():
    svc = _service("torch")
    v, m = _panel(6, svc.spec.months, 4)
    first = svc.submit("zscore_combo", v, m, deadline_s=5.0, panel_version=1)
    assert first.wait(5.0) and first.state == "served"
    hit = svc.submit("zscore_combo", v, m, deadline_s=5.0, panel_version=1)
    assert hit.state == "served" and np.array_equal(hit.result, first.result,
                                                    equal_nan=True)
    assert svc.notify_panel_version(2) >= 1
    again = svc.submit("zscore_combo", v, m, deadline_s=5.0, panel_version=2)
    assert again.wait(5.0) and again.state == "served"
    svc.stop()
    _closed(svc)
    c = svc.cache_stats()
    assert c["hits"] == 1 and c["stale_hits"] == 0


# -------------------------------------------------------------- loadgen ----

def test_loadgen_is_deterministic_per_seed():
    from csmom_tpu_torch.serve.loadgen import arrival_offsets, parse_schedule

    segs = parse_schedule("1x50,0.5x200")
    a = arrival_offsets(segs, random.Random(7))
    assert a == arrival_offsets(segs, random.Random(7))
    assert a != arrival_offsets(segs, random.Random(8))
    assert all(t0 <= t1 for t0, t1 in zip(a, a[1:])) and a[-1] < 1.5
    with pytest.raises(ValueError, match="bad schedule segment"):
        parse_schedule("2q25")


class _Recorder:
    """A stand-in service that records what the load generator submits."""

    def __init__(self, spec):
        self.spec = spec
        self.stream = []

    def submit(self, kind, values, mask, priority, deadline_s, panel_version):
        self.stream.append((kind, values.tobytes(), mask.tobytes(),
                            values.shape, priority, deadline_s, panel_version))
        return self

    def notify_panel_version(self, version):
        self.stream.append(("bump", version))

    def wait(self, timeout=None):
        return True

    def stop(self, drain=True):
        pass


@pytest.mark.parametrize("sched,seed", [("2x40", 0), ("bursty", 0),
                                        ("adversarial", 3)])
def test_loadgen_request_stream_equals_the_reference(sched, seed, monkeypatch):
    """The same (schedule, seed) gives the reference's requests bit for
    bit: endpoints, classes, panels, masks, deadlines, versions."""
    import csmom_tpu.serve.buckets as ref_buckets
    import csmom_tpu.serve.loadgen as ref_lg
    import csmom_tpu_torch.serve.loadgen as lg

    monkeypatch.setattr("time.sleep", lambda s: None)
    streams = []
    for mod, buckets in ((lg, None), (ref_lg, ref_buckets)):
        spec = (buckets.bucket_spec("serve") if buckets is not None
                else bucket_spec("serve"))
        rec = _Recorder(spec)
        monkeypatch.setattr(mod, "build_artifact", lambda *a: None)
        schedule, kind, preset = mod.resolve_schedule(sched)
        mod.run_loadgen(rec, mod.LoadConfig(schedule=schedule, schedule_kind=kind,
                                            seed=seed, **preset))
        streams.append(rec.stream)
    assert len(streams[0]) > 50
    assert streams[0] == streams[1]


def test_loadgen_artifact_passes_both_validators(tmp_path):
    from csmom_tpu_torch.serve.loadgen import LoadConfig, run_loadgen, write_artifact

    svc = _service("torch")
    art = run_loadgen(svc, LoadConfig(schedule="0.3x80", seed=5,
                                      run_id="unit"))
    assert inv.detect_kind(art) == "serve"
    assert inv.validate(art) == [] and ref_inv.validate(art) == []
    req = art["requests"]
    assert req["admitted"] > 0
    assert req["served"] + req["rejected"] + req["expired"] == req["admitted"]
    assert art["compile"]["in_window_fresh_compiles"] == 0
    assert art["extra"]["platform"] == "cpu" and art["extra"]["engine"] == "torch"
    path = write_artifact(str(tmp_path), art)
    assert path.endswith("GPU_SERVE_unit.json")
    assert inv.validate_file(path) == [] and ref_inv.validate_file(path) == []


def test_serve_validator_rejects_broken_books_and_unknown_schema():
    base = {
        "kind": "serve", "schema_version": 1, "run_id": "x",
        "metric": "serve_throughput_rps", "value": 1.0, "unit": "req/s",
        "vs_baseline": 1.0, "wall_s": 1.0,
        "requests": {"admitted": 3, "served": 2, "rejected": 1,
                     "expired": 0, "expired_dispatched": 0},
        "latency_ms": {
            "queue": {"p50": 1.0, "p95": 2.0, "p99": 3.0},
            "service": {"p50": 1.0, "p95": 2.0, "p99": 3.0},
            "total": {"p50": 2.0, "p95": 4.0, "p99": 6.0},
        },
        "batches": {"count": 2, "size_hist": {"1": 2}, "mean_size": 1.0,
                    "pad_fraction": 0.0},
    }
    assert inv.validate(base) == []
    for path, value, needle in (
            (("requests", "served"), 3, "accounting broken"),
            (("requests", "expired_dispatched"), 1, "never"),
            (("schema_version",), 99, "unknown schema_version"),
            (("latency_ms", "total", "p95"), 99.0, "non-decreasing"),
            (("batches", "size_hist"), {"1": 1}, "size_hist")):
        bad = json.loads(json.dumps(base))
        node = bad
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
        assert any(needle in v for v in inv.validate(bad)), path
        assert any(needle in v for v in ref_inv.validate(bad)), path
    assert inv.validate({"rc": 0}) != []
