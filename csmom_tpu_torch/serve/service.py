"""The signal service: admission -> coalesce -> dispatch, supervised.

Counterpart of ``csmom_tpu.serve.service``, copied; its engine is the
card engine (``engine="torch"``, on ``ServeConfig.device``).  One worker
thread drives the pipeline: it blocks on the adaptive batcher for the
next padded micro-batch, scores it through the engine in one call, and
fans results back out to the batch's requests.

- **Warm before ready**: ``start()`` scores every (endpoint, bucket)
  shape once (``engine.warm``) before it opens the queue, so the first
  request never waits for a kernel build; anything built after that
  counts toward ``in_window_fresh_compiles``.
- **SLO classes at the door** (:mod:`csmom_tpu_torch.serve.slo`): every
  request resolves to a named class whose budget is its default
  deadline and whose quota and share the queue enforces first.
- **Cache first, coalesce second, queue third**
  (:mod:`csmom_tpu_torch.serve.cache`): an identical scored request is
  served at the door from the version-keyed cache; an identical request
  in flight attaches to its leader; only novel work enters the queue.
  A ``panel_version`` bump (:meth:`SignalService.notify_panel_version`)
  invalidates every older entry.
- **Deadlines cancel, never dispatch**: a request that expires while
  queued is terminal before a batch can include it, and the dispatch
  boundary checks again (``expired_dispatched`` stays 0).
- **A worker crash is a terminal outcome, not a leak**: any failure of a
  dispatch (a kernel error, or the chaos ``fail`` fault at
  ``serve.dispatch``) rejects the batch's requests with the crash as the
  reason and counts ``worker_crashes``; the loop goes on, so the queue
  drains.

Chaos checkpoints: ``serve.admit`` (queue.submit), ``serve.cache``
(each cache lookup), ``serve.coalesce`` (the batcher, after gathering)
and ``serve.dispatch`` (the worker, before the engine call).  Obs wiring,
zero-cost disarmed: a queue-depth gauge, batch-size / queue-wait /
service-wall histograms, served / rejected / expired / cache-hit
counters and ``serve.dispatch`` spans.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve.batcher import Batcher, Microbatch
from csmom_tpu_torch.serve.buckets import bucket_spec
from csmom_tpu_torch.serve.cache import (
    CacheKey,
    InflightCoalescer,
    ResultCache,
    panel_fingerprint,
)
from csmom_tpu_torch.serve.engine import make_engine, unpack_result
from csmom_tpu_torch.serve.queue import AdmissionQueue, Request
from csmom_tpu_torch.serve.slo import SLOPolicy, default_policy
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["ServeConfig", "SignalService"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service parameters (defaults = the production bucket grid).

    ``default_deadline_s`` governs requests that name no deadline of
    their own: the default sentinel ``"class"`` gives each request its
    SLO class's budget (interactive 0.5 s, standard 1 s, bulk 3 s); an
    explicit float gives that value to every class; ``None`` disables
    default deadlines entirely.

    ``engine`` is ``"torch"`` (the card engine), ``"torch-mesh"`` (its
    mesh form; the reference's names ``"jax"`` and ``"jax-mesh"`` mean
    the same) or ``"stub"``; ``device`` is the torch engines' device
    (None = cuda, raising without a card; ``"cpu"`` runs the kernels'
    plain versions); ``devices`` is the mesh engine's explicit device
    list (a device may repeat: logical shards of one device), None for
    the pinned slice or the visible cards.
    """

    profile: str = "serve"            # buckets.PROFILES key
    engine: str = "torch"             # "torch" | "torch-mesh" | "stub"
    device: str | None = None         # the torch engines' device
    devices: tuple | None = None      # the mesh engine's devices
    capacity: int = 64                # admission-queue bound
    max_wait_s: float = 0.010         # idle-arrival coalescing window
    # "class" = per-class budget; a float = that value; None = none
    default_deadline_s: float | str | None = "class"
    lookback: int = 12
    skip: int = 1
    n_bins: int = 10
    mode: str = "rank"                # serve uses the fast ordinal rank
    policy: SLOPolicy | None = None   # SLO classes (None = default_policy)
    cache_enabled: bool = True        # the version-keyed result cache
    cache_entries: int = 512
    cache_bytes: int = 32 << 20


class SignalService:
    """In-process micro-batching signal-scoring service."""

    def __init__(self, config: ServeConfig | None = None):
        self.config = config or ServeConfig()
        self.spec = bucket_spec(self.config.profile)
        self.policy = self.config.policy or default_policy()
        self.queue = AdmissionQueue(capacity=self.config.capacity,
                                    policy=self.policy)
        self.batcher = Batcher(self.spec, max_wait_s=self.config.max_wait_s)
        mesh = {"devices": self.config.devices} if self.config.devices else {}
        self.engine = make_engine(
            self.config.engine, device=self.config.device,
            lookback=self.config.lookback, skip=self.config.skip,
            n_bins=self.config.n_bins, mode=self.config.mode, **mesh)
        self.cache = (ResultCache(self.config.cache_entries,
                                  self.config.cache_bytes)
                      if self.config.cache_enabled else None)
        self._coalescer = InflightCoalescer()
        # the part of the cache key that is engine identity, not panel
        self._params_key = (self.config.engine, self.config.lookback,
                            self.config.skip, self.config.n_bins,
                            self.config.mode)
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        self.warm_report: dict | None = None
        self.n_batches = 0
        self.batch_size_hist: dict = {}
        self._pad_lanes = 0
        self._used_lanes = 0
        # engine calls and their summed wall, by endpoint: a worker's
        # stats reply holds its kernel launches against these
        self._engine_calls: dict = {}
        self._engine_s: dict = {}
        self._state_lock = threading.Lock()
        # live-panel version gate (streaming mode): None = batch panels,
        # no versioning.  See attach_live_version.
        self._live_version_fn = None
        self._max_version_skew = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "SignalService":
        if self._worker is not None:
            raise RuntimeError("service already started")
        self.warm_report = self.engine.warm(self.spec)
        self._worker = threading.Thread(
            target=self._worker_loop, name="csmom-serve-worker", daemon=True)
        self._worker.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the worker; with ``drain`` (default) first wait until the
        queue is empty so every admitted request reaches a terminal
        state — the accounting invariant is checked on a drained queue."""
        give_up = mono_now_s() + timeout_s
        if drain:
            while self.queue.depth() and mono_now_s() < give_up:
                self._stop.wait(0.01)
        self._stop.set()
        self.queue.wake()
        if self._worker is not None:
            self._worker.join(timeout=max(0.1, give_up - mono_now_s()))

    # --------------------------------------------------------------- submit

    def attach_live_version(self, version_fn, max_skew: int = 0) -> None:
        """Arm the live-panel version gate (streaming mode).

        ``version_fn`` returns the ingestor's CURRENT panel version; a
        request stamped with a ``panel_version`` more than ``max_skew``
        versions behind it is refused at the door: the service must
        never answer from a panel the ingest side has moved past, it
        must refuse loudly and be counted (``rejected_version_skew``).  The same reading drives cache
        invalidation: every submit raises the cache's version floor to
        ``live - max_skew``, so results computed from panels the gate
        would now refuse can never be served from the cache either.
        """
        self._live_version_fn = version_fn
        self._max_version_skew = int(max_skew)

    def notify_panel_version(self, version: int) -> int:
        """Ingestion-side panel_version bump: invalidate every cache
        entry computed from an older panel.  Returns how many entries
        were dropped.  (The loadgen's mid-run bump drives it.)"""
        if self.cache is None:
            return 0
        return self.cache.set_version_floor(int(version))

    def submit(self, kind: str, values, mask, priority: str = "interactive",
               deadline_s: float | None = None,
               panel_version: int | None = None,
               cacheable: bool = True, trace_ctx=None) -> Request:
        """Submit one scoring request (panel ``[A, months]``).

        ``deadline_s`` is RELATIVE seconds from now (None = the SLO
        class's budget, falling back to the config default).  Returns
        the request handle; an unserveable request (unknown endpoint or
        class, too many assets, wrong month count) is rejected at the
        door — terminal immediately, counted, never queued behind work
        it can only fail.  ``cacheable=False`` opts one request out of
        the result cache and coalescing (its dispatch is forced).
        ``trace_ctx`` carries a trace context minted elsewhere; without
        one, a context is minted here iff this process's trace book is
        armed (obs.trace, zero-cost disarmed).
        """
        from csmom_tpu_torch.obs import metrics
        from csmom_tpu_torch.obs import trace as obs_trace

        values = np.asarray(values)
        mask = np.asarray(mask, dtype=bool)
        n_assets = int(values.shape[0]) if values.ndim == 2 else 0
        try:
            cls = self.policy.resolve(priority)
        except ValueError as e:
            req = Request(kind=kind, values=values, mask=mask,
                          n_assets=n_assets,
                          priority=self.policy.names()[0],
                          trace=trace_ctx if trace_ctx is not None
                          else obs_trace.begin(kind, str(priority)))
            self.queue.reject_at_door(req, str(e))
            return req
        if deadline_s is not None:
            rel = deadline_s
        elif self.config.default_deadline_s == "class":
            rel = cls.deadline_s
        else:
            rel = self.config.default_deadline_s
        req = Request(
            kind=kind, values=values, mask=mask, n_assets=n_assets,
            priority=cls.name,
            deadline_s=None if rel is None else mono_now_s() + rel,
            panel_version=panel_version,
            # minted BEFORE the door checks so a rejection is a reasoned
            # partial trace, never a request that vanished untraced
            trace=trace_ctx if trace_ctx is not None else obs_trace.begin(
                kind, cls.name, panel_version=panel_version,
                budget_ms=round(1e3 * cls.deadline_s, 3)),
        )
        if self._live_version_fn is not None and panel_version is not None:
            live = int(self._live_version_fn())
            if self.cache is not None:
                # the gate's threshold IS the cache floor: anything the
                # door would now refuse must not be servable from cache
                self.cache.set_version_floor(live - self._max_version_skew)
            if live - panel_version > self._max_version_skew:
                self.queue.reject_at_door(
                    req,
                    f"panel-version skew: request snapshotted at v"
                    f"{panel_version} but ingest is at v{live} "
                    f"(allowed skew {self._max_version_skew}); refresh "
                    "the snapshot and resubmit",
                    version_skew=True,
                )
                return req
        reason = self._unserveable_reason(kind, values, mask)
        if reason is not None:
            self.queue.reject_at_door(req, reason)
            return req
        key = None
        if self.cache is not None and cacheable:
            key = CacheKey(kind=kind, params=self._params_key,
                           months=self.spec.months, n_assets=n_assets,
                           fingerprint=panel_fingerprint(values, mask),
                           panel_version=panel_version)
            # cache -> coalesce, re-checking the cache when a leader
            # went terminal mid-attach (its completion filled the cache,
            # so the retry is usually a hit, not a duplicate dispatch).
            # Bounded: a pathological race storm degrades to leading an
            # uncoalesced dispatch — correct, just uncached.
            role = "leader"
            for _ in range(3):
                hit, result = self.cache.get(key)
                if hit:
                    return self.queue.serve_at_door(
                        req, self._share_result(result))
                role = self._coalescer.lead_or_follow(
                    key, req, self.queue.attach_follower)
                if role != "retry":
                    break
            if role == "follower":
                metrics.counter("serve.coalesced").inc()
                return req
            if role == "leader":
                req.cache_key = key
            else:
                key = None  # retry storm: dispatch uncoalesced, uncached
        out = self.queue.submit(req)
        if key is not None and req.state == "rejected":
            # a door-rejected leader (quota/backpressure) must free the
            # in-flight slot; any follower that attached in the gap was
            # resolved inside the rejection's terminal transition
            self._coalescer.unregister(key, req)
        return out

    @staticmethod
    def _share_result(result):
        """A cached result handed to a caller: numpy payloads go out as
        read-only views and dict payloads as copies, so no caller can
        mutate the shared cache entry."""
        if isinstance(result, np.ndarray):
            view = result.view()
            view.setflags(write=False)
            return view
        if isinstance(result, dict):
            return dict(result)
        return result

    def _unserveable_reason(self, kind: str, values, mask) -> str | None:
        kinds = serve_endpoints()
        if kind not in kinds:
            return f"unknown endpoint {kind!r} (serveable: {kinds})"
        if values.ndim != 2:
            return f"panel must be [assets, months], got ndim={values.ndim}"
        if values.shape[1] != self.spec.months:
            return (f"panel has {values.shape[1]} months; this service "
                    f"scores {self.spec.months}-month histories "
                    f"(bucket profile {self.spec.name!r})")
        if self.spec.asset_bucket_for(values.shape[0]) is None:
            return (f"{values.shape[0]} assets exceeds the largest bucket "
                    f"({self.spec.max_assets}); split the universe or use "
                    "a larger bucket profile")
        if mask.shape != values.shape:
            # a malformed mask must fail AT THE DOOR: past it, the padder
            # would raise inside the worker thread instead
            return (f"mask shape {mask.shape} does not match the values "
                    f"panel {values.shape}")
        return None

    # --------------------------------------------------------------- worker

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            mb = self.batcher.next_batch(self.queue, self._stop)
            if mb is None:
                continue
            self._dispatch(mb)

    def _release_key(self, req: Request) -> None:
        key = getattr(req, "cache_key", None)
        if key is not None:
            self._coalescer.unregister(key, req)

    def _dispatch(self, mb: Microbatch) -> None:
        from csmom_tpu_torch.chaos.inject import checkpoint
        from csmom_tpu_torch.obs import metrics, span

        # last-instant deadline check AT the dispatch boundary: the queue's
        # collect pass sweeps expiry too, but a deadline can land in the
        # gap between collection and here — the "expired is never
        # dispatched" contract is enforced where dispatch actually begins
        now = mono_now_s()
        live = []                    # (batch row, request) actually dispatched
        for b, r in enumerate(mb.requests):
            if r.expired_at(now):
                self.queue.finish_expired(
                    r, error="deadline expired between collection and "
                             "dispatch (never dispatched)")
                self._release_key(r)
                metrics.counter("serve.expired").inc()
            else:
                self.queue.mark_dispatched(r, now)
                live.append((b, r))
        if not live:
            return  # the whole gathered batch expired: nothing to dispatch
        fired = checkpoint("serve.dispatch", kind=mb.kind,
                           n=len(live), bucket=f"{mb.batch_bucket}x"
                           f"{mb.asset_bucket}x{self.spec.months}")
        metrics.gauge("serve.in_flight").set(len(live))
        t_engine = mono_now_s()
        try:
            if fired == "fail":
                raise RuntimeError(
                    "injected worker crash (chaos 'fail' at serve.dispatch)")
            with span("serve.dispatch", phase="row", kind=mb.kind,
                      b=mb.batch_bucket, a=mb.asset_bucket) as sp:
                try:
                    out = self.engine.score(mb.kind, mb.values, mb.mask)
                finally:
                    with self._state_lock:
                        self._engine_calls[mb.kind] = (
                            self._engine_calls.get(mb.kind, 0) + 1)
                        self._engine_s[mb.kind] = (
                            self._engine_s.get(mb.kind, 0.0)
                            + mono_now_s() - t_engine)
                sp.set(n=len(live))
            # stamp the engine-wall boundary for every request BEFORE the
            # fan-out loop, so one request's unpack/cache time is never
            # attributed to a batchmate's dispatch stage.  The mesh
            # engine's shard lookup and mark/set run for live contexts
            # only (the disarmed no-op singleton has `live` False), and
            # the lookup once a micro-batch
            shards = unresolved = object()
            for _, r in live:
                t = r.trace
                if t is None or not t.live:
                    continue
                if shards is unresolved:
                    shards = (self.engine.dispatch_shards(
                        mb.kind, mb.batch_bucket, mb.asset_bucket)
                        if hasattr(self.engine, "dispatch_shards") else None)
                t.mark("dispatch")
                if shards is not None:
                    t.set(mesh_devices=shards[0], mesh_shards=shards[1])
            for b, r in live:
                # per-asset vs summary unpacking is the registered
                # engine's declaration, not a name special-case here
                res = unpack_result(mb.kind, out, b, r.n_assets)
                key = getattr(r, "cache_key", None)
                if key is not None and self.cache is not None:
                    # fill the cache BEFORE resolving the leader, so a
                    # submit racing the terminal transition finds the
                    # result instead of re-leading a dispatch
                    self.cache.put(key, res)
                self.queue.finish_served(r, res)
                self._release_key(r)
                metrics.counter("serve.served").inc()
                if r.queue_wait_s is not None:
                    metrics.histogram("serve.queue_wait_s").observe(
                        r.queue_wait_s)
                if r.service_s is not None:
                    metrics.histogram("serve.service_s").observe(r.service_s)
        except Exception as e:  # worker crash: terminate, keep draining
            metrics.counter("serve.worker_crashes").inc()
            reason = (f"worker crashed mid-batch "
                      f"({type(e).__name__}: {e})"[:200])
            for _, r in live:
                self.queue.finish_rejected(r, reason, worker_crash=True)
                self._release_key(r)
        finally:
            from csmom_tpu_torch.obs import trace as obs_trace

            self.batcher.note_service_wall(mono_now_s() - t_engine)
            used = sum(r.n_assets for _, r in live)
            pad = mb.batch_bucket * mb.asset_bucket - used
            with self._state_lock:
                self.n_batches += 1
                k = str(len(live))
                self.batch_size_hist[k] = self.batch_size_hist.get(k, 0) + 1
                self._used_lanes += used
                self._pad_lanes += pad
            obs_trace.note_batch(mb.kind, mb.batch_bucket, mb.asset_bucket,
                                 used, pad, mb.fire_reason)
            metrics.histogram("serve.batch_size").observe(len(live))
            metrics.gauge("serve.in_flight").set(0)

    # ------------------------------------------------------------ reporting

    def batch_stats(self) -> dict:
        with self._state_lock:
            total = self._used_lanes + self._pad_lanes
            sizes = sum(int(k) * v for k, v in self.batch_size_hist.items())
            stats = {
                "count": self.n_batches,
                "size_hist": dict(sorted(self.batch_size_hist.items(),
                                         key=lambda kv: int(kv[0]))),
                "mean_size": (round(sizes / self.n_batches, 3)
                              if self.n_batches else None),
                "pad_fraction": (round(self._pad_lanes / total, 4)
                                 if total else None),
                "engine_calls": dict(self._engine_calls),
                "engine_ms": {k: round(1e3 * v, 3)
                              for k, v in self._engine_s.items()},
            }
        stats["fire_reasons"] = self.batcher.fire_reason_counts()
        return stats

    def cache_stats(self) -> dict:
        if self.cache is None:
            return {"enabled": False}
        out = self.cache.stats()
        out["enabled"] = True
        out["inflight_leaders"] = self._coalescer.inflight()
        return out

    def class_stats(self) -> dict:
        """Per-class books + the policy's budgets (the SERVE artifact's
        ``classes`` block is built from this)."""
        books = self.queue.class_accounting()
        policy = self.policy.summary()
        return {name: {**books[name], **policy[name]} for name in books}

    def accounting(self) -> dict:
        return self.queue.accounting()

    def invariant_violations(self) -> list:
        return self.queue.invariant_violations()

    def fresh_compiles(self):
        return self.engine.fresh_compiles()
