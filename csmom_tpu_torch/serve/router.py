"""Pool router: admission, hedged dispatch, closed cross-process books.

Counterpart of ``csmom_tpu.serve.router``.  The router is the pool's
front door: it admits every request, fans out to whichever workers are
READY (the supervisor's routable set), and holds the serve layer's core
invariant across the process boundary: every admitted request reaches
exactly one terminal state (``served``, ``rejected`` or ``expired``),
whichever worker died, answered late or answered twice.

- **Consistent-hash cache routing** (:class:`HashRing`): a request's
  result-cache identity (endpoint, panel fingerprint, panel version)
  picks its worker, so identical requests land on the same worker's
  cache.  The ring is rebuilt from the ready workers: a dead worker's
  arcs redistribute and its same-id replacement reclaims them.  Hedges
  and failovers exclude the tried worker.
- **Weighted fair dispatch** (:class:`WeightedFairGate`): a bounded
  number of dispatches run at once; when the gate is contended the next
  slot goes to the waiting SLO class of lowest rank, weighted-fair
  within a rank by queue share.
- **Hedged retries** (Dean and Barroso, *The Tail at Scale*, 2013): when
  ``hedge_fraction`` of a request's remaining budget passes with no
  answer, a second attempt goes to a different worker.  The first
  answer wins; the loser counts ``duplicates_suppressed`` (or
  ``late_served_suppressed`` when the request was not hedged).  The
  terminal transition is guarded by one lock.
- **Failover**: a refused or reset connection fails the attempt at once
  and redispatches, up to ``max_attempts``; only when every avenue is
  exhausted is the request ``rejected`` with ``rejected_infra``, the
  counter availability is computed from (``1 - rejected_infra /
  admitted``).

The router holds no panels and no queue: the workers' admission queues
buffer.  It also runs as its own supervised process:
``python -m csmom_tpu_torch.serve.router --listen ADDR --routes FILE``
runs a :class:`RouterServer` replica behind the same wire protocol as
the workers, its worker set read from the routes file the fabric
publishes (:mod:`csmom_tpu_torch.serve.fabric`).  Two or more replicas
sit behind a :class:`~csmom_tpu_torch.serve.fabric.FabricClient`.  A
replica imports neither torch nor pandas.  The router notes each
request's ``offered``, ``admitted`` and ``served`` demand for the fleet
observatory (:mod:`csmom_tpu_torch.obs.fleet`; a no-op disarmed), and a
replica with ``CSMOM_FLEET`` set streams its metrics there.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
import threading

import numpy as np

from csmom_tpu_torch.serve import proto
from csmom_tpu_torch.registry import serve_endpoints
from csmom_tpu_torch.serve.buckets import bucket_spec
from csmom_tpu_torch.serve.slo import default_policy
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["HashRing", "PoolRequest", "Router", "RouterConfig",
           "RouterServer", "WeightedFairGate", "main",
           "no_deadline_score_give_up_s"]

TERMINAL_STATES = ("served", "rejected", "expired")

_IDS = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Dispatch policy knobs (defaults tuned for the CPU pool)."""

    profile: str = "serve"
    default_deadline_s: float | None = 0.5
    hedge_fraction: float = 0.35   # of the remaining deadline budget
    hedge_floor_s: float = 0.05    # never hedge sooner than this
    hedge_after_s: float = 0.25    # hedge delay for deadline-less requests
    max_attempts: int = 3          # primary + hedge + one failover
    connect_timeout_s: float = 2.0
    # weighted fair dispatch: how many dispatches may run concurrently
    # through this router before waiters queue at the gate in SLO rank
    # order (0 disables the gate)
    fair_slots: int = 16
    # consistent-hash routing on the result-cache identity: identical
    # requests land on the same worker, lifting the per-worker result
    # cache to pool-level hit rates (False = pure round robin)
    affinity: bool = True


@dataclasses.dataclass
class PoolRequest:
    """One pool request's life-cycle record (router-side)."""

    kind: str
    n_assets: int
    priority: str = "interactive"
    deadline_s: float | None = None      # ABSOLUTE monotonic, None = none
    panel_version: int | None = None     # live-panel snapshot version
    req_id: int = dataclasses.field(default_factory=lambda: next(_IDS))
    state: str = "routing"
    result: object = None
    error: str | None = None
    worker_id: str | None = None         # who served it
    hedged: bool = False
    attempts: int = 0
    cache_hit: bool = False              # served from the worker's cache
    affinity: str | None = None          # consistent-hash routing key
    retry_after_s: float | None = None   # backoff hint on a parked fleet
    # True iff a rejection was the POOL's failure (dead sockets, parked
    # fleet), not an honest answer — carried on the wire so the client
    # tier's availability counts it instead of substring-matching text
    infra: bool = False
    t_submit_s: float = 0.0
    t_done_s: float | None = None
    # the request's trace context (obs.trace; None = untraced).  The
    # router owns the CLIENT half: route/transport/finalize stages plus
    # whatever worker half the winning attempt brought home.
    trace: object = dataclasses.field(default=None, repr=False,
                                      compare=False)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    @property
    def total_s(self) -> float | None:
        return (None if self.t_done_s is None
                else max(0.0, self.t_done_s - self.t_submit_s))

    def remaining_s(self, now_s: float) -> float | None:
        return (None if self.deadline_s is None
                else self.deadline_s - now_s)


class HashRing:
    """Consistent-hash ring with virtual nodes (blake2b, seed-free).

    Each member id is hashed onto the ring ``vnodes`` times; a key maps
    to the first vnode clockwise of its hash.  Removing one member moves
    only that member's arcs (about ``1/n`` of the keyspace) — the cache
    property the fabric needs: a worker death reshuffles the minimum,
    and its same-id replacement reclaims exactly its old arcs.
    """

    def __init__(self, ids, vnodes: int = 64):
        import bisect
        import hashlib

        self._bisect = bisect
        points = []
        for wid in ids:
            for v in range(vnodes):
                h = hashlib.blake2b(f"{wid}#{v}".encode(),
                                    digest_size=8).digest()
                points.append((int.from_bytes(h, "big"), str(wid)))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._ids = [p[1] for p in points]

    def pick(self, key: str) -> str | None:
        """The member ``key`` hashes to (None on an empty ring)."""
        if not self._hashes:
            return None
        import hashlib

        h = int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")
        i = self._bisect.bisect_right(self._hashes, h) % len(self._hashes)
        return self._ids[i]


class _Ticket:
    """One waiter's place at the gate.  Compared by identity: a timed-out
    waiter must withdraw ITS ticket (the reference's dict tickets compare
    equal, so ``list.remove`` could withdraw another waiter's; ROADMAP.md,
    known differences)."""

    __slots__ = ("granted",)

    def __init__(self):
        self.granted = False


class WeightedFairGate:
    """Bounded concurrent dispatch with SLO-rank priority at the gate.

    ``slots`` dispatches may run concurrently.  When the gate is
    contended, the next free slot goes to the waiting class with the
    LOWEST rank (interactive first — class rank enforced before the
    worker, not just inside it); among classes of equal rank the slot
    rotates weighted-fair by queue share (each class's granted count is
    normalized by its weight, smallest normalized count wins).  Waiters
    time out against their own deadline budget and are rejected as
    honest backpressure, never silently dropped.

    One leaf lock + condition; the wait is ``Condition.wait`` (exempt
    from the blocking-under-lock audit by design — it RELEASES the lock).
    """

    def __init__(self, policy, slots: int):
        self.slots = int(slots)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._in_use = 0
        self._rank = {}
        self._weight = {}
        for c in policy.classes:
            self._rank[c.name] = c.rank
            self._weight[c.name] = max(0.05, min(1.0, c.queue_share))
        self._waiting = {name: [] for name in self._rank}
        self.granted = {name: 0 for name in self._rank}
        self.timeouts = {name: 0 for name in self._rank}

    def _grant_next_locked(self) -> None:
        """Hand free slots to waiters, best class first."""
        granted_any = False
        while self._in_use < self.slots:
            best = None
            for name, q in self._waiting.items():
                if not q:
                    continue
                score = (self._rank[name],
                         self.granted[name] / self._weight[name])
                if best is None or score < best[0]:
                    best = (score, name)
            if best is None:
                break
            ticket = self._waiting[best[1]].pop(0)
            ticket.granted = True
            self._in_use += 1
            self.granted[best[1]] += 1
            granted_any = True
        if granted_any:
            self._cond.notify_all()

    def acquire(self, cls_name: str, timeout_s: float) -> bool:
        """One dispatch slot for ``cls_name`` (False = timed out)."""
        name = cls_name if cls_name in self._rank else \
            min(self._rank, key=lambda n: -self._rank[n])
        give_up = mono_now_s() + max(0.0, timeout_s)
        with self._cond:
            ticket = _Ticket()
            self._waiting[name].append(ticket)
            self._grant_next_locked()
            while not ticket.granted:
                remaining = give_up - mono_now_s()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            if ticket.granted:
                return True
            # timed out: withdraw the ticket.  No grant can race this —
            # _grant_next_locked only runs under the same lock we hold
            # continuously from the wait's return through the remove.
            self._waiting[name].remove(ticket)
            self.timeouts[name] += 1
            return False

    def release(self) -> None:
        with self._cond:
            self._in_use -= 1
            self._grant_next_locked()

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self.slots,
                "in_use": self._in_use,
                "granted": dict(self.granted),
                "timeouts": dict(self.timeouts),
            }


class Router:
    """Admit → fair gate → dispatch (hedged, cache-affine) →
    exactly-once terminal accounting."""

    def __init__(self, workers_fn, config: RouterConfig | None = None,
                 retry_after_fn=None):
        """``workers_fn() -> list`` of objects with ``.worker_id`` and
        ``.socket_path`` — the supervisor's current READY set (queried
        per attempt, so a worker that died between attempts is already
        gone from the menu).  ``retry_after_fn() -> float | None`` is
        the supervisor's backoff view: when NO worker is ready, door
        rejections carry this as a retry-after hint instead of burning
        the caller's deadline."""
        self.config = config or RouterConfig()
        self.spec = bucket_spec(self.config.profile)
        self.policy = default_policy()
        self._workers_fn = workers_fn
        self._retry_after_fn = retry_after_fn
        self._fair = (WeightedFairGate(self.policy, self.config.fair_slots)
                      if self.config.fair_slots > 0 else None)
        self._ring_cache: tuple = (None, None)   # (ids tuple, HashRing)
        self._lock = threading.Lock()
        self._rr = itertools.count()
        # the persistent multiplexed transport: one bounded
        # channel pool to the worker tier — dispatches interleave on
        # long-lived TCP_NODELAY channels instead of paying a fresh
        # connect + full header encode per attempt.  Probes and admin
        # ops stay on request_once.
        self.channels = proto.ChannelPool(
            connect_timeout_s=self.config.connect_timeout_s)
        # shared score-header renderer (proto.ScoreHeaderCache): the
        # same implementation the fabric client uses, so the two
        # tiers' wire headers cannot drift apart
        self._headers = proto.ScoreHeaderCache()
        # per-SLO-class books (closed like the global one); the policy
        # resolves legacy names ("batch" -> "bulk") so the wire protocol
        # and the in-process service count the same classes
        self.by_class = {name: {"admitted": 0, "served": 0, "rejected": 0,
                                "expired": 0}
                         for name in self.policy.names()}
        # accounting counters — the cross-process closed book
        self.admitted = 0
        self.served = 0
        self.rejected = 0
        self.expired = 0
        self.rejected_infra = 0
        self.rejected_unserveable = 0
        self.rejected_saturated = 0   # fair-gate timeouts (backpressure)
        self.rejected_no_worker = 0   # parked fleet, retry-after issued
        self.served_cache_hits = 0    # worker answered from its cache
        self.affinity_routed = 0      # picks the hash ring decided
        self.hedged = 0
        self.hedge_wins = 0
        self.duplicates_suppressed = 0
        self.late_served_suppressed = 0
        self.retries = 0
        self.worker_conn_failures = 0

    # --------------------------------------------------------------- admit

    def retry_after_hint_s(self) -> float | None:
        """The supervisor's backoff view, rounded for the wire (None
        when no hint is available)."""
        if self._retry_after_fn is None:
            return None
        try:
            hint = self._retry_after_fn()
        except Exception:
            return None
        return None if hint is None else round(max(0.05, float(hint)), 3)

    def submit(self, kind: str, values, mask, priority: str = "interactive",
               deadline_s: float | None = None,
               panel_version: int | None = None,
               trace_ctx=None) -> PoolRequest:
        """Admit one request; returns its handle (terminal on door
        rejection).  ``deadline_s`` is RELATIVE seconds (None = config
        default).  ``trace_ctx`` carries a wire-propagated trace context
        (the router-replica path); without one, a context is minted iff
        this process's trace book is armed."""
        from csmom_tpu_torch.chaos.inject import checkpoint
        from csmom_tpu_torch.obs import fleet as obs_fleet
        from csmom_tpu_torch.obs import metrics
        from csmom_tpu_torch.obs import trace as obs_trace

        values = np.asarray(values)
        mask = np.asarray(mask, dtype=bool)
        n_assets = int(values.shape[0]) if values.ndim == 2 else 0
        rel = (self.config.default_deadline_s if deadline_s is None
               else deadline_s)
        now = mono_now_s()
        try:
            priority = self.policy.resolve_name(priority)
        except ValueError:
            pass  # the worker's own door rejects unknown classes
        budget_ms = None
        try:
            budget_ms = round(1e3 * self.policy.resolve(priority).deadline_s,
                              3)
        except ValueError:
            pass
        req = PoolRequest(
            kind=kind, n_assets=n_assets, priority=priority,
            deadline_s=None if rel is None else now + rel, t_submit_s=now,
            panel_version=panel_version,
            trace=trace_ctx if trace_ctx is not None else obs_trace.begin(
                kind, priority, panel_version=panel_version,
                budget_ms=budget_ms))
        with self._lock:
            self.admitted += 1
            if priority in self.by_class:
                self.by_class[priority]["admitted"] += 1
        # fleet demand telemetry (a no-op disarmed): at this tier every
        # offered request is admitted, and the class books reconcile with
        # these counts by schema in the fleet artifact
        obs_fleet.demand("offered", priority)
        obs_fleet.demand("admitted", priority)
        checkpoint("pool.route", kind=kind, req=req.req_id)
        reason = self._unserveable_reason(kind, values, mask)
        if reason is not None:
            self._terminate(req, "rejected", error=reason, unserveable=True)
            metrics.counter("serve_pool.rejected_unserveable").inc()
            return req
        if not self._workers_fn():
            # EVERY worker parked/unreachable: reject AT THE DOOR with a
            # retry-after hint derived from the supervisor's backoff
            # state — burning the caller's full deadline per request on
            # a fleet that cannot answer would amplify the outage
            hint = self.retry_after_hint_s()
            req.retry_after_s = hint
            with self._lock:
                self.rejected_no_worker += 1
            self._terminate(
                req, "rejected", infra=True,
                error="no ready worker in the pool (all crashed, parked, "
                      "or draining)"
                      + (f"; retry after {hint}s" if hint is not None
                         else ""))
            metrics.counter("serve_pool.rejected_infra").inc()
            return req
        if self.config.affinity:
            # the result-cache identity (the serve/cache.py key minus the
            # pool-constant params): byte-identical requests share it, so
            # the hash ring lands them on the same worker's cache
            from csmom_tpu_torch.serve.cache import panel_fingerprint

            req.affinity = (f"{kind}|{n_assets}|"
                            f"{panel_fingerprint(values, mask)}|"
                            f"{panel_version}")
        t = threading.Thread(
            target=self._drive, args=(req, values, mask),
            name=f"csmom-pool-req-{req.req_id}", daemon=True)
        t.start()
        return req

    def _unserveable_reason(self, kind: str, values, mask) -> str | None:
        # same door checks as service.submit: an unserveable request must
        # fail here, not burn dispatch attempts on every worker in turn
        kinds = serve_endpoints()
        if kind not in kinds:
            return f"unknown endpoint {kind!r} (serveable: {kinds})"
        if values.ndim != 2:
            return f"panel must be [assets, months], got ndim={values.ndim}"
        if values.shape[1] != self.spec.months:
            return (f"panel has {values.shape[1]} months; this pool scores "
                    f"{self.spec.months}-month histories")
        if self.spec.asset_bucket_for(values.shape[0]) is None:
            return (f"{values.shape[0]} assets exceeds the largest bucket "
                    f"({self.spec.max_assets})")
        if mask.shape != values.shape:
            return (f"mask shape {mask.shape} does not match the values "
                    f"panel {values.shape}")
        return None

    # ------------------------------------------------------------ dispatch

    def _ring_for(self, ids: tuple) -> HashRing:
        cached_ids, ring = self._ring_cache
        if cached_ids != ids:
            ring = HashRing(ids)
            self._ring_cache = (ids, ring)
        return ring

    def _pick_worker(self, exclude: set, affinity: str | None = None):
        workers = [w for w in self._workers_fn()
                   if w.worker_id not in exclude]
        if not workers:
            return None
        if affinity is not None and len(workers) > 1:
            # the ring is built over the CURRENT candidates, so a dead
            # worker's arcs redistribute and a hedge (its target already
            # in `exclude`) degrades to the next-best worker
            ids = tuple(sorted(w.worker_id for w in workers))
            wid = self._ring_for(ids).pick(affinity)
            for w in workers:
                if w.worker_id == wid:
                    with self._lock:
                        self.affinity_routed += 1
                    return w
        elif affinity is not None:
            with self._lock:
                self.affinity_routed += 1
            return workers[0]
        return workers[next(self._rr) % len(workers)]

    def _hedge_delay(self, req: PoolRequest, now: float) -> float:
        rem = req.remaining_s(now)
        if rem is None:
            return self.config.hedge_after_s
        return max(self.config.hedge_floor_s,
                   self.config.hedge_fraction * rem)

    def _drive(self, req: PoolRequest, values, mask) -> None:
        """Attempt loop: primary, hedge-on-delay, failover-on-error.

        Event-driven: the loop sleeps on the attempt-conclusion event
        with a timeout set to the next interesting instant (hedge timer,
        deadline), and on every wake acts on exactly one of: a terminal
        state (done), a concluded-but-failed attempt (failover or
        settle), the hedge timer (launch the hedge, at most once), or
        the deadline (expire — after a short grace when a dispatch is
        still in flight, since its work is already spent)."""
        from csmom_tpu_torch.chaos.inject import checkpoint
        from csmom_tpu_torch.obs import metrics

        if self._fair is not None:
            # the weighted fair gate: class rank is enforced HERE, before
            # any worker sees the request.  The wait burns the request's
            # own budget; a timeout is honest backpressure.
            now0 = mono_now_s()
            rem0 = req.remaining_s(now0)
            gate_wait = rem0 if rem0 is not None else _NO_DEADLINE_ATTEMPT_S
            if not self._fair.acquire(req.priority, gate_wait):
                with self._lock:
                    self.rejected_saturated += 1
                self._terminate(
                    req, "rejected",
                    error="fair-dispatch gate saturated: the request's "
                          "budget elapsed before a dispatch slot freed "
                          f"(class {req.priority}); back off and retry")
                metrics.counter("serve_pool.rejected_saturated").inc()
                return
        try:
            self._drive_attempts(req, values, mask, checkpoint, metrics)
        finally:
            if self._fair is not None:
                self._fair.release()

    def _drive_attempts(self, req: PoolRequest, values, mask,
                        checkpoint, metrics) -> None:
        tried: set = set()
        failures: list = []
        state: dict = {"done": threading.Event(), "lock": threading.Lock(),
                       "in_flight": 0, "concluded": 0}

        def launch(is_hedge: bool) -> bool:
            worker = self._pick_worker(tried, affinity=req.affinity)
            if worker is None:
                return False
            tried.add(worker.worker_id)
            with self._lock:
                req.attempts += 1
                if is_hedge:
                    req.hedged = True
            with state["lock"]:
                state["in_flight"] += 1
            threading.Thread(
                target=self._attempt, args=(req, worker, values, mask,
                                            is_hedge, state, failures),
                daemon=True).start()
            return True

        if not launch(False):
            hint = self.retry_after_hint_s()
            req.retry_after_s = hint
            with self._lock:
                self.rejected_no_worker += 1
            self._terminate(req, "rejected", infra=True,
                            error="no ready worker in the pool (all "
                                  "crashed, draining, or never became "
                                  "ready)"
                                  + (f"; retry after {hint}s"
                                     if hint is not None else ""))
            metrics.counter("serve_pool.rejected_infra").inc()
            return
        hedge_at = mono_now_s() + self._hedge_delay(req, mono_now_s())
        acted = 0
        while True:
            if req.state in TERMINAL_STATES:
                return
            now = mono_now_s()
            rem = req.remaining_s(now)
            with state["lock"]:
                in_flight = state["in_flight"]
                concluded = state["concluded"]
            if concluded > acted:
                acted = concluded
                state["done"].clear()
                if in_flight == 0:
                    # every launched attempt failed: failover while the
                    # budget and the worker menu allow, else settle
                    if ((rem is None or rem > 0)
                            and req.attempts < self.config.max_attempts
                            and launch(False)):
                        with self._lock:
                            self.retries += 1
                        metrics.counter("serve_pool.retries").inc()
                        continue
                    self._settle(req, failures)
                    return
                continue  # a loser concluded; the other attempt lives on
            if rem is not None and rem <= 0:
                if in_flight == 0 or rem <= -_LATE_GRACE_S:
                    self._terminate(req, "expired",
                                    error="deadline expired before any "
                                          "worker answered")
                    metrics.counter("serve_pool.expired").inc()
                    return
            if (hedge_at is not None and now >= hedge_at
                    and req.attempts < self.config.max_attempts):
                hedge_at = None  # hedge at most once per request
                if launch(True):
                    with self._lock:
                        self.hedged += 1
                    checkpoint("pool.hedge", kind=req.kind, req=req.req_id)
                    metrics.counter("serve_pool.hedges").inc()
                continue
            waits = [0.25]  # heartbeat: re-evaluate even with no event
            if hedge_at is not None:
                waits.append(max(0.001, hedge_at - now))
            if rem is not None:
                waits.append(max(0.001, rem + _LATE_GRACE_S))
            state["done"].wait(timeout=min(waits))

    def _settle(self, req: PoolRequest, failures: list) -> None:
        """Close the books on a request no attempt could serve."""
        from csmom_tpu_torch.obs import metrics

        now = mono_now_s()
        if req.deadline_s is not None and now > req.deadline_s:
            self._terminate(req, "expired",
                            error="deadline expired with every dispatch "
                                  "attempt failed")
            metrics.counter("serve_pool.expired").inc()
            return
        reason = "; ".join(failures[-3:]) or "no worker answered"
        # infra iff the pool itself failed (dead sockets, crashed
        # workers); an honest worker-level rejection (backpressure,
        # draining) settling here is the pool's honest answer
        infra = (all("connection failed" in f for f in failures)
                 if failures else True)
        self._terminate(req, "rejected", infra=infra,
                        error=f"all {req.attempts} attempt(s) failed: "
                              f"{reason}"[:300])
        metrics.counter("serve_pool.rejected_infra" if infra
                        else "serve_pool.rejected").inc()

    def _attempt(self, req: PoolRequest, worker, values, mask,
                 is_hedge: bool, state: dict, failures: list) -> None:
        """One dispatch attempt against one worker, over the pooled
        multiplexed channel to it — no per-attempt dial."""
        from csmom_tpu_torch.obs import metrics, span

        now = mono_now_s()
        rem = req.remaining_s(now)
        # a deadline-less request must outwait the WORKER's own terminal
        # wait (_NO_DEADLINE_WAIT_S in worker.py) — a shorter reply
        # timeout here would misread slow-but-successful work as an
        # infra failure and throw the result away
        wait_budget = rem if rem is not None else _NO_DEADLINE_ATTEMPT_S
        timeout = (self.config.connect_timeout_s + wait_budget
                   + _TERMINAL_GRACE_S)
        header = self._headers.render(req.kind, req.priority,
                                      req.panel_version, req.req_id,
                                      rem, trace_ctx=req.trace)
        t_attempt0 = mono_now_s()
        marks: dict = {}
        try:
            with span("pool.attempt", phase="row", kind=req.kind,
                      worker=worker.worker_id, hedge=is_hedge):
                obj, arrays = self.channels.request(
                    worker.socket_path, header,
                    arrays={"values": values, "mask": mask},
                    timeout_s=timeout, marks=marks)
        except (OSError, proto.ProtocolError) as e:
            with self._lock:
                self.worker_conn_failures += 1
            metrics.counter("serve_pool.worker_conn_failures").inc()
            reason = (f"connection failed "
                      f"({type(e).__name__}: {e})")[:160]
            if req.trace is not None:
                # a dispatch that will never report back: the worker died
                # (the rehearsed SIGKILL) or reset — its half is an
                # ORPHAN, closed here with the reason instead of leaking
                req.trace.note_orphan(worker.worker_id, reason)
            failures.append(f"{worker.worker_id}: {reason}")
            self._conclude_attempt(state)
            return
        t_attempt1 = mono_now_s()
        resp_state = obj.get("state")
        if resp_state == "served":
            result = (obj.get("result_obj") if "result_obj" in obj
                      else arrays.get("result"))
            if result is not None and not isinstance(result, dict):
                result = np.asarray(result)[:req.n_assets]
            won = self._terminate(req, "served", result=result,
                                  worker_id=obj.get("worker_id"),
                                  hedge_win=is_hedge,
                                  cache_hit=bool(obj.get("cache_hit")),
                                  trace_half=obj.get("trace_half"),
                                  attempt_window=(t_attempt0, t_attempt1,
                                                  worker.worker_id,
                                                  marks.get("t_acquired_s"),
                                                  marks.get("t_sent_s")))
            if won:
                metrics.counter("serve_pool.served").inc()
            self._conclude_attempt(state)
            return
        # a worker-level rejection/expiry is a failed attempt, not (yet)
        # the request's fate — another worker may still serve it
        failures.append(
            f"{worker.worker_id}: {resp_state}: {obj.get('error')}"[:160])
        self._conclude_attempt(state)

    @staticmethod
    def _conclude_attempt(state: dict) -> None:
        with state["lock"]:
            state["in_flight"] -= 1
            state["concluded"] += 1
        state["done"].set()

    # ------------------------------------------------------------ terminal

    def _terminate(self, req: PoolRequest, state: str, result=None,
                   error: str | None = None, worker_id: str | None = None,
                   infra: bool = False, unserveable: bool = False,
                   hedge_win: bool = False, cache_hit: bool = False,
                   trace_half: dict | None = None,
                   attempt_window: tuple | None = None) -> bool:
        """Exactly-once terminal transition; returns True iff this call
        won.  A losing ``served`` (the hedge pair both answered) counts
        ``duplicates_suppressed`` — the duplicate is EXPECTED under
        hedging; silently double-counting it would break the books."""
        with self._lock:
            if req.state in TERMINAL_STATES:
                if state == "served":
                    if req.hedged:
                        # the expected loser of a hedge pair
                        self.duplicates_suppressed += 1
                    else:
                        # an UNhedged late answer (e.g. a worker replying
                        # after the router expired the request): also
                        # suppressed, but counted apart — the
                        # duplicates_suppressed <= hedged invariant is
                        # about hedge arithmetic, and a slow worker must
                        # not read as "exactly-once broke"
                        self.late_served_suppressed += 1
                return False
            req.state = state
            req.result = result
            if error is not None:
                req.error = error
            req.worker_id = worker_id
            req.t_done_s = mono_now_s()
            if state == "served":
                self.served += 1
                if hedge_win:
                    self.hedge_wins += 1
                if cache_hit:
                    req.cache_hit = True
                    self.served_cache_hits += 1
            elif state == "expired":
                self.expired += 1
            else:
                self.rejected += 1
                req.infra = infra
                if infra:
                    self.rejected_infra += 1
                if unserveable:
                    self.rejected_unserveable += 1
            if req.priority in self.by_class:
                self.by_class[req.priority][state] += 1
            if req.trace is not None:
                # stitch + close inside the same exactly-once guard as
                # the request: only the WINNING attempt's half and window
                # reach the absorbed chain — a hedge loser's half can
                # never corrupt the telescoping sum
                if trace_half is not None and attempt_window is not None:
                    t0a, t1a, wid = attempt_window[:3]
                    acq, sent = (attempt_window[3:5]
                                 if len(attempt_window) >= 5
                                 else (None, None))
                    req.trace.absorb_remote(trace_half, t0a, t1a,
                                            worker_id=wid,
                                            t_acquired_s=acq,
                                            t_sent_s=sent)
                req.trace.close_routed(state, req.t_done_s,
                                       reason=error)
            req._done.set()
        if state == "served":
            from csmom_tpu_torch.obs import fleet as obs_fleet

            obs_fleet.demand("served", req.priority)
        return True

    # ---------------------------------------------------------- accounting

    def accounting(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "served": self.served,
                "rejected": self.rejected,
                "expired": self.expired,
                "rejected_infra": self.rejected_infra,
                "rejected_unserveable": self.rejected_unserveable,
                "rejected_saturated": self.rejected_saturated,
                "rejected_no_worker": self.rejected_no_worker,
                "served_cache_hits": self.served_cache_hits,
                "affinity_routed": self.affinity_routed,
                "hedged": self.hedged,
                "hedge_wins": self.hedge_wins,
                "duplicates_suppressed": self.duplicates_suppressed,
                "late_served_suppressed": self.late_served_suppressed,
                "retries": self.retries,
                "worker_conn_failures": self.worker_conn_failures,
            }

    def class_accounting(self) -> dict:
        """Per-SLO-class books (closed like the global one)."""
        with self._lock:
            return {name: dict(book)
                    for name, book in self.by_class.items()}

    def availability(self) -> float:
        """``1 - rejected_infra / admitted``: the fraction of admitted
        requests that got an HONEST answer (served, backpressure-
        rejected, or client-deadline-expired).  Only infra failures —
        the pool failing its own job — count against it."""
        a = self.accounting()
        if not a["admitted"]:
            return 1.0
        return round(1.0 - a["rejected_infra"] / a["admitted"], 6)

    def invariant_violations(self) -> list:
        """Closed books across the process boundary (empty = holds)."""
        a = self.accounting()
        out = []
        if a["served_cache_hits"] > a["served"]:
            out.append(f"served_cache_hits {a['served_cache_hits']} > "
                       f"served {a['served']}")
        total = a["served"] + a["rejected"] + a["expired"]
        if total != a["admitted"]:
            out.append(
                f"pool accounting broken: served {a['served']} + rejected "
                f"{a['rejected']} + expired {a['expired']} = {total} != "
                f"admitted {a['admitted']}")
        if a["hedge_wins"] > a["hedged"]:
            out.append(f"hedge_wins {a['hedge_wins']} > hedged "
                       f"{a['hedged']}")
        if a["duplicates_suppressed"] > a["hedged"]:
            out.append(
                f"duplicates_suppressed {a['duplicates_suppressed']} > "
                f"hedged {a['hedged']} — a duplicate without a hedge "
                "means a terminal state fired twice")
        if a["rejected_infra"] + a["rejected_unserveable"] > a["rejected"]:
            out.append("rejection sub-counters exceed rejected")
        return out


_TERMINAL_GRACE_S = 5.0
# deadline grace while a dispatch is still in flight: the worker's work
# is already spent, so a response landing a beat late still counts
_LATE_GRACE_S = 1.0
# attempt wait for deadline-less requests — matches the worker's
# _NO_DEADLINE_WAIT_S so the two sides give up together
_NO_DEADLINE_ATTEMPT_S = 30.0


def no_deadline_score_give_up_s(connect_timeout_s: float) -> float:
    """How long a router tier waits for a DEADLINE-LESS request to reach
    terminal: a full fair-gate wait plus one full dispatch attempt
    (connect + worker wait + grace) plus its own grace.  A tier in front
    of the router (the fabric's client, 6c) derives its per-attempt
    receive budget from this, so the chain gives up outermost-last."""
    return (_NO_DEADLINE_ATTEMPT_S          # fair-gate wait
            + connect_timeout_s
            + _NO_DEADLINE_ATTEMPT_S        # worker-side terminal wait
            + 2 * _TERMINAL_GRACE_S)


# ------------------------------------------------------------ the replica ---

class RouterServer:
    """One supervised router-replica process: a :class:`Router` behind
    the pool wire protocol (unix or tcp), its worker set read from the
    fabric's shared routes file.

    The replica holds no panels and no queue, so a replica SIGKILLed
    mid-burst loses only the requests transiting it, which the fabric
    client fails over to a surviving replica.  Its ops mirror the
    worker's (``ping``, ``ready``, ``score``, ``stats``, ``drain``,
    ``stop``), so the same supervisor machinery babysits both tiers.

    Tracing: a ``score`` frame carrying a ``trace`` entry gets its
    context rebuilt here, opened into this process's book when one is
    armed, threaded through the router's dispatch, and the closed
    context's stage chain rides back in the reply's ``trace_half``.
    ``main --trace`` arms this process's book.
    """

    def __init__(self, listen_addr: str, routes_path: str,
                 router_id: str = "r0",
                 config: RouterConfig | None = None,
                 expect_cache_version: str | None = None):
        from csmom_tpu_torch.serve.fabric import RoutesView

        self.listen_addr = listen_addr
        self.router_id = router_id
        # the WORKER tier's cache version, echoed in stats (a replica
        # builds and loads no kernel of its own)
        self.expect_cache_version = expect_cache_version
        self.routes = RoutesView(routes_path)
        self.router = Router(self.routes.workers, config,
                             retry_after_fn=self.routes.retry_after_s)
        self._draining = False
        self._stop = threading.Event()
        self._listener = None

    # ----------------------------------------------------------- lifecycle

    def bind(self) -> None:
        self._listener = proto.listen(self.listen_addr)
        self._listener.settimeout(0.2)
        t = threading.Thread(target=self._accept_loop,
                             name=f"csmom-router-{self.router_id}-accept",
                             daemon=True)
        t.start()

    def run_until_stopped(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(0.2)
        self._shutdown()

    def _shutdown(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self.router.channels.close()
        proto.unlink_address(self.listen_addr)

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------- serving

    def _accept_loop(self) -> None:
        import socket as _socket

        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                return  # listener closed under us: shutting down
            # one persistent connection per fabric-client channel: the
            # serve loop demuxes interleaved score frames off it, each
            # scored on its own thread through the router's dispatch
            t = threading.Thread(
                target=proto.serve_connection,
                args=(conn, self._handle),
                kwargs={"on_stop": self.stop},
                daemon=True)
            t.start()

    def _handle(self, obj: dict, arrays: dict) -> tuple:
        op = obj.get("op")
        if op == "ping":
            return {"ok": True, "worker_id": self.router_id,
                    "router_id": self.router_id, "pid": os.getpid()}, None
        if op == "ready":
            ok, reason = self.routes.status()
            if self._draining:
                ok, reason = False, "draining"
            return {"ok": ok, "reason": None if ok else reason,
                    "worker_id": self.router_id,
                    "router_id": self.router_id,
                    "pid": os.getpid(),
                    "tier": "router",
                    "workers": len(self.routes.workers()),
                    "fresh_compiles": 0}, None
        if op == "stats":
            return self._stats(), None
        if op == "score":
            return self._score(obj, arrays)
        if op in ("drain", "stop"):
            self._draining = True
            out = self._stats()
            out["drained"] = True
            return out, None
        return {"ok": False, "error": f"unknown op {op!r}"}, None

    def _stats(self) -> dict:
        from csmom_tpu_torch.obs import trace as obs_trace

        out = {
            "ok": True,
            "worker_id": self.router_id,
            "router_id": self.router_id,
            "tier": "router",
            "pid": os.getpid(),
            "accounting": self.router.accounting(),
            "classes": self.router.class_accounting(),
            "availability": self.router.availability(),
            "invariant_violations": self.router.invariant_violations(),
            "fair_gate": (self.router._fair.stats()
                          if self.router._fair is not None else None),
            # dials vs reuses on the worker-tier channels
            "channels": self.router.channels.stats(),
            "retry_after_s": self.router.retry_after_hint_s(),
            "expect_cache_version": self.expect_cache_version,
            # a replica holds no compute: this process never imports
            # torch (a reply field, not part of the artifact's schema)
            "torch_loaded": "torch" in sys.modules,
        }
        book = obs_trace.current_book()
        if book is not None:
            out["trace"] = {
                "snapshot": book.snapshot(),
                "invariant_violations": book.invariant_violations(),
            }
        return out

    def _score(self, obj: dict, arrays: dict) -> tuple:
        from csmom_tpu_torch.obs import trace as obs_trace

        if self._draining:
            return {"state": "rejected", "error": "router draining",
                    "router_id": self.router_id}, None
        if "values" not in arrays or "mask" not in arrays:
            return {"state": "rejected",
                    "error": "score frame missing values/mask arrays",
                    "router_id": self.router_id}, None
        rel = obj.get("deadline_rel_s")
        pv = obj.get("panel_version")
        trace_ctx = None
        wire_trace = obj.get("trace")
        if isinstance(wire_trace, dict):
            trace_ctx = obs_trace.TraceContext.from_wire(wire_trace)
            book = obs_trace.current_book()
            if book is not None:
                # the replica-tier ledger: this process's books must
                # close over every trace it transited
                book.open_trace(trace_ctx)
        req = self.router.submit(
            str(obj.get("kind")), arrays["values"], arrays["mask"],
            priority=str(obj.get("priority", "interactive")),
            deadline_s=float(rel) if rel is not None else None,
            panel_version=int(pv) if pv is not None else None,
            trace_ctx=trace_ctx,
        )
        # a deadline-bounded request terminates within its own budget; a
        # deadline-less one can spend a full fair-gate wait and a full
        # dispatch attempt before terminal, so the give-up covers both
        wait_s = (float(rel) + _TERMINAL_GRACE_S if rel is not None
                  else no_deadline_score_give_up_s(
                      self.router.config.connect_timeout_s))
        if not req.wait(wait_s):
            return {"state": "rejected",
                    "error": "request never reached a terminal state "
                             f"within {wait_s:.1f}s (router defect)",
                    "infra": True,
                    "router_id": self.router_id}, None
        reply = {
            "state": req.state,
            "error": req.error,
            "infra": req.infra,
            "router_id": self.router_id,
            "worker_id": req.worker_id,
            "cache_hit": req.cache_hit,
            "hedged": req.hedged,
            "attempts": req.attempts,
            "retry_after_s": req.retry_after_s,
            "panel_version": req.panel_version,
        }
        if trace_ctx is not None:
            # the replica's closed stage chain (its route and transport
            # plus the worker's stitched half) for the client to stitch
            reply["trace_half"] = trace_ctx.half_record()
        out_arrays = None
        if req.state == "served":
            if isinstance(req.result, dict):
                reply["result_obj"] = {k: float(v)
                                       for k, v in req.result.items()}
            else:
                out_arrays = {"result": np.asarray(req.result)}
        return reply, out_arrays


def main(argv=None) -> int:
    """``python -m csmom_tpu_torch.serve.router``: one supervised replica."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="csmom_tpu_torch.serve.router",
        description="router replica: hedged cache-affine dispatch behind "
                    "a unix/tcp socket, workers from a shared routes file")
    ap.add_argument("--listen", required=True,
                    help="address to serve on (unix:/path or tcp:host:port)")
    ap.add_argument("--routes", required=True,
                    help="path to the fabric's routes file (the shared "
                         "admission view: ready workers + backoff hints)")
    ap.add_argument("--router-id", dest="router_id", default="r0")
    ap.add_argument("--profile", default="serve")
    ap.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                    default=500.0)
    ap.add_argument("--hedge-fraction", dest="hedge_fraction", type=float,
                    default=0.35)
    ap.add_argument("--max-attempts", dest="max_attempts", type=int,
                    default=3)
    ap.add_argument("--fair-slots", dest="fair_slots", type=int, default=16)
    ap.add_argument("--no-affinity", dest="affinity", action="store_false",
                    help="disable consistent-hash cache routing "
                         "(round-robin picks)")
    ap.add_argument("--trace", action="store_true",
                    help="arm the replica's trace book (obs.trace); its "
                         "snapshot rides the stats reply")
    ap.add_argument("--expect-cache-version", dest="expect_cache_version",
                    help="echoed in stats (a replica builds no kernel of "
                         "its own)")
    args = ap.parse_args(argv)
    tag = f"[router {args.router_id}]"

    if args.trace:
        from csmom_tpu_torch.obs import trace as obs_trace

        obs_trace.arm_tracing(seed=0)

    cfg = RouterConfig(
        profile=args.profile,
        default_deadline_s=(None if args.deadline_ms in (None, 0)
                            else args.deadline_ms / 1e3),
        hedge_fraction=args.hedge_fraction,
        max_attempts=args.max_attempts,
        fair_slots=args.fair_slots,
        affinity=args.affinity,
    )
    server = RouterServer(args.listen, args.routes,
                          router_id=args.router_id, config=cfg,
                          expect_cache_version=args.expect_cache_version)

    def _term(signum, frame):  # graceful stop on SIGTERM
        server.stop()

    signal.signal(signal.SIGTERM, _term)

    # join the run's fleet observatory when armed (the environment
    # inherited from the router supervisor); stdlib and numpy only, so
    # the replica still never loads torch
    from csmom_tpu_torch.obs import fleet as obs_fleet

    obs_fleet.arm_emitter_from_env("router", args.router_id)

    server.bind()
    ok, reason = server.routes.status()
    print(f"{tag} pid {os.getpid()} listening on {args.listen}; routes "
          f"{'ok' if ok else reason} ({len(server.routes.workers())} "
          "workers)", file=sys.stderr, flush=True)
    server.run_until_stopped()
    obs_fleet.disarm_emitter("router stopped (drained)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
