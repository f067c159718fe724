"""Bounded admission queue: SLO classes, deadlines, closed per-class books.

Counterpart of ``csmom_tpu.serve.queue``, copied.  The front door of
the signal service:

- **bounded, rejecting**: at most ``capacity`` requests; a submit
  against a full queue is rejected at once with a retry-after hint from
  the observed drain rate;
- **SLO classes** (:mod:`csmom_tpu_torch.serve.slo`): every request
  belongs to a named class (``interactive`` > ``standard`` > ``bulk``;
  ``batch`` is an alias of ``bulk``) with a deadline budget, a
  token-bucket quota and a queue-share bound; over-quota and over-share
  submissions are rejected at the door (``rejected_quota``) before they
  occupy capacity, and collection prefers lower rank;
- **deadlines are cancellations**: a request that expires while queued
  is marked ``expired`` and never dispatched; one whose dispatch began
  in time is served even if it finishes late;
- **closed accounting, globally and per class**: every submitted
  request ends in exactly one of ``served`` / ``rejected`` /
  ``expired``, so ``served + rejected + expired == admitted`` once
  drained (:meth:`invariant_violations` checks it).  Terminal
  transitions go through one guarded method; coalesced followers
  resolve inside their leader's transition.

Collection fires when a full bucket's worth waits, when the coalescing
window closes, or early when a queued request's remaining budget dips
under the caller's risk margin (see :mod:`csmom_tpu_torch.serve.batcher`).

Stdlib-only, thread-safe, all timing through
:func:`csmom_tpu_torch.utils.deadline.mono_now_s`.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import deque

from csmom_tpu_torch.serve.slo import SLOPolicy, default_policy
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["AdmissionQueue", "PRIORITIES", "Request", "TERMINAL_STATES"]

# the two-class names of the first queue; the live class set comes from
# the policy
PRIORITIES = ("interactive", "batch")
TERMINAL_STATES = ("served", "rejected", "expired")

_IDS = itertools.count(1)

# retry-after hint bounds (see _retry_after_locked): before the first
# request has ever been served the EMA drain rate is UNDEFINED, so the
# hint falls back to a conservative per-request default instead of
# surfacing None/0 to the first overloaded callers; and however deep the
# queue or slow the drain, the hint is capped — "retry in 90 s" is not
# actionable advice from a bounded queue, it is a misread of a transient
RETRY_AFTER_COLD_PER_REQ_S = 0.005
RETRY_AFTER_MIN_S = 0.001
RETRY_AFTER_MAX_S = 2.0

# the per-class terminal counter names every class book carries
_CLASS_COUNTERS = ("admitted", "served", "rejected", "expired",
                   "rejected_quota")


@dataclasses.dataclass
class Request:
    """One scoring request and its life-cycle record.

    ``values``/``mask`` are the request's panel (numpy ``[A, M]``); the
    service pads them into a bucket shape at dispatch.  ``deadline_s`` is
    ABSOLUTE monotonic seconds (None = no deadline).  State moves
    ``queued -> dispatched -> served`` on the happy path, or terminates
    early in ``rejected`` / ``expired``; ``wait()`` blocks the caller
    until a terminal state.  A coalesced follower (state ``coalesced``)
    never enters the deques: it resolves with its leader.
    """

    kind: str
    values: object
    mask: object
    n_assets: int
    priority: str = "interactive"
    deadline_s: float | None = None
    # the live-panel version the request's inputs were snapshotted at
    # (None for batch-panel requests); stamped through to the response so
    # ingest-vs-serve version reconciliation is checkable arithmetic
    panel_version: int | None = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_IDS))
    state: str = "queued"
    result: object = None
    error: str | None = None
    retry_after_s: float | None = None
    cache_hit: bool = False
    coalesced: bool = False
    cache_key: object = None     # set on cache-eligible leaders (service)
    t_submit_s: float = 0.0
    t_dispatch_s: float | None = None
    t_done_s: float | None = None
    # the request's trace context (obs.trace): None when tracing is off
    # AND the request was built outside a service; the shared no-op
    # singleton when a service minted it disarmed.  Call sites guard on
    # None so bare test Requests cost nothing.
    trace: object = dataclasses.field(default=None, repr=False,
                                      compare=False)
    followers: list = dataclasses.field(default_factory=list, repr=False,
                                        compare=False)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the request is terminal; True iff it is."""
        return self._done.wait(timeout)

    @property
    def queue_wait_s(self) -> float | None:
        """Seconds spent queued before dispatch (or before early
        termination for rejected/expired requests)."""
        end = self.t_dispatch_s if self.t_dispatch_s is not None else self.t_done_s
        return None if end is None else max(0.0, end - self.t_submit_s)

    @property
    def service_s(self) -> float | None:
        """Dispatch-to-done seconds (None until served)."""
        if self.t_dispatch_s is None or self.t_done_s is None:
            return None
        return max(0.0, self.t_done_s - self.t_dispatch_s)

    @property
    def total_s(self) -> float | None:
        return (None if self.t_done_s is None
                else max(0.0, self.t_done_s - self.t_submit_s))

    def expired_at(self, now_s: float) -> bool:
        return self.deadline_s is not None and now_s > self.deadline_s


class AdmissionQueue:
    """Bounded multi-class FIFO with quotas and deadline cancellation.

    ``admitted`` counts every request PRESENTED via submit (the
    accounting denominator): a queue-full or over-quota rejection is a
    presented request that terminated in ``rejected``, so the invariant
    ``served + rejected + expired == admitted`` closes over backpressure
    and quota enforcement too — nothing the caller ever handed us can
    vanish from the books.  The same equation closes PER CLASS.
    """

    def __init__(self, capacity: int = 64,
                 policy: SLOPolicy | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.policy = policy or default_policy()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queues = {name: deque() for name in self.policy.names()}
        self._buckets = {c.name: c.make_bucket()
                         for c in self.policy.classes}
        # accounting counters (see invariant_violations)
        self.admitted = 0
        self.served = 0
        self.rejected = 0
        self.expired = 0
        self.rejected_queue_full = 0
        self.rejected_worker_crash = 0
        self.rejected_unserveable = 0
        self.rejected_quota = 0
        self.served_cache_hits = 0
        self.served_coalesced = 0
        self.rejected_coalesced = 0
        # requests refused because their live-panel snapshot version had
        # skewed beyond the service's allowance
        self.rejected_version_skew = 0
        # requests dispatched AFTER their deadline had already passed —
        # structurally 0 (collect cancels first); the counter exists so
        # the artifact can CLAIM it, not hope it
        self.expired_dispatched = 0
        # per-class books: class name -> {admitted, served, ...}
        self.by_class = {name: dict.fromkeys(_CLASS_COUNTERS, 0)
                         for name in self.policy.names()}
        # EMA of per-request service seconds, feeding the retry-after hint
        self._ema_per_req_s: float | None = None

    def resolve_class(self, name: str) -> str:
        return self.policy.resolve_name(name)

    def retune_quota(self, cls_name: str, quota_rps: float,
                     quota_burst: float | None = None) -> bool:
        """The autoscaler's seam (``serve/fleet.py``): retune a class's
        admission quota IN PLACE.  Only classes that already carry a
        bucket are tunable — granting an unquota'd class a quota at
        runtime would change admission semantics, not tune them.
        Returns True when applied."""
        cls = self.policy.resolve(cls_name)
        with self._lock:
            bucket = self._buckets.get(cls.name)
            if bucket is None or quota_rps <= 0:
                return False
            bucket.rate = float(quota_rps)
            bucket.burst = float(quota_burst if quota_burst
                                 and quota_burst > 0 else 1.5 * quota_rps)
            return True

    # ------------------------------------------------------------- admit --

    def submit(self, req: Request) -> Request:
        """Admit or reject ``req``; returns it either way (terminal state
        and ``retry_after_s`` set on rejection).  Admission order:
        global capacity (a full queue is backpressure no matter the
        class), class queue share, THEN the class quota bucket — a
        request the queue could not have held anyway must not burn a
        quota token, or one overload episode would punish the class
        twice (once as backpressure, again as a drained bucket when the
        queue frees)."""
        from csmom_tpu_torch.chaos.inject import checkpoint
        from csmom_tpu_torch.obs import metrics

        cls = self.policy.resolve(req.priority)
        req.priority = cls.name
        req.t_submit_s = mono_now_s()
        checkpoint("serve.admit", kind=req.kind, priority=req.priority)
        with self._lock:
            self.admitted += 1
            self.by_class[cls.name]["admitted"] += 1
            queue_full = self._depth_locked() >= self.capacity
            over_share = (not queue_full
                          and len(self._queues[cls.name])
                          >= cls.max_queued(self.capacity))
            if queue_full or over_share:
                if over_share:
                    # the class hit ITS bound, not the queue's: quota
                    # enforcement, counted in the class's own book
                    self.rejected_quota += 1
                    self.by_class[cls.name]["rejected_quota"] += 1
                else:
                    self.rejected_queue_full += 1
                req.retry_after_s = self._retry_after_locked()
                what = (f"class {cls.name!r} queue share "
                        f"({cls.max_queued(self.capacity)} of "
                        f"{self.capacity} slots)" if over_share
                        else f"queue full ({self.capacity} queued)")
                self._terminate_locked(
                    req, "rejected",
                    error=f"{what}; retry after "
                          f"~{req.retry_after_s:.3f}s",
                )
                # metrics mirror the books: a share rejection is quota
                # enforcement, not capacity exhaustion
                metrics.counter("serve.rejected_quota" if over_share
                                else "serve.rejected_queue_full").inc()
                return req
            bucket = self._buckets[cls.name]
            if bucket is not None and not bucket.try_take(req.t_submit_s):
                self.rejected_quota += 1
                self.by_class[cls.name]["rejected_quota"] += 1
                req.retry_after_s = max(RETRY_AFTER_MIN_S,
                                        min(RETRY_AFTER_MAX_S,
                                            1.0 / bucket.rate))
                self._terminate_locked(
                    req, "rejected",
                    error=f"class {cls.name!r} over its admission quota "
                          f"({bucket.rate:g} req/s sustained); retry "
                          f"after ~{req.retry_after_s:.3f}s",
                )
                metrics.counter("serve.rejected_quota").inc()
                return req
            self._queues[cls.name].append(req)
            if req.trace is not None:
                req.trace.mark("admit")
            metrics.gauge("serve.queue_depth").set(self._depth_locked())
            self._nonempty.notify()
        return req

    def serve_at_door(self, req: Request, result) -> Request:
        """Present-and-serve in one step: a cache hit.  The request still
        counts toward ``admitted`` and ``served`` so the books close over
        cache hits like everything else."""
        from csmom_tpu_torch.obs import metrics

        cls = self.policy.resolve(req.priority)
        req.priority = cls.name
        with self._lock:
            self.admitted += 1
            self.by_class[cls.name]["admitted"] += 1
            req.t_submit_s = mono_now_s()
            req.cache_hit = True
            if self._terminate_locked(req, "served", result=result):
                self.served_cache_hits += 1
                metrics.counter("serve.cache_hits").inc()
        return req

    def attach_follower(self, leader: Request, follower: Request) -> bool:
        """Attach ``follower`` to ``leader`` (identical in-flight request
        sharing one dispatch).  False iff the leader is already terminal
        — the caller re-checks the cache instead.  An attached follower
        is admitted (counted) and resolves inside the leader's terminal
        transition."""
        cls = self.policy.resolve(follower.priority)
        follower.priority = cls.name
        with self._lock:
            if leader.state in TERMINAL_STATES:
                return False
            follower.state = "coalesced"
            follower.coalesced = True
            follower.t_submit_s = mono_now_s()
            leader.followers.append(follower)
            self.admitted += 1
            self.by_class[cls.name]["admitted"] += 1
        return True

    def _retry_after_locked(self) -> float:
        """Drain-rate estimate: depth * observed per-request service
        time, clamped to [RETRY_AFTER_MIN_S, RETRY_AFTER_MAX_S].

        Cold start: before anything has been served, ``_ema_per_req_s``
        is None (and a degenerate 0.0 EMA is falsy too) — the bounded
        default ``RETRY_AFTER_COLD_PER_REQ_S`` stands in, so the FIRST
        overload rejection already carries an actionable float hint,
        never None (the regression that motivated these named bounds).
        """
        per_req = (self._ema_per_req_s if self._ema_per_req_s
                   else RETRY_AFTER_COLD_PER_REQ_S)
        return min(RETRY_AFTER_MAX_S,
                   max(RETRY_AFTER_MIN_S, self._depth_locked() * per_req))

    # ------------------------------------------------------------ collect --

    def _depth_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def _expire_locked(self, now_s: float) -> None:
        """Cancel every queued request whose deadline has passed — BEFORE
        any of them can be gathered into a micro-batch."""
        from csmom_tpu_torch.obs import metrics

        for q in self._queues.values():
            live = [r for r in q if not r.expired_at(now_s)]
            if len(live) != len(q):
                for r in q:
                    if r.expired_at(now_s):
                        self._terminate_locked(
                            r, "expired",
                            error="deadline expired while queued "
                                  "(never dispatched)",
                        )
                        metrics.counter("serve.expired").inc()
                q.clear()
                q.extend(live)

    def _min_budget_locked(self, kind: str, now_s: float) -> float | None:
        """Smallest remaining deadline budget among queued requests of
        ``kind`` (None = none carries a deadline) — the early-fire
        signal the adaptive batcher acts on."""
        best = None
        for q in self._queues.values():
            for r in q:
                if r.kind == kind and r.deadline_s is not None:
                    rem = r.deadline_s - now_s
                    if best is None or rem < best:
                        best = rem
        return best

    def collect(self, max_n: int, window_s: float, stop: threading.Event,
                risk_s: float = 0.0) -> tuple:
        """Gather up to ``max_n`` same-endpoint requests for one
        micro-batch; returns ``(requests, fire_reason)``.

        Blocks until at least one live request exists (or ``stop`` is
        set, returning ``([], "stopped")``).  Selection: the oldest
        request of the lowest-rank non-empty class fixes the endpoint;
        remaining slots fill with same-endpoint requests, lower ranks
        first.  Expired requests are cancelled here and never returned.

        Fire reasons (the adaptive-dispatch decision, recorded per batch
        in the SERVE artifact):

        - ``"full"``: a full ``max_n`` is waiting — dispatch now, the
          batch cannot grow further on the warmed bucket grid.
        - ``"deadline_risk"``: some queued request's remaining budget
          dipped under ``risk_s`` (the caller's estimate of one batch
          service time plus margin) — firing later would expire it.
        - ``"window"``: the coalescing window since the first arrival
          closed without either trigger above.
        - ``"refill"``: ``window_s <= 0`` — the engine just freed with
          work already waiting, so the next micro-batch dispatches
          immediately with whatever is queued (continuous batching:
          under sustained load the window never adds latency).
        """
        deadline = None
        while not stop.is_set():
            with self._lock:
                now = mono_now_s()
                self._expire_locked(now)
                first = self._peek_locked()
                if first is not None:
                    if deadline is None:
                        deadline = now + max(0.0, window_s)
                    n_kind = self._count_kind_locked(first.kind)
                    if n_kind >= max_n:
                        return self._take_locked(first.kind, max_n), "full"
                    if risk_s > 0.0:
                        budget = self._min_budget_locked(first.kind, now)
                        # at risk = the request cannot survive waiting
                        # out the REST of the coalescing window and then
                        # one batch service time: fire now, don't let a
                        # window optimization expire a live deadline
                        if budget is not None and budget <= (
                                (deadline - now) + risk_s):
                            return (self._take_locked(first.kind, max_n),
                                    "deadline_risk")
                    if now >= deadline:
                        reason = "refill" if window_s <= 0.0 else "window"
                        return self._take_locked(first.kind, max_n), reason
                    # capped wait: queued deadlines may expire (or dip
                    # into risk) before the coalescing window closes, so
                    # re-sweep periodically
                    self._nonempty.wait(
                        timeout=max(min(deadline - now, 0.05), 0.001))
                else:
                    # empty queue: nothing to sweep, nothing to coalesce —
                    # block until a submit notifies (or stop() wakes us);
                    # an idle service must not spin.  The stop re-check
                    # HOLDS THE LOCK: stop() sets the event before wake()
                    # can acquire it, so a stop that completed between the
                    # loop-top check and here is seen now instead of its
                    # notify being lost to a waiter that hadn't waited yet
                    deadline = None
                    if stop.is_set():
                        return [], "stopped"
                    self._nonempty.wait()
        return [], "stopped"

    def _peek_locked(self):
        for name in self.policy.names():
            if self._queues[name]:
                return self._queues[name][0]
        return None

    def _count_kind_locked(self, kind: str) -> int:
        return sum(1 for q in self._queues.values() for r in q
                   if r.kind == kind)

    def _take_locked(self, kind: str, max_n: int) -> list:
        from csmom_tpu_torch.obs import metrics

        out: list = []
        for name in self.policy.names():
            q = self._queues[name]
            keep = deque()
            while q:
                r = q.popleft()
                if r.kind == kind and len(out) < max_n:
                    if r.trace is not None:
                        r.trace.mark("queue_wait")
                    out.append(r)
                else:
                    keep.append(r)
            self._queues[name] = keep
        metrics.gauge("serve.queue_depth").set(self._depth_locked())
        return out

    # ----------------------------------------------------------- terminal --

    def _terminate_locked(self, req: Request, state: str,
                          result=None, error: str | None = None) -> bool:
        """The single guarded terminal transition.  Increments the
        terminal counters (global + per class) and resolves any coalesced
        followers — all inside the exactly-once guard, so neither the
        leader nor a follower can be double-counted."""
        if req.state in TERMINAL_STATES:
            return False  # exactly-once: a terminal request never moves
        req.state = state
        req.result = result
        if error is not None:
            req.error = error
        req.t_done_s = mono_now_s()
        self._bump_class_locked(req.priority, state)
        if state == "served":
            self.served += 1
            if req.service_s is not None:
                ema = self._ema_per_req_s
                self._ema_per_req_s = (
                    req.service_s if ema is None
                    else 0.8 * ema + 0.2 * req.service_s)
        elif state == "expired":
            self.expired += 1
        else:
            self.rejected += 1
        if req.trace is not None:
            # the trace closes inside the SAME exactly-once guard as the
            # request: one complete (served) or one reasoned partial per
            # admitted request — the closed-trace-books contract.  The
            # residual auto-labels as the stage after the last mark
            # (queued -> queue_wait, post-dispatch -> serialize).
            req.trace.close(state, reason=req.error)
        req._done.set()
        # coalesced followers ride the leader's fate: served with the
        # same result, or rejected with the leader's outcome as reason.
        # The deadline contract survives coalescing: a follower whose
        # own deadline had already passed when the shared dispatch BEGAN
        # expires (the same never-dispatch-expired rule the deques
        # enforce); one whose dispatch began in time is served even if
        # it finishes late (the work was already spent — shared or not).
        if req.followers:
            followers, req.followers = req.followers, []
            for f in followers:
                if f.state in TERMINAL_STATES:
                    continue  # defensive; a follower is only ever ours
                if state == "served" and f.expired_at(
                        req.t_dispatch_s if req.t_dispatch_s is not None
                        else req.t_done_s):
                    f.state = "expired"
                    f.error = ("deadline expired before the coalesced "
                               "dispatch began (never dispatched)")
                    self.expired += 1
                    self._bump_class_locked(f.priority, "expired")
                elif state == "served":
                    f.state = "served"
                    # mutable dict payloads are copied per waiter so no
                    # coalesced caller can edit what another one reads
                    # (ndarray payloads arrive frozen from the dispatch)
                    f.result = (dict(result) if isinstance(result, dict)
                                else result)
                    # the leader's dispatch served the follower too: its
                    # timeline shares the dispatch instant
                    f.t_dispatch_s = req.t_dispatch_s
                    self.served += 1
                    self.served_coalesced += 1
                    self._bump_class_locked(f.priority, "served")
                else:
                    f.state = "rejected"
                    f.error = (f"coalesced onto request "
                               f"{req.req_id} which ended {state}"
                               + (f": {error}" if error else ""))
                    self.rejected += 1
                    self.rejected_coalesced += 1
                    self._bump_class_locked(f.priority, "rejected")
                if f.trace is not None:
                    # a follower never queued or dispatched: its whole
                    # wall is the shared wait, labeled coalesce
                    f.trace.set(coalesced=True).close(
                        f.state, reason=f.error, stage="coalesce")
                f.t_done_s = req.t_done_s
                f._done.set()
        return True

    def _bump_class_locked(self, class_name: str, state: str) -> None:
        book = self.by_class.get(class_name)
        if book is not None:
            book[state] += 1

    def finish_expired(self, req: Request,
                       error: str = "deadline expired while queued "
                                    "(never dispatched)") -> None:
        """Expire a request OUTSIDE the collect sweep — the dispatch
        boundary's last-instant check (a deadline can pass in the gap
        between collection and dispatch; the contract is enforced at the
        boundary, not hoped about)."""
        with self._lock:
            self._terminate_locked(req, "expired", error=error)

    def mark_dispatched(self, req: Request, now_s: float) -> None:
        with self._lock:
            req.state = "dispatched"
            req.t_dispatch_s = now_s
            if req.expired_at(now_s):
                # structurally unreachable (collect sweeps, then the
                # dispatch boundary re-checks); counted so the artifact's
                # expired_dispatched == 0 is a measurement, not a hope
                self.expired_dispatched += 1

    def finish_served(self, req: Request, result) -> None:
        with self._lock:
            self._terminate_locked(req, "served", result=result)

    def reject_at_door(self, req: Request, error: str,
                       version_skew: bool = False) -> None:
        """Present-and-reject in one step (unserveable shape/endpoint, or
        a skewed live-panel version): the request still counts toward
        ``admitted`` so the accounting equation closes over door
        rejections too."""
        cls = self.policy.resolve(req.priority)
        req.priority = cls.name
        with self._lock:
            self.admitted += 1
            self.by_class[cls.name]["admitted"] += 1
            req.t_submit_s = mono_now_s()
            if self._terminate_locked(req, "rejected", error=error):
                if version_skew:
                    self.rejected_version_skew += 1
                else:
                    self.rejected_unserveable += 1

    def finish_rejected(self, req: Request, error: str,
                        worker_crash: bool = False) -> None:
        with self._lock:
            if self._terminate_locked(req, "rejected", error=error):
                if worker_crash:
                    self.rejected_worker_crash += 1
                else:
                    self.rejected_unserveable += 1

    # --------------------------------------------------------- accounting --

    def wake(self) -> None:
        """Nudge a collect() blocked on the condition (shutdown path)."""
        with self._lock:
            self._nonempty.notify_all()

    def accounting(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "served": self.served,
                "rejected": self.rejected,
                "expired": self.expired,
                "expired_dispatched": self.expired_dispatched,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_worker_crash": self.rejected_worker_crash,
                "rejected_unserveable": self.rejected_unserveable,
                "rejected_version_skew": self.rejected_version_skew,
                "rejected_quota": self.rejected_quota,
                "rejected_coalesced": self.rejected_coalesced,
                "served_cache_hits": self.served_cache_hits,
                "served_coalesced": self.served_coalesced,
                "in_queue": self._depth_locked(),
            }

    def class_accounting(self) -> dict:
        """Per-class books (class name -> closed terminal counters)."""
        with self._lock:
            return {name: dict(book)
                    for name, book in self.by_class.items()}

    def invariant_violations(self) -> list:
        """The closed-accounting check (empty = holds).  Valid once the
        queue is drained: every admitted request must sit in exactly one
        terminal bucket — globally and inside every class book."""
        a = self.accounting()
        classes = self.class_accounting()
        out = []
        if a["in_queue"]:
            out.append(f"queue not drained: {a['in_queue']} still queued")
        total = a["served"] + a["rejected"] + a["expired"]
        if total != a["admitted"]:
            out.append(
                f"request accounting broken: served {a['served']} + "
                f"rejected {a['rejected']} + expired {a['expired']} = "
                f"{total} != admitted {a['admitted']}"
            )
        if a["expired_dispatched"]:
            out.append(
                f"{a['expired_dispatched']} request(s) dispatched after "
                "their deadline — expiry-while-queued must cancel, "
                "never dispatch"
            )
        for name, book in classes.items():
            ct = book["served"] + book["rejected"] + book["expired"]
            if ct != book["admitted"]:
                out.append(
                    f"class {name!r} book broken: served {book['served']} "
                    f"+ rejected {book['rejected']} + expired "
                    f"{book['expired']} = {ct} != admitted "
                    f"{book['admitted']}"
                )
        for key in ("admitted", "served", "rejected", "expired"):
            csum = sum(book[key] for book in classes.values())
            if csum != a[key]:
                out.append(
                    f"class books do not sum to the global book: "
                    f"sum({key}) = {csum} != {a[key]}"
                )
        return out
