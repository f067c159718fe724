"""Per-request tracing: stage clocks, closed trace books, the TRACE artifact.

Counterpart of ``csmom_tpu.obs.trace``, copied.  A :class:`TraceContext`
is minted at admission (trace id, endpoint, SLO class, panel version)
and threaded through the request path: admission queue, adaptive
batcher, engine dispatch, result fan-out.  Stage clocks are telescoping
monotonic marks (one ``mono_now_s()`` stamp per stage boundary), so the
per-stage walls sum to the request wall by construction::

    admit -> queue_wait -> coalesce -> pad -> dispatch -> serialize

and the pool and the fabric add the router-side half across the
process boundary (``serve/proto.py`` frames carry the context)::

    route -> connect -> send -> recv_wait -> <worker half> -> finalize

where the wire wall (``connect``, ``send``, ``recv_wait``) is also
aggregated as the derived ``transport`` stage.

Closed trace books: every request a book opened ends in exactly one
``complete`` (served) or one ``partial`` (rejected / expired / crashed,
closed with the reason); a dispatch whose worker or router replica died
before replying is an orphan half, closed with the connection failure
as its reason.  :meth:`TraceBook.invariant_violations` is the check,
and the ``trace`` kind of :mod:`csmom_tpu_torch.chaos.invariants` holds
the artifact to the run's request books.

Zero-cost disarmed: with no book armed, :func:`begin` returns one shared
no-op singleton and every mark or close is a method call on it.  The
service calls :func:`begin` and :func:`note_batch` on every request;
``loadgen --trace`` (:mod:`csmom_tpu_torch.cli.serve`) and a router
replica's ``--trace`` arm a book.

Stdlib-only and ``mono_now_s``-only: one clock rules deadlines, recorded
latencies and the trace decomposition.
"""

from __future__ import annotations

import heapq
import itertools
import math
import os
import random
import threading

from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = [
    "EPSILON_MS",
    "SCHEMA_VERSION",
    "STAGES",
    "TRANSPORT_SUBSTAGES",
    "TraceBook",
    "TraceContext",
    "arm_tracing",
    "begin",
    "build_artifact",
    "current_book",
    "disarm_tracing",
    "note_batch",
    "tracing_armed",
]

SCHEMA_VERSION = 1

# the canonical stage vocabulary, in request-path order.  The router-side
# stages (route/connect/send/recv_wait/finalize) only appear on
# stitched traces of a multi-process tier.  The mesh engine's shard
# placement rides as trace attrs (``mesh_devices``, ``mesh_shards``) set
# at the dispatch stage: the shards of one dispatch are one engine call,
# not a separable wall.  The wire wall is three
# telescoping sub-stages, ``connect`` (channel acquisition), ``send``
# (frame written) and ``recv_wait`` (reply wall minus the peer's own
# reported wall); the book aggregates their per-trace sum under the
# derived ``transport`` stage, which is in no trace's telescoping chain,
# and a half that recorded one flat ``transport`` stage stitches as is.
STAGES = ("admit", "queue_wait", "coalesce", "pad", "dispatch",
          "serialize", "route", "connect", "send", "recv_wait",
          "transport", "finalize")

# the wire sub-stages whose per-trace sum IS the derived transport wall
TRANSPORT_SUBSTAGES = ("connect", "send", "recv_wait")

# the auto-label for the residual a close() stamps: the stage that FOLLOWS
# the last recorded mark (a request rejected while queued closes its
# residual as queue_wait, a crash after pad closes it as dispatch, a
# served dispatch closes it as serialize)
_NEXT_STAGE = {
    None: "admit",
    "admit": "queue_wait",
    "queue_wait": "coalesce",
    "coalesce": "pad",
    "pad": "dispatch",
    "dispatch": "serialize",
    "serialize": "finalize",
}

# reconciliation tolerance: stage sums telescope exactly in float64, so
# the only residual is serialization rounding (6 decimals) — 2 ms is two
# orders of magnitude of headroom and still far under any stage wall
EPSILON_MS = 2.0

# bounded per-stage / per-class sample reservoirs (the artifact's CI
# backing); slowest-k critical paths kept for the decomposition CLI
_RESERVOIR_CAP = 256
_SLOWEST_K = 8

_TRACE_IDS = itertools.count(1)

# the armed book, or None.  Module-global on purpose (the spans
# discipline): begin() disarmed must cost one global load + compare.
_BOOK = None


class _NullTrace:
    """The disarmed trace: one shared instance, every method a no-op."""

    __slots__ = ()

    live = False      # call sites skip per-request trace work entirely

    def mark(self, stage):
        return self

    def set(self, **attrs):
        return self

    def note_orphan(self, worker_id, reason):
        return self

    def absorb_remote(self, half, t_start_s, t_end_s, worker_id=None,
                      t_acquired_s=None, t_sent_s=None):
        return self

    def close(self, outcome, reason=None, stage=None):
        return self

    def close_routed(self, outcome, t_done_s, reason=None):
        return self

    def to_wire(self):
        return None

    def half_record(self):
        return None


_NULL_TRACE = _NullTrace()


class TraceContext:
    """One request's trace: identity, stage marks, outcome.

    Not a general-purpose span tree — a straight-line stage chain sized
    for the serve request path, cheap enough to mint per request.  Marks
    are appended from the submit thread and then the dispatch thread; the
    queue's exactly-once terminal transition is the only closer, so no
    lock is needed on the chain itself.
    """

    __slots__ = ("trace_id", "endpoint", "slo_class", "panel_version",
                 "budget_ms", "t0_s", "marks", "attrs", "orphans",
                 "outcome", "reason", "stage_durs_s", "wall_s",
                 "_remote", "_book", "_olock")

    live = True

    def __init__(self, endpoint: str, slo_class: str,
                 panel_version: int | None = None,
                 budget_ms: float | None = None,
                 trace_id: str | None = None, book=None):
        if trace_id is None:
            trace_id = f"t{os.getpid()}-{next(_TRACE_IDS):06d}"
        self.trace_id = trace_id
        self.endpoint = endpoint
        self.slo_class = slo_class
        self.panel_version = panel_version
        self.budget_ms = budget_ms
        self.t0_s = mono_now_s()
        self.marks: list = []          # [(stage, t_s)], telescoping
        self.attrs: dict = {}
        self.orphans: list = []        # [(worker_id, reason)], pool halves
        self.outcome: str | None = None
        self.reason: str | None = None
        self.stage_durs_s: dict | None = None   # set at close
        self.wall_s: float | None = None
        self._remote = None            # (half, t_start, t_end, worker_id)
        self._book = book
        # guards the outcome transition vs note_orphan: a hedge loser's
        # connection failure races the winner's close on another thread
        self._olock = threading.Lock()

    # ------------------------------------------------------------- marks --

    def mark(self, stage: str):
        """Stamp one stage boundary (duration = delta to the previous
        mark, so stage walls telescope to the request wall)."""
        self.marks.append((stage, mono_now_s()))
        return self

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def note_orphan(self, worker_id: str | None, reason: str):
        """A dispatch half that will never be stitched: the peer died (or
        reset) before replying.  Recorded with the reason so the book can
        close the orphan ledger instead of losing the attempt.  A hedge
        loser that fails AFTER the request already closed still reaches
        the book directly — late orphans must not leak either.  The
        check-then-append runs under ``_olock`` (the same lock ``_finish``
        sets the outcome under): an orphan noted concurrently with the
        winning attempt's close must land either in ``orphans`` before
        the book snapshots it or in ``record_orphan`` — never nowhere."""
        wid = worker_id or "?"
        why = str(reason)[:160]
        with self._olock:
            if self.outcome is None:
                self.orphans.append((wid, why))
                return self
        if self._book is not None:
            self._book.record_orphan(wid, why)
        return self

    def absorb_remote(self, half: dict, t_start_s: float, t_end_s: float,
                      worker_id: str | None = None,
                      t_acquired_s: float | None = None,
                      t_sent_s: float | None = None):
        """Attach the worker's reply half (the server-side stage chain)
        plus the client-observed attempt window, for close-time
        stitching.  ``t_acquired_s`` / ``t_sent_s`` are the channel
        layer's marks (channel in hand; frame fully written) — when
        present, close-time stitching splits the wire wall into
        connect / send / recv_wait instead of one flat ``transport``.
        Last write wins — only the winning attempt's absorb survives to
        the terminal transition."""
        self._remote = (half, t_start_s, t_end_s, worker_id,
                        t_acquired_s, t_sent_s)
        return self

    # ------------------------------------------------------------- close --

    def close(self, outcome: str, reason: str | None = None,
              stage: str | None = None):
        """Terminal transition (exactly-once: a closed trace never moves).

        The residual since the last mark lands under ``stage`` (default:
        the stage that follows the last mark — see ``_NEXT_STAGE``).
        ``complete`` iff ``outcome == "served"``; anything else is a
        partial and MUST carry a reason (the closed-books contract).
        """
        if self.outcome is not None:
            return self
        last = self.marks[-1][0] if self.marks else None
        self.mark(stage or _NEXT_STAGE.get(last, "finalize"))
        self._finish(outcome, reason)
        return self

    def close_routed(self, outcome: str, t_done_s: float,
                     reason: str | None = None):
        """The router's stitched close: build the full chain from the
        client-observed window plus the absorbed worker half.

        ``route`` covers submit -> winning-attempt start; the wire wall
        (attempt wall minus the worker's own reported wall) lands as
        the channel marks allow — split into ``connect`` (channel
        acquired) / ``send`` (frame written) / ``recv_wait`` (the
        remainder) when the pooled transport reported its marks, or as
        one flat ``transport`` stage for a markless attempt;
        the worker's stages ride verbatim in between, and ``finalize``
        covers the reply's fan-back — so the sum telescopes to the
        router-observed request wall exactly.  Without an absorbed half
        (every attempt failed, or the request never dispatched) the
        whole wall lands under ``route`` with the reason.
        """
        if self.outcome is not None:
            return self
        durs: dict = {}
        if self._remote is not None:
            half, t_start, t_end, worker_id, t_acq, t_sent = self._remote
            server = dict((half or {}).get("stages") or {})
            server_wall = sum(server.values())
            durs["route"] = max(0.0, t_start - self.t0_s)
            if t_acq is not None and t_sent is not None:
                # the channel marks split the wire wall (attempt window
                # minus the peer's own reported wall) into connect /
                # send / recv_wait.  The wire wall is authoritative;
                # the marks are stamps from ANOTHER thread's schedule
                # and can skew a few ms late under load, so connect and
                # send are clamped INTO the available wire wall (skew
                # lands in the stage whose stamp drifted, and the sum
                # still telescopes to the request wall exactly)
                wire_s = max(0.0, (t_end - t_start) - server_wall)
                connect_s = min(max(0.0, t_acq - t_start), wire_s)
                send_s = min(max(0.0, t_sent - t_acq),
                             wire_s - connect_s)
                durs["connect"] = connect_s
                durs["send"] = send_s
                for k, v in server.items():
                    durs[k] = durs.get(k, 0.0) + v
                durs["recv_wait"] = (durs.get("recv_wait", 0.0)
                                     + (wire_s - connect_s - send_s))
            else:
                durs["transport"] = max(0.0,
                                        (t_end - t_start) - server_wall)
                for k, v in server.items():
                    durs[k] = durs.get(k, 0.0) + v
            durs["finalize"] = durs.get("finalize", 0.0) + max(
                0.0, t_done_s - t_end)
            if worker_id is not None:
                self.attrs.setdefault("worker", worker_id)
            for k, v in ((half or {}).get("attrs") or {}).items():
                self.attrs.setdefault(k, v)
        else:
            durs["route"] = max(0.0, t_done_s - self.t0_s)
        self.stage_durs_s = durs
        self.wall_s = max(0.0, t_done_s - self.t0_s)
        self._finish(outcome, reason, prebuilt=True)
        return self

    def _finish(self, outcome: str, reason: str | None,
                prebuilt: bool = False) -> None:
        # the outcome flip is the linearization point note_orphan races
        # against: after the lock releases, late orphans go straight to
        # the book, and the record() below reads a stable orphans list
        with self._olock:
            self.outcome = outcome
        if reason is not None:
            self.reason = str(reason)[:200]
        if not prebuilt:
            durs: dict = {}
            prev = self.t0_s
            for stage, t in self.marks:
                durs[stage] = durs.get(stage, 0.0) + max(0.0, t - prev)
                prev = t
            self.stage_durs_s = durs
            self.wall_s = max(0.0, (self.marks[-1][1] if self.marks
                                    else self.t0_s) - self.t0_s)
        if self._book is not None:
            self._book.record(self)

    # -------------------------------------------------------------- wire --

    def to_wire(self) -> dict:
        """The context fields that cross the proto boundary (the frame
        header's ``trace`` entry) — identity only, never timing: each
        side's clocks stay local and stitching works on durations."""
        return {
            "trace_id": self.trace_id,
            "endpoint": self.endpoint,
            "slo_class": self.slo_class,
            "panel_version": self.panel_version,
            "budget_ms": self.budget_ms,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "TraceContext":
        """Rebuild the server-side half of a wire-carried context.  The
        request said "trace me", so the half exists even in a process
        with no armed book — its record rides back in the reply frame."""
        return cls(
            endpoint=str(d.get("endpoint")),
            slo_class=str(d.get("slo_class")),
            panel_version=d.get("panel_version"),
            budget_ms=d.get("budget_ms"),
            trace_id=str(d.get("trace_id")),
        )

    def half_record(self) -> dict | None:
        """This (closed) context as a reply-frame half: the server-side
        stage chain the router stitches.  None until closed — a torn half
        must not be mistaken for a measured one."""
        if self.outcome is None or self.stage_durs_s is None:
            return None
        return {
            "trace_id": self.trace_id,
            "outcome": self.outcome,
            "stages": {k: round(v, 6)
                       for k, v in self.stage_durs_s.items()},
            "wall_s": round(self.wall_s or 0.0, 6),
            "attrs": dict(self.attrs),
        }


class _Reservoir:
    """Bounded uniform sample reservoir (algorithm R), seeded for
    reproducible committed artifacts.  ``samples`` emits the surviving
    subset in ARRIVAL order — the same contract as loadgen's
    ``_bounded_samples`` (sorted index subsample): the ledger feeds
    these to the block bootstrap, which assumes consecutive samples
    share state, so overwriting random slots must not shuffle early
    observations after late ones."""

    __slots__ = ("cap", "n", "_pairs", "_rng")

    def __init__(self, cap: int = _RESERVOIR_CAP, seed: int = 0):
        self.cap = cap
        self.n = 0
        self._pairs: list = []          # [(arrival_seq, value)]
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.n += 1
        if len(self._pairs) < self.cap:
            self._pairs.append((self.n, v))
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self._pairs[j] = (self.n, v)

    @property
    def samples(self) -> list:
        return [v for _, v in sorted(self._pairs)]


def _percentiles_ms(samples: list) -> dict:
    """Nearest-rank p50/p95/p99 in ms (the loadgen rule, shared shape)."""
    if not samples:
        return {"p50": None, "p95": None, "p99": None}
    s = sorted(samples)

    def pick(q):
        return round(1e3 * s[max(0, math.ceil(q * len(s)) - 1)], 3)

    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


class TraceBook:
    """Aggregates every trace of one run into closed books.

    Thread-safe (one leaf lock; never calls out while holding it — the
    lock-order audit stays acyclic).  Holds bounded state only: stage
    reservoirs, per-class reservoirs, a slowest-k heap, counters — a
    million-request run costs the same memory as a thousand-request one.
    """

    def __init__(self, slo_target: float = 0.99, seed: int = 0):
        self.slo_target = float(slo_target)
        self._lock = threading.Lock()
        self._seed = seed
        self.opened = 0
        self.complete = 0
        self.partial = 0
        self.partial_reasons: dict = {}
        self.orphan_halves = 0
        self.orphan_reasons: dict = {}
        self._stage_res: dict = {}          # stage -> _Reservoir (seconds)
        self._stage_tot: dict = {}          # stage -> [count, total, max]
        self._class_res: dict = {}          # class -> _Reservoir (seconds)
        self._class_book: dict = {}         # class -> {count, served,
        #                                     violations, budget_ms}
        self._slowest: list = []            # min-heap of (wall, seq, entry)
        self._slow_seq = itertools.count()
        self._buckets: dict = {}            # (kind, B, A) -> pad book
        self.reconcile_checked = 0
        self.reconcile_violations = 0
        self.max_abs_residual_ms = 0.0

    # ------------------------------------------------------------ feeding --

    def open_trace(self, ctx: TraceContext) -> TraceContext:
        with self._lock:
            self.opened += 1
        ctx._book = self
        return ctx

    def record(self, ctx: TraceContext) -> None:
        """Fold one CLOSED trace into the books (called from the trace's
        terminal transition, exactly once by its guard)."""
        durs = ctx.stage_durs_s or {}
        wall = ctx.wall_s or 0.0
        residual_ms = abs(sum(durs.values()) - wall) * 1e3
        entry = None
        if ctx.outcome == "served":
            entry = {
                "trace_id": ctx.trace_id,
                "endpoint": ctx.endpoint,
                "class": ctx.slo_class,
                "wall_ms": round(wall * 1e3, 3),
                "stages": {k: round(v * 1e3, 3) for k, v in durs.items()},
                "attrs": dict(ctx.attrs),
            }
        # the derived transport wall: the sub-stage sum of a
        # channel-stitched trace, aggregated under "transport", never
        # written into the trace's own telescoping chain (stage sums
        # must still reconcile with the request wall)
        fold = dict(durs)
        if "transport" not in fold:
            sub = [fold[k] for k in TRANSPORT_SUBSTAGES if k in fold]
            if sub:
                fold["transport"] = sum(sub)
        with self._lock:
            if ctx.outcome == "served":
                self.complete += 1
                for stage, d in fold.items():
                    res = self._stage_res.get(stage)
                    if res is None:
                        res = self._stage_res[stage] = _Reservoir(
                            seed=self._seed + len(self._stage_res))
                        self._stage_tot[stage] = [0, 0.0, 0.0]
                    res.add(d)
                    tot = self._stage_tot[stage]
                    tot[0] += 1
                    tot[1] += d
                    tot[2] = max(tot[2], d)
                cres = self._class_res.get(ctx.slo_class)
                if cres is None:
                    cres = self._class_res[ctx.slo_class] = _Reservoir(
                        seed=self._seed + 101 + len(self._class_res))
                cres.add(wall)
                book = self._class_book.setdefault(ctx.slo_class, {
                    "count": 0, "served": 0, "violations": 0,
                    "budget_ms": ctx.budget_ms,
                })
                book["count"] += 1
                book["served"] += 1
                if book["budget_ms"] is None:
                    book["budget_ms"] = ctx.budget_ms
                if (ctx.budget_ms is not None
                        and wall * 1e3 > ctx.budget_ms):
                    book["violations"] += 1
                heapq.heappush(self._slowest,
                               (wall, next(self._slow_seq), entry))
                if len(self._slowest) > _SLOWEST_K:
                    heapq.heappop(self._slowest)
            else:
                self.partial += 1
                key = (ctx.reason or ctx.outcome or "unknown")[:80]
                self.partial_reasons[key] = \
                    self.partial_reasons.get(key, 0) + 1
                book = self._class_book.setdefault(ctx.slo_class, {
                    "count": 0, "served": 0, "violations": 0,
                    "budget_ms": ctx.budget_ms,
                })
                book["count"] += 1
            for worker_id, reason in ctx.orphans:
                self.orphan_halves += 1
                key = f"{worker_id}: {reason}"[:120]
                self.orphan_reasons[key] = \
                    self.orphan_reasons.get(key, 0) + 1
            self.reconcile_checked += 1
            self.max_abs_residual_ms = max(self.max_abs_residual_ms,
                                           residual_ms)
            if residual_ms > EPSILON_MS:
                self.reconcile_violations += 1

    def record_orphan(self, worker_id: str, reason: str) -> None:
        """A late orphan half (the owning trace already closed)."""
        with self._lock:
            self.orphan_halves += 1
            key = f"{worker_id}: {reason}"[:120]
            self.orphan_reasons[key] = self.orphan_reasons.get(key, 0) + 1

    def note_batch(self, kind: str, batch_bucket: int, asset_bucket: int,
                   used_lanes: int, pad_lanes: int,
                   fire_reason: str) -> None:
        """One dispatched micro-batch's padding record, keyed by its
        bucket — the goodput-per-bucket book the CLI renders."""
        with self._lock:
            b = self._buckets.setdefault((kind, batch_bucket, asset_bucket), {
                "batches": 0, "used_lanes": 0, "pad_lanes": 0,
                "fire_reasons": {},
            })
            b["batches"] += 1
            b["used_lanes"] += used_lanes
            b["pad_lanes"] += pad_lanes
            b["fire_reasons"][fire_reason] = \
                b["fire_reasons"].get(fire_reason, 0) + 1

    # ----------------------------------------------------------- reading --

    def invariant_violations(self) -> list:
        """The closed-trace-books check (empty = holds)."""
        with self._lock:
            out = []
            if self.complete + self.partial != self.opened:
                out.append(
                    f"trace books broken: complete {self.complete} + "
                    f"partial {self.partial} = "
                    f"{self.complete + self.partial} != opened "
                    f"{self.opened} — a request's trace never closed")
            if self.reconcile_violations:
                out.append(
                    f"{self.reconcile_violations} trace(s) whose stage "
                    f"walls do not sum to the request wall within "
                    f"{EPSILON_MS} ms (max residual "
                    f"{self.max_abs_residual_ms:.3f} ms)")
            return out

    def snapshot(self) -> dict:
        """The books as one JSON-ready dict (the TRACE artifact's core)."""
        with self._lock:
            stages = {}
            for stage, res in self._stage_res.items():
                count, total, mx = self._stage_tot[stage]
                stages[stage] = {
                    "count": count,
                    "total_s": round(total, 6),
                    "max_ms": round(mx * 1e3, 3),
                    **_percentiles_ms(res.samples),
                }
            from csmom_tpu_torch.obs.metrics import budget_burn

            classes = {}
            for name, book in self._class_book.items():
                res = self._class_res.get(name)
                lat = _percentiles_ms(res.samples if res else [])
                burn = budget_burn(book["served"], book["violations"],
                                   self.slo_target)
                classes[name] = {
                    **book,
                    "latency_ms": lat,
                    "slo_target": self.slo_target,
                    "budget_burn": burn,
                }
            slowest = [e for _, _, e in
                       sorted(self._slowest, key=lambda t: -t[0])]
            padding = {
                f"{k}:b{B}xa{A}": dict(v, pad_fraction=round(
                    v["pad_lanes"]
                    / max(1, v["pad_lanes"] + v["used_lanes"]), 4))
                for (k, B, A), v in sorted(self._buckets.items())
            }
            return {
                "books": {
                    "opened": self.opened,
                    "complete": self.complete,
                    "partial": self.partial,
                    "partial_reasons": dict(sorted(
                        self.partial_reasons.items())),
                },
                "orphans": {
                    "count": self.orphan_halves,
                    "reasons": dict(sorted(self.orphan_reasons.items())),
                },
                "stages": stages,
                "classes": classes,
                "slowest": slowest,
                "padding": padding,
                "reconcile": {
                    "checked": self.reconcile_checked,
                    "violations": self.reconcile_violations,
                    "max_abs_residual_ms": round(
                        self.max_abs_residual_ms, 4),
                    "epsilon_ms": EPSILON_MS,
                },
            }

    def stage_samples_ms(self) -> dict:
        """Bounded per-stage reservoir samples in ms, keyed by the ledger
        metric each backs — future TRACE rows get bootstrap CIs instead
        of point-delta verdicts."""
        with self._lock:
            return {
                f"trace_stage_{stage}_p99_ms": [
                    round(v * 1e3, 4) for v in res.samples]
                for stage, res in self._stage_res.items()
            }


# ------------------------------------------------------------- frontend ----

def tracing_armed() -> bool:
    return _BOOK is not None


def current_book() -> TraceBook | None:
    return _BOOK


def arm_tracing(book: TraceBook | None = None, **kwargs) -> TraceBook:
    """Arm request tracing for this process; returns the book.  Re-arming
    replaces the previous book (its traces stay with it)."""
    global _BOOK
    _BOOK = book if book is not None else TraceBook(**kwargs)
    return _BOOK


def disarm_tracing() -> None:
    """Drop the armed book: ``begin()`` returns the shared no-op again."""
    global _BOOK
    _BOOK = None


def begin(endpoint: str, slo_class: str, panel_version: int | None = None,
          budget_ms: float | None = None):
    """Mint a trace context (disarmed: the shared no-op singleton, no
    allocation, no clock read)."""
    book = _BOOK
    if book is None:
        return _NULL_TRACE
    return book.open_trace(TraceContext(
        endpoint, slo_class, panel_version=panel_version,
        budget_ms=budget_ms))


def note_batch(kind: str, batch_bucket: int, asset_bucket: int,
               used_lanes: int, pad_lanes: int, fire_reason: str) -> None:
    """Record one micro-batch's padding record (disarmed: a no-op)."""
    book = _BOOK
    if book is None:
        return
    book.note_batch(kind, batch_bucket, asset_bucket, used_lanes,
                    pad_lanes, fire_reason)


# ------------------------------------------------------------- artifact ----

def build_artifact(book: TraceBook, run_id: str,
                   requests: dict | None = None,
                   fresh_compiles=None,
                   platform: str | None = None,
                   workload: str | None = None,
                   extra: dict | None = None) -> dict:
    """The TRACE artifact (kind ``trace``, schema v1): closed trace books
    + per-stage decomposition + per-class burn + padding goodput, plus
    the matching serve run's request book so the two ledgers reconcile
    BY SCHEMA (``complete == served``, ``partial == rejected +
    expired``)."""
    snap = book.snapshot()
    ex = {
        "platform": platform,
        "workload": workload,
        "samples": book.stage_samples_ms(),
        **(extra or {}),
    }
    return {
        "kind": "trace",
        "schema_version": SCHEMA_VERSION,
        "run_id": run_id,
        "metric": "trace_complete_traces",
        "value": snap["books"]["complete"],
        "unit": "traces",
        "vs_baseline": 1.0,
        **snap,
        "requests": dict(requests) if requests else None,
        "compile": {
            "in_window_fresh_compiles": fresh_compiles,
            "note": "copied from the driven serve run: the trace window "
                    "IS the serving window, so 0 here means the "
                    "decomposition never includes a fresh compile",
        },
        "extra": ex,
    }
