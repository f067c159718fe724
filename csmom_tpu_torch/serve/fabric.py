"""The serving fabric: three supervised process tiers.

Counterpart of ``csmom_tpu.serve.fabric``.  The pool's router becomes
its own supervised, replicated process tier, every hop can speak tcp,
and the tiers share one admission view through a published routes
file::

    loadgen / client tier          FabricClient (this module)
        |  tcp/unix, framed proto      |  round robin + failover
    router tier (>= 2 replicas)    python -m csmom_tpu_torch.serve.router
        |  consistent hash on the      |  hedged retries, fair gate
        |  result-cache key            |
    worker tier (N processes)      python -m csmom_tpu_torch.serve.worker

- **Routes file** (:func:`write_routes`, :class:`RoutesView`): the
  worker supervisor's state (which workers are ready, at which
  addresses, and the backoff hint for a fleet with none ready) as one
  atomically replaced JSON file.  Every replica re-reads it when its
  signature moves, so all replicas route from the same view with no
  replica-to-replica protocol.
- **RoutesPublisher**: the thread that watches a
  :class:`~csmom_tpu_torch.serve.supervisor.PoolSupervisor` and writes
  the routes file when the fleet changes.
- **RouterSupervisor**: the worker supervisor's machinery (spawn,
  demonstrated ready, backoff restarts, crash-loop parking, rolling
  restarts) pointed at router-replica processes through its two hooks,
  ``_slot_argv`` and ``_slot_address``.
- **FabricClient**: the client tier.  It submits to whichever replica is
  ready, fails over on a reset or draining replica (a router SIGKILLed
  mid-burst costs its in-flight requests one retry on a survivor), and
  keeps closed client books (served + rejected + expired == admitted),
  the fabric's outermost ledger, the one a dead replica cannot take
  with it.

Router replicas and the client hold no compute: stdlib and numpy only,
no torch in any fabric-control process; the workers score on the card.
``build_fabric(fleet_config=...)`` attaches the elastic tier (hot spares,
the prefork warm path, the autoscaler:
:class:`~csmom_tpu_torch.serve.fleet.FleetController`) to the worker
supervisor, and the client notes each request's demand for the fleet
observatory (:mod:`csmom_tpu_torch.obs.fleet`).  Clock discipline:
``mono_now_s`` only.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import threading

import numpy as np

from csmom_tpu_torch.serve import proto
from csmom_tpu_torch.serve.router import (
    TERMINAL_STATES,
    _TERMINAL_GRACE_S as _ROUTER_TERMINAL_GRACE_S,
    no_deadline_score_give_up_s,
)
from csmom_tpu_torch.serve.supervisor import PoolConfig, PoolSupervisor, \
    WorkerHandle
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["FabricClient", "FabricClientConfig", "FabricRequest",
           "RouterSupervisor", "RoutesPublisher", "RoutesView",
           "build_fabric", "kill_mid_burst", "stop_fabric",
           "write_routes"]

ROUTES_SCHEMA_VERSION = 1


# ---------------------------------------------------------------- routes ---

def write_routes(path: str, workers: list, retry_after_s: float | None,
                 cache_version: str | None = None) -> None:
    """Atomically publish the admission view: ``workers`` is a list of
    ``(worker_id, address)`` pairs (or dicts with those keys)."""
    rows = []
    for w in workers:
        if isinstance(w, dict):
            rows.append({"worker_id": w["worker_id"],
                         "addr": w["addr"]})
        else:
            rows.append({"worker_id": w[0], "addr": w[1]})
    obj = {
        "schema_version": ROUTES_SCHEMA_VERSION,
        "workers": rows,
        "retry_after_s": retry_after_s,
        "cache_version": cache_version,
    }
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


class _RouteWorker:
    """One routable worker row (duck-typed like a supervisor handle)."""

    __slots__ = ("worker_id", "socket_path")

    def __init__(self, worker_id: str, addr: str):
        self.worker_id = worker_id
        self.socket_path = addr


class RoutesView:
    """An mtime-cached reader of the published routes file.

    Every router pick calls :meth:`workers`; the file is re-parsed only
    when its mtime moved, so the per-pick cost is one ``stat``.  A
    missing or unparseable file reads as an EMPTY worker set with the
    reason carried — the router's no-worker rejection then says why.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._stat_sig: tuple | None = None
        self._workers: list = []
        self._retry_after: float | None = None
        self._cache_version: str | None = None
        self._reason: str | None = "routes file never read"

    def _refresh_locked(self) -> None:
        try:
            st = os.stat(self.path)
        except OSError as e:
            # a broken file invalidates the WHOLE view: a retry-after
            # hint or cache version surviving from the last good parse
            # would stamp outdated state onto every rejection
            self._workers = []
            self._retry_after = None
            self._cache_version = None
            self._reason = f"routes file unreadable: {e}"
            self._stat_sig = None
            return
        # mtime alone misses two publishes inside one filesystem tick;
        # the publisher lands every view via os.replace (a NEW inode),
        # so the inode is the signature that cannot lie
        sig = (st.st_mtime_ns, st.st_ino, st.st_size)
        if sig == self._stat_sig:
            return
        try:
            with open(self.path, encoding="utf-8") as f:
                obj = json.load(f)
            rows = obj.get("workers") or []
            self._workers = [_RouteWorker(str(r["worker_id"]),
                                          str(r["addr"]))
                             for r in rows]
            ra = obj.get("retry_after_s")
            self._retry_after = float(ra) if ra is not None else None
            self._cache_version = obj.get("cache_version")
            self._reason = None
            self._stat_sig = sig
        except (OSError, ValueError, KeyError, TypeError) as e:
            # a torn/garbage routes file must not crash the replica —
            # it degrades to "no workers" with the parse as the reason
            self._workers = []
            self._retry_after = None
            self._cache_version = None
            self._reason = f"routes file unparseable: {e}"
            self._stat_sig = None

    def workers(self) -> list:
        with self._lock:
            self._refresh_locked()
            return list(self._workers)

    def retry_after_s(self) -> float | None:
        with self._lock:
            self._refresh_locked()
            return self._retry_after

    def cache_version(self) -> str | None:
        with self._lock:
            self._refresh_locked()
            return self._cache_version

    def status(self) -> tuple:
        """``(ok, reason)`` — ok iff the routes file parses (an empty
        worker set is still a valid view: the fleet may be mid-restart,
        and the router's retry-after degradation handles it)."""
        with self._lock:
            self._refresh_locked()
            return self._reason is None, self._reason


class RoutesPublisher:
    """Watch a worker supervisor; republish the routes file on change.

    The published view is derived state (ready handles + backoff hint),
    so the publisher is a dumb loop: snapshot, compare, write-if-
    changed.  The retry-after hint is published only while NO worker is
    ready (it counts down continuously; publishing it while the fleet
    is healthy would churn the file every interval for nothing).
    """

    def __init__(self, supervisor: PoolSupervisor, path: str,
                 interval_s: float = 0.1):
        self.supervisor = supervisor
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last: str | None = None
        self.publishes = 0

    def publish_once(self) -> bool:
        """One snapshot → write-if-changed; returns True when written."""
        ready = self.supervisor.ready_workers()
        hint = None if ready else self.supervisor.retry_after_s()
        snapshot = json.dumps({
            "workers": sorted((h.worker_id, h.socket_path) for h in ready),
            "retry_after_s": hint,
        }, sort_keys=True)
        if snapshot == self._last:
            return False
        write_routes(self.path,
                     [(h.worker_id, h.socket_path) for h in ready],
                     hint, self.supervisor.expect_cache_version)
        self._last = snapshot
        self.publishes += 1
        return True

    def start(self) -> "RoutesPublisher":
        self.publish_once()
        self._thread = threading.Thread(target=self._loop,
                                        name="csmom-routes-publisher",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.publish_once()
            except OSError:
                pass  # a transient write failure retries next interval
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


# ------------------------------------------------------ router supervisor ---

class RouterSupervisor(PoolSupervisor):
    """The supervisor machinery pointed at router-replica processes.

    Spawn and demonstrated-ready probing (the replica's ``ready`` op
    answers once its routes file parses), backoff restarts with
    crash-loop parking, and rolling restarts that swap the routable
    handle only after the replacement answered ready are inherited from
    :class:`PoolSupervisor`; only what runs in a slot differs.
    """

    slot_prefix = "r"

    def __init__(self, config: PoolConfig, run_dir: str, routes_path: str,
                 deadline_ms: float = 500.0, hedge_fraction: float = 0.35,
                 max_attempts: int = 3, fair_slots: int = 16,
                 affinity: bool = True, trace: bool = False):
        super().__init__(config, run_dir)
        self.routes_path = routes_path
        self.deadline_ms = deadline_ms
        self.hedge_fraction = hedge_fraction
        self.max_attempts = max_attempts
        self.fair_slots = fair_slots
        self.affinity = affinity
        self.trace = trace

    def _slot_argv(self, h: WorkerHandle) -> list:
        argv = [sys.executable, "-m", "csmom_tpu_torch.serve.router",
                "--listen", h.socket_path,
                "--routes", self.routes_path,
                "--router-id", h.worker_id,
                "--profile", self.config.profile,
                "--deadline-ms", str(self.deadline_ms),
                "--hedge-fraction", str(self.hedge_fraction),
                "--max-attempts", str(self.max_attempts),
                "--fair-slots", str(self.fair_slots),
                "--expect-cache-version", self.expect_cache_version]
        if not self.affinity:
            argv.append("--no-affinity")
        if self.trace:
            argv.append("--trace")
        return argv

    def router_stats(self) -> list:
        """Per-replica stats (books, fair gate, channels, whether the
        process loaded torch); a dead or parked replica contributes its
        handle state and reason: lost books are reported, and the client
        tier's accounting is the fabric's closed ledger."""
        out = []
        for h in self.handles:
            rec = {"router_id": h.worker_id, "state": h.state,
                   "generation": h.generation, "restarts": h.restarts,
                   "addr": h.socket_path}
            if h.state == "ready":
                try:
                    obj, _ = proto.request_once(h.socket_path, {"op": "stats"},
                                           timeout_s=5.0)
                    rec.update({
                        "accounting": obj.get("accounting"),
                        "classes": obj.get("classes"),
                        "availability": obj.get("availability"),
                        "fair_gate": obj.get("fair_gate"),
                        "channels": obj.get("channels"),
                        "invariant_violations":
                            obj.get("invariant_violations"),
                        "trace": obj.get("trace"),
                        "torch_loaded": obj.get("torch_loaded"),
                    })
                except (OSError, proto.ProtocolError) as e:
                    rec["stats_error"] = f"{type(e).__name__}: {e}"[:120]
            elif h.reason:
                rec["reason"] = h.reason[:300]
            out.append(rec)
        return out


# ------------------------------------------------------ bring-up/teardown ---

def build_fabric(wcfg: PoolConfig, rcfg: PoolConfig, run_dir: str, *,
                 deadline_ms: float, hedge_fraction: float = 0.35,
                 trace: bool = False, publisher_interval_s: float = 0.05,
                 client_deadline_s: float | None = None,
                 configure_router=None, fleet_config=None):
    """The three-tier bring-up, in the one order that works: the worker
    supervisor first (the fleet the view describes), the routes
    publisher (the view every replica reads), the router supervisor (the
    replicas dial workers through the view), the fabric client last.

    ``rcfg.expect_cache_version`` is threaded from the live worker
    supervisor (the caller cannot know it before the workers exist).
    ``configure_router(rsup)`` runs after the router supervisor is built
    and before its replicas spawn (where a caller configures the replica
    tier alone, such as a chaos plan scoped to the replicas' dials).  A
    failed router start stops the tiers already running before the
    error propagates.  Tear down with :func:`stop_fabric`.  Returns
    ``(wsup, publisher, rsup, client)``.

    ``fleet_config`` (a :class:`~csmom_tpu_torch.serve.fleet.FleetConfig`)
    arms the elastic tier: hot spares, the prefork warm path and the
    autoscaler attach to the worker supervisor as ``wsup.fleet`` after
    the routes publisher exists (a promotion is a routes publish away),
    reading the armed fleet aggregator's demand, and stop first on
    teardown.  ``trace`` arms each router replica's own trace book
    (``--trace``); its snapshot rides the replica's ``stats`` reply into
    the fabric artifact's replica rows.
    """
    wsup = PoolSupervisor(wcfg, os.path.join(run_dir, "workers"))
    os.makedirs(wsup.run_dir, exist_ok=True)
    wsup.start()
    # from here every failure must stop the tiers already running: the
    # caller's locals are unassigned until we return, so a leak here is
    # a leak for the rest of the process
    publisher = rsup = None
    try:
        routes_path = os.path.join(run_dir, "routes.json")
        publisher = RoutesPublisher(wsup, routes_path,
                                    interval_s=publisher_interval_s).start()
        if fleet_config is not None and (
                fleet_config.spares > 0 or fleet_config.autoscale
                or fleet_config.prefork):
            from csmom_tpu_torch.obs import fleet as obs_fleet
            from csmom_tpu_torch.serve.fleet import FleetController

            FleetController(
                wsup, fleet_config, publisher=publisher,
                aggregator=obs_fleet.current_aggregator()).start()
        rcfg = dataclasses.replace(
            rcfg, expect_cache_version=wsup.expect_cache_version)
        rsup = RouterSupervisor(rcfg, os.path.join(run_dir, "routers"),
                                routes_path, deadline_ms=deadline_ms,
                                hedge_fraction=hedge_fraction, trace=trace)
        os.makedirs(rsup.run_dir, exist_ok=True)
        if configure_router is not None:
            configure_router(rsup)
        rsup.start()
        client = FabricClient(rsup.ready_workers, FabricClientConfig(
            default_deadline_s=client_deadline_s))
    except Exception:
        stop_fabric(publisher, rsup, wsup)
        raise
    return wsup, publisher, rsup, client


def stop_fabric(publisher, rsup, wsup) -> None:
    """Ordered teardown: every exit path must stop both process tiers and
    the publisher: the elastic tier first (no promotion or scaling may
    race the teardown), then the publisher (stops must not churn the
    view), the router replicas and the workers.  ``None`` slots are
    skipped; every tier stops even when an earlier stop raises."""
    fleet = getattr(wsup, "fleet", None)
    try:
        if fleet is not None:
            fleet.stop()
    finally:
        _stop_fabric_rest(publisher, rsup, wsup)


def _stop_fabric_rest(publisher, rsup, wsup) -> None:
    try:
        if publisher is not None:
            publisher.stop()
    finally:
        try:
            if rsup is not None:
                rsup.stop()
        finally:
            if wsup is not None:
                wsup.stop()


# --------------------------------------------------------- mid-burst kills ---

def kill_mid_burst(kills, settle_timeout_s: float = 60.0,
                   announce=None, poll_interval_s: float = 0.05) -> bool:
    """The mid-burst kill, a ``concurrent`` hook of a fabric run:
    SIGKILL the first handle of each scheduled supervisor at its offset
    into the run, then poll every affected tier until the victim's
    replacement demonstrates ready (generation >= 1) —
    ``run_fabric_loadgen`` builds books only from a SETTLED fleet.

    ``kills`` rows are ``(after_s, supervisor, tier_label)``; rows with
    a falsy offset are dropped.  Sorted on the offset ALONE: tied
    offsets must not fall through to comparing supervisors (unorderable
    — a TypeError here would surface only after the whole load burst).
    ``announce`` is an optional ``callable(tier, victim_id, after_s)``
    for CLI chatter.  Returns True when every tier settled inside
    ``settle_timeout_s``.
    """
    kills = sorted(((after, sup, tier) for after, sup, tier in kills
                    if after), key=lambda k: k[0])
    pause = threading.Event()
    victims = []   # (sup, slot, generation at kill) — the slots to watch
    t0 = mono_now_s()
    for after_s, sup, tier in kills:
        delay = after_s - (mono_now_s() - t0)
        if delay > 0:
            pause.wait(delay)
        victim = sup.handles[0]
        victims.append((sup, 0, victim.generation))
        if announce is not None:
            announce(tier, victim.worker_id, after_s)
        sup.kill_worker(victim.worker_id)
    give_up = mono_now_s() + settle_timeout_s
    while mono_now_s() < give_up:
        # the VICTIM'S slot must advance past the killed generation and
        # demonstrate ready — any other handle already at generation >= 1
        # (an earlier warmup flake) must not count as settled
        if all(sup.handles[slot].generation > gen0
               and sup.handles[slot].state == "ready"
               for sup, slot, gen0 in victims):
            return True
        pause.wait(poll_interval_s)
    return False


# ----------------------------------------------------------------- client ---

@dataclasses.dataclass(frozen=True)
class FabricClientConfig:
    """Client-tier dispatch knobs."""

    default_deadline_s: float | None = 0.5
    connect_timeout_s: float = 2.0
    # how many DISTINCT router replicas one request may try before the
    # client settles it (a reset replica triggers an immediate failover)
    max_router_attempts: int = 3


_FABRIC_IDS = itertools.count(1)

# the terminal vocabulary and give-up budgets are the ROUTER's — one
# definition, imported, so the cross-tier "give up outermost-last"
# chain cannot be broken by editing a hand-rolled copy on one side
# (router.py's only fabric import is lazy, so no cycle)
_CLIENT_TERMINAL = TERMINAL_STATES
_TERMINAL_GRACE_S = _ROUTER_TERMINAL_GRACE_S


@dataclasses.dataclass
class FabricRequest:
    """One request's life-cycle record, client tier."""

    kind: str
    n_assets: int
    priority: str = "interactive"
    deadline_s: float | None = None      # ABSOLUTE monotonic
    panel_version: int | None = None
    req_id: int = dataclasses.field(
        default_factory=lambda: next(_FABRIC_IDS))
    state: str = "routing"
    result: object = None
    error: str | None = None
    router_id: str | None = None         # which replica answered
    worker_id: str | None = None         # which worker served it
    cache_hit: bool = False
    hedged: bool = False
    attempts: int = 0                    # router attempts (client tier)
    retry_after_s: float | None = None
    t_submit_s: float = 0.0
    t_done_s: float | None = None
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


class FabricClient:
    """The fabric's outermost tier: submit to router replicas, fail
    over on replica death, keep closed client-side books.

    The client is deliberately thin: no hedging (that is the routers'
    job, one tier down, where the worker menu lives), no queue — one
    thread per in-flight request doing one wire round trip per router
    attempt.  Replica choice is round robin over the READY set per
    attempt; a conn-reset/killed replica is excluded for the request's
    remaining attempts, so the failover converges on survivors.
    """

    def __init__(self, routers_fn, config: FabricClientConfig | None = None):
        """``routers_fn() -> list`` of handles with ``.worker_id`` and
        ``.socket_path`` — the router supervisor's READY set."""
        self.config = config or FabricClientConfig()
        self._routers_fn = routers_fn
        self._rr = itertools.count()
        self._lock = threading.Lock()
        # the persistent multiplexed transport: long-lived
        # channels to the router replicas — requests interleave on one
        # TCP_NODELAY stream per replica instead of dialing per submit
        self.channels = proto.ChannelPool(
            connect_timeout_s=self.config.connect_timeout_s)
        # shared score-header renderer — one implementation with the
        # router tier (proto.ScoreHeaderCache), no hand-synced copy
        self._headers = proto.ScoreHeaderCache()
        self.admitted = 0
        self.served = 0
        self.rejected = 0
        self.expired = 0
        self.rejected_infra = 0
        self.served_cache_hits = 0
        self.served_hedged = 0
        self.router_conn_failures = 0
        self.failovers = 0

    # --------------------------------------------------------------- admit

    def close(self) -> None:
        """Close the client's channels (teardown hygiene; safe while
        requests are settling — they reason-close into failover)."""
        self.channels.close()

    def submit(self, kind: str, values, mask,
               priority: str = "interactive",
               deadline_s: float | None = None,
               panel_version: int | None = None) -> FabricRequest:
        from csmom_tpu_torch.obs import fleet as obs_fleet
        from csmom_tpu_torch.obs import trace as obs_trace

        values = np.asarray(values)
        mask = np.asarray(mask, dtype=bool)
        n_assets = int(values.shape[0]) if values.ndim == 2 else 0
        rel = (self.config.default_deadline_s if deadline_s is None
               else deadline_s)
        now = mono_now_s()
        req = FabricRequest(
            kind=kind, n_assets=n_assets, priority=priority,
            deadline_s=None if rel is None else now + rel,
            panel_version=panel_version, t_submit_s=now,
            trace=obs_trace.begin(kind, priority,
                                  panel_version=panel_version))
        with self._lock:
            self.admitted += 1
        # fleet demand telemetry (a no-op disarmed): the client tier is
        # where a request is offered, and every one offered is admitted
        obs_fleet.demand("offered", priority)
        obs_fleet.demand("admitted", priority)
        t = threading.Thread(
            target=self._drive, args=(req, values, mask),
            name=f"csmom-fabric-req-{req.req_id}", daemon=True)
        t.start()
        return req

    def _pick_router(self, exclude: set):
        routers = [r for r in self._routers_fn()
                   if r.worker_id not in exclude]
        if not routers:
            return None
        return routers[next(self._rr) % len(routers)]

    def _drive(self, req: FabricRequest, values, mask) -> None:
        tried: set = set()
        failures: list = []
        for attempt in range(self.config.max_router_attempts):
            now = mono_now_s()
            rem = req.remaining_s(now)
            if rem is not None and rem <= 0:
                self._terminate(req, "expired",
                                error="deadline expired before any router "
                                      "replica answered"
                                      + (f" (after: {'; '.join(failures)})"
                                         if failures else ""))
                return
            router = self._pick_router(tried)
            if router is None and tried:
                # every replica tried: widen back to the full ready set
                # (a replica that rejected honestly may still serve a
                # retry; a killed one is simply gone from the menu)
                tried = set()
                router = self._pick_router(tried)
            if router is None:
                self._terminate(req, "rejected", infra=True,
                                error="no ready router replica"
                                      + (f" ({'; '.join(failures[-2:])})"
                                         if failures else ""))
                return
            tried.add(router.worker_id)
            req.attempts += 1
            if attempt > 0:
                with self._lock:
                    self.failovers += 1
            header = self._headers.render(req.kind, req.priority,
                                          req.panel_version, req.req_id,
                                          rem, trace_ctx=req.trace)
            # a deadline-less attempt must outwait the ROUTER's own
            # terminal give-up (gate + dispatch + grace) — derived from
            # the same function _score uses, so the chain keeps giving
            # up outermost-last
            wait_budget = (rem if rem is not None
                           else no_deadline_score_give_up_s(
                               self.config.connect_timeout_s))
            timeout = (self.config.connect_timeout_s + wait_budget
                       + _TERMINAL_GRACE_S)
            t0 = mono_now_s()
            marks: dict = {}
            try:
                obj, arrays = self.channels.request(
                    router.socket_path, header,
                    arrays={"values": values, "mask": mask},
                    timeout_s=timeout, marks=marks)
            except (OSError, proto.ProtocolError) as e:
                # the replica died/reset mid-request (the rehearsed
                # router SIGKILL): its half of the trace is an orphan,
                # closed here with the reason; the request fails over
                with self._lock:
                    self.router_conn_failures += 1
                reason = (f"router connection failed "
                          f"({type(e).__name__}: {e})")[:160]
                if req.trace is not None:
                    req.trace.note_orphan(router.worker_id, reason)
                failures.append(f"{router.worker_id}: {reason}")
                continue
            t1 = mono_now_s()
            if self._settle_reply(req, router, obj, arrays, t0, t1,
                                  failures, marks=marks):
                return
        self._terminate(
            req, "rejected", infra=True,
            error=f"all {req.attempts} router attempt(s) failed: "
                  f"{'; '.join(failures[-3:])}"[:300])

    def _settle_reply(self, req: FabricRequest, router, obj: dict,
                      arrays: dict, t0: float, t1: float,
                      failures: list, marks: dict | None = None) -> bool:
        """Fold one router reply into the request; False = not settled
        (a draining replica's refusal fails over instead)."""
        marks = marks or {}
        window = (t0, t1, obj.get("router_id") or router.worker_id,
                  marks.get("t_acquired_s"), marks.get("t_sent_s"))
        state = obj.get("state")
        req.router_id = obj.get("router_id") or router.worker_id
        req.worker_id = obj.get("worker_id")
        ra = obj.get("retry_after_s")
        req.retry_after_s = float(ra) if ra is not None else None
        if state == "served":
            result = (obj.get("result_obj") if "result_obj" in obj
                      else arrays.get("result"))
            if result is not None and not isinstance(result, dict):
                result = np.asarray(result)[:req.n_assets]
            self._terminate(req, "served", result=result,
                            cache_hit=bool(obj.get("cache_hit")),
                            hedged=bool(obj.get("hedged")),
                            trace_half=obj.get("trace_half"),
                            attempt_window=window)
            return True
        err = str(obj.get("error") or "")
        if "router draining" in err:
            # a drain-stopping replica (rolling restart) is a routing
            # miss, not the request's fate — try a surviving replica.
            # Matched on the replica's OWN drain text only: the door's
            # no-ready-worker rejection also mentions "draining" and
            # must settle below, not fan the outage across every replica
            failures.append(f"{req.router_id}: {err}"[:160])
            return False
        if state not in _CLIENT_TERMINAL:
            state = "rejected"
        # an honest router answer (backpressure, expiry, unserveable) is
        # the request's fate — the replica had the full worker menu and
        # its own failover/hedging already; re-asking another replica
        # would double the load exactly when the fabric is saturated.
        # Infra classification rides the WIRE (the replica's own books
        # know why it rejected); the substring is only a fallback for
        # replies minted before the flag existed
        infra = bool(obj.get("infra")) or "no ready worker" in err
        self._terminate(req, state, error=obj.get("error"), infra=infra,
                        trace_half=obj.get("trace_half"),
                        attempt_window=window)
        return True

    # ------------------------------------------------------------ terminal

    def _terminate(self, req: FabricRequest, state: str, result=None,
                   error: str | None = None, infra: bool = False,
                   cache_hit: bool = False, hedged: bool = False,
                   trace_half: dict | None = None,
                   attempt_window: tuple | None = None) -> None:
        with self._lock:
            if req.state in _CLIENT_TERMINAL:
                return
            req.state = state
            req.result = result
            if error is not None:
                req.error = str(error)
            req.t_done_s = mono_now_s()
            if state == "served":
                self.served += 1
                if cache_hit:
                    req.cache_hit = True
                    self.served_cache_hits += 1
                if hedged:
                    req.hedged = True
                    self.served_hedged += 1
            elif state == "expired":
                self.expired += 1
            else:
                self.rejected += 1
                if infra:
                    self.rejected_infra += 1
            if req.trace is not None:
                if trace_half is not None and attempt_window is not None:
                    ta0, ta1, rid = attempt_window[:3]
                    acq, sent = (attempt_window[3:5]
                                 if len(attempt_window) >= 5
                                 else (None, None))
                    req.trace.absorb_remote(trace_half, ta0, ta1,
                                            worker_id=rid,
                                            t_acquired_s=acq,
                                            t_sent_s=sent)
                req.trace.close_routed(state, req.t_done_s, reason=error)
            req._done.set()
        if state == "served":
            from csmom_tpu_torch.obs import fleet as obs_fleet

            obs_fleet.demand("served", req.priority)

    # ---------------------------------------------------------- accounting

    def accounting(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "served": self.served,
                "rejected": self.rejected,
                "expired": self.expired,
                "rejected_infra": self.rejected_infra,
                "served_cache_hits": self.served_cache_hits,
                "served_hedged": self.served_hedged,
                "router_conn_failures": self.router_conn_failures,
                "failovers": self.failovers,
            }

    def availability(self) -> float:
        """``1 - rejected_infra / admitted`` at the CLIENT tier: the
        fraction of admitted requests the fabric answered honestly,
        through every replica death and partition it absorbed."""
        a = self.accounting()
        if not a["admitted"]:
            return 1.0
        return round(1.0 - a["rejected_infra"] / a["admitted"], 6)

    def invariant_violations(self) -> list:
        a = self.accounting()
        out = []
        total = a["served"] + a["rejected"] + a["expired"]
        if total != a["admitted"]:
            out.append(
                f"fabric client accounting broken: served {a['served']} + "
                f"rejected {a['rejected']} + expired {a['expired']} = "
                f"{total} != admitted {a['admitted']}")
        if a["rejected_infra"] > a["rejected"]:
            out.append("rejected_infra exceeds rejected")
        if a["served_cache_hits"] > a["served"]:
            out.append("served_cache_hits exceeds served")
        return out
