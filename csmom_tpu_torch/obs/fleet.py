"""Fleet observatory: cross-process metrics time series, kill-window
capacity accounting and demand telemetry for the pool and the fabric.

Counterpart of ``csmom_tpu.obs.fleet``, copied (stdlib and numpy only:
a router replica arms it and never loads torch).  Every process of a
pool or fabric run (worker, router replica, and the load generator that
carries the supervisors) samples its own :mod:`~csmom_tpu_torch.obs.metrics`
registry on a fixed monotonic cadence into **snapshot deltas**
(sequence-numbered, stamped with the process's identity, counters
monotone by construction, see ``metrics.snapshot_delta``) and streams
them to a per-run aggregator over the channel layer with the lifecycle
``stats_stream`` op: a persistent channel, never the request path, and
free of chaos faults (``serve.transport`` faults fire only for
``score``).

The aggregator assembles bounded ring-buffer series keyed
``(process, metric)`` plus per-process stream books, and the run lands a
closed ``GPU_FLEET_<run>.json`` artifact (kind ``fleet``, schema v1, the
reference's) carrying:

- per-second, per-class offered / admitted / served demand (the demand
  book), reconciling with the serve request book by schema
  (``chaos/invariants.py`` kind ``fleet``);
- queue depth and in-flight occupancy per worker (gauge series);
- worker lifecycle walls: spawn -> bind -> warm -> ready, one sample per
  (re)spawn, split by spawn kind (cold, respawn, roll, spare-promotion);
- a **kill-window capacity account**: worker-seconds available against
  nominal over the run, split into the kill windows (SIGKILL -> the
  slot ready again) and steady state, with a parked spare credited as
  warm reserve.

**Closed stream books**: every process that streamed is closed with a
reason.  A clean emitter sends a ``fin`` frame at shutdown; a SIGKILLed
one cannot, so its connection's EOF closes the series as a
reason-closed gap ("stream severed ...").  Frame sequence numbers make
dropped frames visible (``seq_gaps``).

Zero cost disarmed: with no aggregator armed the hooks are one global
load and compare.  Armed, sampling runs on its own daemon thread and a
send failure is a counted drop.

Environment contract (how the processes of a run join its observatory):

- ``CSMOM_FLEET``            aggregator address (``unix:`` path or
  ``tcp:host:port``); unset, empty or ``0`` = disarmed.
- ``CSMOM_FLEET_RUN``        run id stamped on every frame.
- ``CSMOM_FLEET_CADENCE_S``  sampling cadence (default 0.25 s).

All timestamps are ``mono_now_s`` (CLOCK_MONOTONIC, system-wide on
Linux), so the stamps of different processes compose onto one timeline.
"""

from __future__ import annotations

import math
import os
import threading
from collections import deque

from csmom_tpu_torch.obs import metrics as _metrics
from csmom_tpu_torch.obs import spans as _spans
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = [
    "DEFAULT_CADENCE_S",
    "ENV_ADDR",
    "ENV_CADENCE",
    "ENV_RUN",
    "SCHEMA_VERSION",
    "SERIES_CAP",
    "FleetAggregator",
    "FleetEmitter",
    "absolute_events",
    "arm",
    "arm_emitter_from_env",
    "armed",
    "build_artifact",
    "capacity_account",
    "current_aggregator",
    "demand",
    "disarm",
    "disarm_emitter",
    "lifecycle_walls",
    "open_demand_window",
]

SCHEMA_VERSION = 1

ENV_ADDR = "CSMOM_FLEET"
ENV_RUN = "CSMOM_FLEET_RUN"
ENV_CADENCE = "CSMOM_FLEET_CADENCE_S"

DEFAULT_CADENCE_S = 0.25

# ring bound per (process, metric) series: at the default cadence this
# holds 150 s of samples — beyond it the OLDEST points roll off (the
# books keep the totals), so a long soak costs constant memory
SERIES_CAP = 600

# bound on DISTINCT series: a runaway metric-name generator must fill a
# counter ("series_dropped"), never the aggregator's memory
MAX_SERIES = 4096

# one stats_stream round trip's budget — an aggregator that cannot ack
# within this is treated as gone and the frame is counted dropped
FRAME_TIMEOUT_S = 2.0

# the armed aggregator / emitter, or None.  Module-global on purpose
# (the spans discipline): every disarmed hook is one load + compare.
_AGGREGATOR = None
_EMITTER = None


def _proc_name(role: str, slot=None) -> str:
    # pid-qualified so a SIGKILLed worker's REPLACEMENT (same role, same
    # slot, new process) opens its own stream book instead of writing
    # its fin over the victim's severed close reason — each incarnation
    # is its own reason-closed series
    base = f"{role}:{slot}" if slot is not None else str(role)
    return f"{base}@{os.getpid()}"


# ---------------------------------------------------------------- emitter ---

class FleetEmitter:
    """This process's registry sampler: one daemon thread, one
    persistent channel to the aggregator, one frame per cadence tick.

    Every frame carries the delta since the previous tick plus this
    emitter's own frame sequence number — a send that fails consumes
    its sequence number anyway, so the aggregator's ``seq_gaps`` book
    records exactly how many deltas never arrived.  A dead aggregator
    costs one counted drop per tick (bounded by ``FRAME_TIMEOUT_S``),
    never a stalled serving thread: sampling runs entirely off the
    request path.
    """

    def __init__(self, address: str, run_id: str, role: str, slot=None,
                 cadence_s: float = DEFAULT_CADENCE_S):
        self.address = address
        self.run_id = run_id
        self.role = str(role)
        self.slot = slot
        self.proc = _proc_name(role, slot)
        self.cadence_s = float(cadence_s)
        self.dropped = 0
        self._seq = 0
        self._prev = None
        self._channel = None
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "FleetEmitter":
        _metrics.set_identity(self.role, self.slot)
        # the registry only accumulates while a spans collector is armed
        # (the zero-cost-disarmed contract); a fleet-armed process that
        # is otherwise telemetry-dark arms an in-memory collector so its
        # counters exist to sample
        if _spans._COLLECTOR is None:
            _spans.arm(None, proc=self.role)
        self._prev = _metrics.snapshot(include_compile=False)
        # hello frame, synchronously, before the cadence loop exists:
        # the stream book opens the moment the process arms, so a
        # SIGKILL at ANY later instant severs an OPEN stream — a victim
        # that dies inside the first cadence interval must not read as
        # "never joined"
        self._tick()
        self._thread = threading.Thread(
            target=self._loop, name=f"fleet-emitter-{self.proc}",
            daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        next_t = mono_now_s() + self.cadence_s
        while not self._stop.wait(max(0.0, next_t - mono_now_s())):
            next_t += self.cadence_s
            self._tick()

    def _tick(self, fin: str | None = None) -> bool:
        cur = _metrics.snapshot(include_compile=False)
        try:
            delta = _metrics.snapshot_delta(self._prev, cur)
        except ValueError:
            # a reset registry mid-run (tests): restart the delta chain
            # from here rather than emit a splice
            self._prev = cur
            return False
        self._prev = cur
        self._seq += 1
        frame = {
            "op": "stats_stream",
            "run": self.run_id,
            "proc": self.proc,
            "role": self.role,
            "slot": self.slot,
            "pid": os.getpid(),
            "seq": self._seq,
            "t_s": round(mono_now_s(), 6),
            "counters": delta["counters"],
            "gauges": delta["gauges"],
            "histograms": delta["histograms"],
            "dropped": self.dropped,
        }
        if fin is not None:
            frame["fin"] = fin
        return self._send(frame)

    def _send(self, frame: dict) -> bool:
        from csmom_tpu_torch.serve import proto

        for _ in (0, 1):  # one transparent redial, then count the drop
            ch = self._channel
            if ch is None or not ch.alive:
                try:
                    sock = proto.connect(self.address, FRAME_TIMEOUT_S)
                    ch = self._channel = proto.Channel(
                        self.address, sock,
                        frame_deadline_s=FRAME_TIMEOUT_S)
                except (OSError, ValueError):
                    self._channel = None
                    break
            try:
                ch.request(frame, None, timeout_s=FRAME_TIMEOUT_S)
                return True
            except Exception:
                try:
                    ch.close("fleet emitter redial")
                except Exception:
                    pass
                self._channel = None
        self.dropped += 1
        return False

    def stop(self, reason: str = "emitter stopped") -> None:
        """Final delta + ``fin`` frame, then close the channel.  A
        process that never reaches here (SIGKILL) is exactly the
        severed-stream case the aggregator reason-closes on EOF."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.cadence_s + 1.0)
        self._tick(fin=reason)
        ch, self._channel = self._channel, None
        if ch is not None:
            try:
                ch.close("fleet emitter stopped")
            except Exception:
                pass


# ------------------------------------------------------------- aggregator ---

class FleetAggregator:
    """The per-run sink: listener, stream books, ring-buffer series,
    and the demand book.

    One leaf lock guards all mutable state and never calls out while
    held (the lock-order audit's acyclic contract).  Connections are
    served by the channel layer's own loop; a connection that ends
    without a ``fin`` reason-closes every process that streamed on it.
    """

    def __init__(self, run_id: str, transport: str = "unix",
                 cadence_s: float = DEFAULT_CADENCE_S,
                 scratch_dir: str | None = None,
                 series_cap: int = SERIES_CAP):
        self.run_id = run_id
        self.transport = transport
        self.cadence_s = float(cadence_s)
        self.series_cap = int(series_cap)
        self.address: str | None = None
        self.t0_s = mono_now_s()
        self._scratch_dir = scratch_dir
        self._made_dir = None       # a temporary dir this aggregator made
        self._srv = None
        self._accept_thread = None
        self._conn_threads: list = []
        self._stopping = False
        self._lock = threading.Lock()
        self._series: dict = {}     # (proc, metric) -> series state
        self._procs: dict = {}      # proc -> stream book
        self.frames = 0
        self.frames_malformed = 0
        self.series_dropped = 0
        # demand book: armed only inside the measurement window, so
        # pre-run self-probes never pollute the reconciliation
        self._demand_open = False
        self._demand_t0 = None
        self._demand_per_s: dict = {}   # int bucket -> cls -> event -> n
        self._demand_totals: dict = {}  # cls -> event -> n

    # ----------------------------------------------------------- serving --

    def start(self) -> "FleetAggregator":
        import tempfile

        from csmom_tpu_torch.serve import proto

        if self.transport == "tcp":
            self.address = f"tcp:127.0.0.1:{proto.free_tcp_port()}"
        else:
            d = self._scratch_dir
            if d is None:
                d = self._made_dir = tempfile.mkdtemp(prefix="csmom-fleet-")
            self.address = os.path.join(d, "aggregator.sock")
        self._srv = proto.listen(self.address)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-aggregator-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed: shutdown
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="fleet-aggregator-conn", daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _serve_conn(self, conn) -> None:
        from csmom_tpu_torch.serve import proto

        procs_on_conn: set = set()
        fin_on_conn: set = set()

        def handler(obj, arrays):
            if obj.get("op") != "stats_stream":
                return {"ok": False,
                        "error": f"unknown op {obj.get('op')!r}"}, None
            ok, proc, fin = self._ingest(obj)
            if proc is not None:
                procs_on_conn.add(proc)
                if fin:
                    fin_on_conn.add(proc)
            return {"ok": ok, "seq": obj.get("seq")}, None

        try:
            proto.serve_connection(conn, handler,
                                   idle_timeout_s=proto.SERVE_IDLE_S)
        finally:
            # EOF/error without a fin is the SIGKILL signature: close
            # the stream as a reason-closed gap, never silently
            for p in procs_on_conn - fin_on_conn:
                self.close_proc(
                    p, "stream severed: connection lost without fin "
                       "(peer killed or crashed)")

    # ----------------------------------------------------------- ingest ---

    def _ingest(self, frame: dict):
        proc = frame.get("proc")
        seq = frame.get("seq")
        t_s = frame.get("t_s")
        if (not isinstance(proc, str) or not isinstance(seq, int)
                or not isinstance(t_s, (int, float))):
            with self._lock:
                self.frames_malformed += 1
            return False, None, False
        fin = frame.get("fin")
        with self._lock:
            self.frames += 1
            book = self._procs.get(proc)
            if book is None:
                book = self._procs[proc] = {
                    "role": frame.get("role"),
                    "slot": frame.get("slot"),
                    "pid": frame.get("pid"),
                    "first_seq": seq,
                    "last_seq": seq - 1,
                    "samples": 0,
                    "seq_gaps": 0,
                    "dropped": 0,
                    "t_first_s": t_s,
                    "t_last_s": t_s,
                    "closed": False,
                    "close_reason": None,
                }
            gap = seq - book["last_seq"] - 1
            if gap > 0:
                book["seq_gaps"] += gap
            book["last_seq"] = max(book["last_seq"], seq)
            book["samples"] += 1
            book["dropped"] = max(book["dropped"],
                                  int(frame.get("dropped") or 0))
            book["t_last_s"] = t_s
            for name, d in (frame.get("counters") or {}).items():
                self._append(proc, name, "counter", t_s, d)
            for name, v in (frame.get("gauges") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._append(proc, name, "gauge", t_s, v)
            if fin:
                book["closed"] = True
                book["close_reason"] = f"fin: {fin}"[:160]
        return True, proc, bool(fin)

    def _append(self, proc: str, metric: str, kind: str, t_s: float,
                v) -> None:
        # caller holds self._lock
        key = (proc, metric)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= MAX_SERIES:
                self.series_dropped += 1
                return
            s = self._series[key] = {
                "kind": kind, "cum": 0.0,
                "t": deque(maxlen=self.series_cap),
                "v": deque(maxlen=self.series_cap),
            }
        if kind == "counter":
            # sum of non-negative deltas: monotone BY CONSTRUCTION
            s["cum"] += max(0.0, float(v))
            v = s["cum"]
        s["t"].append(float(t_s))
        s["v"].append(float(v))

    # ----------------------------------------------------------- demand ---

    def open_demand_window(self) -> None:
        """Start counting demand (call AFTER self-probes, so the
        reconciliation against the serve request books is exact)."""
        with self._lock:
            self._demand_open = True
            self._demand_t0 = mono_now_s()

    def note_demand(self, event: str, slo_class: str) -> None:
        t = mono_now_s()
        with self._lock:
            if not self._demand_open:
                return
            bucket = int(t - self._demand_t0)
            cls = str(slo_class)
            per = self._demand_per_s.setdefault(bucket, {})
            cb = per.setdefault(cls, {})
            cb[event] = cb.get(event, 0) + 1
            tot = self._demand_totals.setdefault(cls, {})
            tot[event] = tot.get(event, 0) + 1

    def demand_offered_in(self, t0_abs: float, t1_abs: float) -> int:
        """Offered arrivals inside an absolute-mono window, counted at
        the demand book's one-second bucket granularity."""
        with self._lock:
            if self._demand_t0 is None:
                return 0
            b0 = int(t0_abs - self._demand_t0)
            b1 = int(t1_abs - self._demand_t0)
            n = 0
            for b, per in self._demand_per_s.items():
                if b0 <= b <= b1:
                    for cb in per.values():
                        n += cb.get("offered", 0)
            return n

    def demand_recent_rps(self, horizon_s: float = 3.0,
                          event: str = "offered",
                          slo_class: str | None = None) -> float:
        """Trailing arrival rate (events/s) over ``horizon_s``, read
        from the demand book's one-second buckets: the autoscaler's
        control input (``serve/fleet.py``).  ``slo_class`` narrows to a
        single class (for quota tuning); default sums all classes.

        The events of the last ``ceil(horizon_s)`` buckets are divided
        by the time those buckets have covered (the current one only in
        part, and never less than one second), so a steady arrival rate
        reads as itself at any instant of a bucket.  The reference
        divides by the whole width, which reads a steady rate as half of
        itself at the start of each bucket."""
        now = mono_now_s()
        with self._lock:
            if self._demand_t0 is None or not self._demand_open:
                return 0.0
            width = max(1, int(math.ceil(horizon_s)))
            elapsed = now - self._demand_t0
            now_b = int(elapsed)
            b0 = now_b - width + 1
            n = 0
            for b, per in self._demand_per_s.items():
                if b0 <= b <= now_b:
                    for cls, cb in per.items():
                        if slo_class is not None and cls != slo_class:
                            continue
                        n += cb.get(event, 0)
            covered = min(elapsed, (width - 1) + (elapsed - now_b))
            return n / max(1.0, covered)

    # ---------------------------------------------------------- closing ---

    def close_proc(self, proc: str, reason: str) -> None:
        with self._lock:
            book = self._procs.get(proc)
            if book is not None and not book["closed"]:
                book["closed"] = True
                book["close_reason"] = str(reason)[:160]

    def close_all(self, reason: str = "run-end") -> None:
        with self._lock:
            for book in self._procs.values():
                if not book["closed"]:
                    book["closed"] = True
                    book["close_reason"] = str(reason)[:160]

    def stop(self) -> None:
        self._stopping = True
        srv, self._srv = self._srv, None
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass
        if self.address and not self.address.startswith("tcp:"):
            try:
                os.unlink(self.address)
            except OSError:
                pass
        if self._made_dir is not None:
            try:
                os.rmdir(self._made_dir)
            except OSError:
                pass

    # ---------------------------------------------------------- reading ---

    def snapshot(self, t0_s: float | None = None) -> dict:
        """Series + books as one JSON-ready dict, timestamps shifted to
        be relative to ``t0_s`` (default: aggregator start)."""
        base = self.t0_s if t0_s is None else float(t0_s)
        with self._lock:
            points = {}
            for (proc, metric), s in sorted(self._series.items()):
                points[f"{proc}|{metric}"] = {
                    "proc": proc,
                    "metric": metric,
                    "kind": s["kind"],
                    "t_s": [round(t - base, 3) for t in s["t"]],
                    "v": [round(v, 6) for v in s["v"]],
                }
            processes = {}
            for proc, book in sorted(self._procs.items()):
                processes[proc] = dict(
                    book,
                    t_first_s=round(book["t_first_s"] - base, 3),
                    t_last_s=round(book["t_last_s"] - base, 3),
                )
            per_second = []
            for b in sorted(self._demand_per_s):
                per_second.append({"t_s": b,
                                   **{cls: dict(ev) for cls, ev in
                                      sorted(self._demand_per_s[b].items())}})
            demand_t0 = (None if self._demand_t0 is None
                         else round(self._demand_t0 - base, 3))
            return {
                "books": {
                    "procs_opened": len(self._procs),
                    "procs_closed": sum(1 for b in self._procs.values()
                                        if b["closed"]),
                    "frames": self.frames,
                    "frames_malformed": self.frames_malformed,
                    "seq_gaps": sum(b["seq_gaps"]
                                    for b in self._procs.values()),
                    "frames_dropped_by_emitters": sum(
                        b["dropped"] for b in self._procs.values()),
                    "series_count": len(self._series),
                    "series_dropped": self.series_dropped,
                },
                "processes": processes,
                "points": points,
                "demand": {
                    "t0_s": demand_t0,
                    "classes": {cls: dict(ev) for cls, ev in
                                sorted(self._demand_totals.items())},
                    "per_second": per_second,
                },
            }


# ---------------------------------------------------------------- arming ----

def armed() -> bool:
    return _AGGREGATOR is not None


def current_aggregator() -> FleetAggregator | None:
    return _AGGREGATOR


def arm(run_id: str, transport: str = "unix",
        cadence_s: float | None = None,
        scratch_dir: str | None = None) -> FleetAggregator:
    """Arm fleet capture for this run: start the aggregator, export the
    env contract so processes spawned after this call join, and arm a
    local emitter for the loadgen/supervisor host process itself."""
    global _AGGREGATOR
    if cadence_s is None:
        raw = os.environ.get(ENV_CADENCE, "")
        cadence_s = float(raw) if raw else DEFAULT_CADENCE_S
    disarm(reason="re-armed")
    agg = FleetAggregator(run_id, transport=transport,
                          cadence_s=cadence_s,
                          scratch_dir=scratch_dir).start()
    _AGGREGATOR = agg
    os.environ[ENV_ADDR] = agg.address
    os.environ[ENV_RUN] = run_id
    os.environ[ENV_CADENCE] = str(cadence_s)
    _arm_local_emitter("loadgen")
    return agg


def _arm_local_emitter(role: str, slot=None) -> FleetEmitter:
    global _EMITTER
    em = FleetEmitter(os.environ[ENV_ADDR],
                      os.environ.get(ENV_RUN) or "unnamed",
                      role, slot,
                      cadence_s=float(os.environ.get(ENV_CADENCE)
                                      or DEFAULT_CADENCE_S)).start()
    _EMITTER = em
    return em


def arm_emitter_from_env(role: str, slot=None) -> FleetEmitter | None:
    """Child-process side of the env contract: join the run's aggregator
    or stay disarmed (``CSMOM_FLEET`` unset/empty/``0``).  Called from
    worker/router mains — a send-only hook, never the request path."""
    addr = os.environ.get(ENV_ADDR, "")
    if not addr or addr == "0":
        return None
    return _arm_local_emitter(role, slot)


def disarm_emitter(reason: str = "emitter stopped") -> None:
    """Fin-close and drop this process's emitter (clean shutdown; a
    SIGKILL never reaches here, which is the point of fin)."""
    global _EMITTER
    em, _EMITTER = _EMITTER, None
    if em is not None:
        em.stop(reason)


def disarm(reason: str = "run-end") -> None:
    """Stop the local emitter (fin), close every still-open stream book
    with ``reason``, stop the aggregator, and retract the env contract
    so later spawns do not dial a dead socket."""
    global _AGGREGATOR
    disarm_emitter(reason)
    agg, _AGGREGATOR = _AGGREGATOR, None
    if agg is not None:
        agg.close_all(reason)
        agg.stop()
    for k in (ENV_ADDR, ENV_RUN, ENV_CADENCE):
        os.environ.pop(k, None)


def open_demand_window() -> None:
    """Start demand counting on the armed aggregator (no-op disarmed)."""
    agg = _AGGREGATOR
    if agg is not None:
        agg.open_demand_window()


def demand(event: str, slo_class: str) -> None:
    """Note one demand event (``offered`` / ``admitted`` / ``served``)
    for an SLO class.  Disarmed: one global load + compare — the serve
    submit path pays nothing when fleet capture is off (pinned)."""
    agg = _AGGREGATOR
    if agg is None:
        return
    agg.note_demand(event, slo_class)


# ------------------------------------------------------- capacity account ---

def absolute_events(events: list, t0_mono_s: float) -> list:
    """Supervisor events (``t_s`` relative to the supervisor's start)
    shifted onto the absolute monotonic timeline the series live on."""
    return [dict(e, t_s=e["t_s"] + t0_mono_s) for e in events]


def lifecycle_walls(events: list) -> list:
    """One sample per (re)spawn: every ``ready`` event's spawn→ready
    wall plus the worker-reported bind/warm decomposition (see
    ``serve/supervisor.py``).  ``kind`` carries the spawn regime
    (cold / respawn / roll / spare-promotion) so fast-path samples gate
    against their own kind instead of averaging across regimes."""
    out = []
    for e in events:
        if e.get("event") != "ready":
            continue
        out.append({
            "worker_id": e.get("worker_id"),
            "generation": e.get("generation"),
            "kind": e.get("spawn_kind") or "cold",
            "wall_s": e.get("wall_s"),
            "walls": e.get("walls"),
        })
    return out


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def capacity_account(events: list, n_slots: int, window: tuple) -> dict:
    """Effective worker-seconds available vs nominal over ``window``
    (absolute-mono ``(t0, t1)``), from supervisor lifecycle events on
    the same timeline (:func:`absolute_events`).

    A slot is AVAILABLE from each ``ready`` until its next
    ``chaos_kill``/``death`` (whichever stamps first).  Each such down
    transition opens a **kill window** [kill, victim's next ready] —
    the re-warm interval (a monitor-detected death
    digs the same hole as an explicit chaos kill, and the death notice
    trailing a booked kill never double-opens).  The account is computed
    purely from measured lifecycle stamps: no model, no imputation —
    steady-state loss ≈ 0 is a *result*, not an assumption.

    Hot spares (``serve/fleet.py``) enter the account as WARM-CAPACITY
    reserve intervals: ``spare_ready`` opens one, and any of
    ``spare_promoted``/``spare_death``/``spare_stopped`` closes it.
    Spare events never open kill windows (a parked spare dying costs no
    serving capacity — it was never routed), and a reserve covering a
    kill window offsets the victim's hole: the account measures warm
    capacity the fleet *possesses*.  The routable gap a client could
    feel is gated separately, by the promotion-kind ready wall and the
    in-window demand/latency criteria.
    """
    t0, t1 = float(window[0]), float(window[1])
    per_slot: dict = {}
    spare_marks: dict = {}
    for e in events:
        wid = e.get("worker_id")
        ev = e.get("event")
        if wid is None:
            continue
        if ev in ("ready", "chaos_kill", "death"):
            per_slot.setdefault(wid, []).append((float(e["t_s"]), ev))
        elif ev in ("spare_ready", "spare_promoted", "spare_death",
                    "spare_stopped"):
            spare_marks.setdefault(wid, []).append((float(e["t_s"]), ev))
    intervals = []       # (start, end) of availability, per slot merged
    spare_intervals = []
    for wid, marks in spare_marks.items():
        marks.sort()
        up_since = None
        for t, ev in marks:
            if ev == "spare_ready":
                if up_since is None:
                    up_since = t
            elif up_since is not None:
                spare_intervals.append((up_since, t))
                up_since = None
        if up_since is not None:
            spare_intervals.append((up_since, t1))
    intervals.extend(spare_intervals)
    kill_windows = []
    for wid, marks in per_slot.items():
        marks.sort()
        up_since = None
        for t, ev in marks:
            if ev == "ready":
                if up_since is None:
                    up_since = t
                for kw in kill_windows:
                    if kw["worker_id"] == wid and kw["t_ready_s"] is None \
                            and t > kw["t_kill_s"]:
                        kw["t_ready_s"] = t
                        break
            else:
                if up_since is not None:
                    intervals.append((up_since, t))
                    up_since = None
                # chaos_kill opens the window, and so does a
                # monitor-detected `death` (an organic crash — or a
                # fault-plan self-kill inside the worker — digs the same
                # capacity hole); the monitor's death notice for an
                # already-booked victim must not double-open it
                if not any(kw["worker_id"] == wid
                           and kw["t_ready_s"] is None
                           for kw in kill_windows):
                    kill_windows.append({"worker_id": wid, "t_kill_s": t,
                                         "t_ready_s": None})
        if up_since is not None:
            intervals.append((up_since, t1))
    # an unreplaced victim's window runs to the end of the run — honest:
    # the capacity never came back inside the measured window
    for kw in kill_windows:
        kw["open_ended"] = kw["t_ready_s"] is None
        if kw["t_ready_s"] is None:
            kw["t_ready_s"] = t1
    nominal = max(0.0, (t1 - t0)) * n_slots
    available = sum(_overlap(a, b, t0, t1) for a, b in intervals)
    # merge kill windows into a disjoint union before accounting, so two
    # overlapping victims do not double-count the same wall
    spans = sorted((max(kw["t_kill_s"], t0), min(kw["t_ready_s"], t1))
                   for kw in kill_windows)
    merged = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    kw_nominal = sum((b - a) for a, b in merged) * n_slots
    kw_available = sum(_overlap(ia, ib, a, b)
                       for ia, ib in intervals for a, b in merged)
    ss_nominal = nominal - kw_nominal
    ss_available = available - kw_available
    for kw in kill_windows:
        a = max(kw["t_kill_s"], t0)
        b = min(kw["t_ready_s"], t1)
        width = max(0.0, b - a)
        avail = sum(_overlap(ia, ib, a, b) for ia, ib in intervals)
        kw.update(
            t_kill_s=round(kw["t_kill_s"] - t0, 3),
            t_ready_s=round(kw["t_ready_s"] - t0, 3),
            width_s=round(width, 3),
            # spare reserve can push in-window available past nominal;
            # loss never reads negative (warm capacity ≥ nominal means
            # the hole was covered, not that capacity was conjured)
            loss_frac=(round(max(0.0, 1.0 - avail / (width * n_slots)), 4)
                       if width > 0 and n_slots else 0.0),
        )
    spare_reserve = sum(_overlap(a, b, t0, t1) for a, b in spare_intervals)
    return {
        "n_slots": n_slots,
        "window_s": round(t1 - t0, 3),
        "nominal_worker_s": round(nominal, 3),
        "available_worker_s": round(min(available, nominal), 3),
        "spare_reserve_worker_s": round(spare_reserve, 3),
        "kill_windows": kill_windows,
        "kill_window_loss_frac": (
            round(max(0.0, 1.0 - kw_available / kw_nominal), 4)
            if kw_nominal > 0 else 0.0),
        "steady_state_loss_frac": (
            round(max(0.0, 1.0 - ss_available / ss_nominal), 4)
            if ss_nominal > 0 else 0.0),
    }


# --------------------------------------------------------------- artifact ---

def _series_quantiles(values: list) -> dict:
    if not values:
        return {"p50": None, "p95": None, "max": None}
    s = sorted(values)

    def pick(q):
        return s[max(0, math.ceil(q * len(s)) - 1)]

    return {"p50": pick(0.50), "p95": pick(0.95), "max": s[-1]}


def build_artifact(agg: FleetAggregator, run_id: str, *,
                   requests: dict | None = None,
                   worker_events: list | None = None,
                   router_events: list | None = None,
                   n_workers: int | None = None,
                   n_routers: int | None = None,
                   window: tuple | None = None,
                   channels: dict | None = None,
                   fresh_compiles=None,
                   platform: str | None = None,
                   workload: str | None = None,
                   elastic: dict | None = None,
                   extra: dict | None = None) -> dict:
    """The fleet artifact (kind ``fleet``, schema v1): closed stream
    books + ring-buffer series + demand book + lifecycle walls + the
    kill-window capacity account, plus the matching serve run's request
    book so demand reconciles BY SCHEMA (offered == admitted ==
    ``requests.admitted``; served == ``requests.served``).

    ``window`` is the measured load window in absolute mono seconds;
    ``worker_events``/``router_events`` are supervisor events already on
    that timeline (:func:`absolute_events`).
    """
    t0 = agg.t0_s if window is None else float(window[0])
    t1 = mono_now_s() if window is None else float(window[1])
    snap = agg.snapshot(t0_s=t0)
    worker_events = worker_events or []
    router_events = router_events or []
    walls = lifecycle_walls(worker_events)
    wall_samples = [w["wall_s"] for w in walls
                    if isinstance(w.get("wall_s"), (int, float))]
    capacity = capacity_account(worker_events, n_workers or 0, (t0, t1))
    router_capacity = (capacity_account(router_events, n_routers or 0,
                                        (t0, t1))
                       if router_events else None)
    for kw in capacity["kill_windows"]:
        kw["demand_offered_in_window"] = agg.demand_offered_in(
            t0 + kw["t_kill_s"], t0 + kw["t_ready_s"])
    occupancy: dict = {}
    for key, s in snap["points"].items():
        if s["metric"] in ("serve.queue_depth", "serve.in_flight"):
            occ = occupancy.setdefault(s["proc"], {})
            occ[s["metric"].split(".", 1)[1]] = _series_quantiles(s["v"])
    loss = capacity["kill_window_loss_frac"]
    # split the ready walls by spawn regime: a spare promotion gating
    # against the cold-spawn distribution (or vice versa) is a lie
    walls_by_kind: dict = {}
    for w in walls:
        if isinstance(w.get("wall_s"), (int, float)):
            kind = str(w.get("kind") or "cold")
            walls_by_kind.setdefault(kind, []).append(round(w["wall_s"], 4))
    kind_samples = {
        "fleet_worker_ready_wall_%s_s"
        % kind.replace("spare-promotion", "promotion").replace("-", "_"):
        samples
        for kind, samples in sorted(walls_by_kind.items())
    }
    ex = {
        "platform": platform,
        "workload": workload,
        "samples": {
            "fleet_worker_ready_wall_s": [
                round(w, 4) for w in wall_samples],
            **kind_samples,
            "fleet_kill_window_capacity_loss_frac": [
                kw["loss_frac"] for kw in capacity["kill_windows"]],
        },
        **(extra or {}),
    }
    return {
        "kind": "fleet",
        "schema_version": SCHEMA_VERSION,
        "run_id": run_id,
        "metric": "fleet_kill_window_capacity_loss_frac",
        "value": loss,
        "unit": "frac",
        "vs_baseline": 1.0,
        "cadence_s": agg.cadence_s,
        "window_s": round(t1 - t0, 3),
        "series": {
            "books": snap["books"],
            "processes": snap["processes"],
            "points": snap["points"],
        },
        "demand": snap["demand"],
        "occupancy": occupancy,
        "lifecycle": {
            "ready_walls_s": [round(w, 4) for w in wall_samples],
            "events": walls,
        },
        "capacity": capacity,
        "router_capacity": router_capacity,
        "elastic": dict(elastic) if elastic else None,
        "requests": dict(requests) if requests else None,
        "channels": dict(channels) if channels else None,
        "compile": {
            "in_window_fresh_compiles": fresh_compiles,
            "note": "copied from the driven serve run: the capture "
                    "window IS the serving window, so 0 here means no "
                    "kernel library was built or loaded inside any kill "
                    "window",
        },
        "extra": ex,
    }
