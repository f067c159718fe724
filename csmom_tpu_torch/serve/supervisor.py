"""Pool supervisor: spawn, probe, restart and roll the worker fleet.

Counterpart of ``csmom_tpu.serve.supervisor``.  Every worker process the
supervisor spawns ends in a known state, its transitions logged as
events the pool artifact carries:

- **Spawn and demonstrated ready**: a worker is routable only after its
  readiness probe (:mod:`csmom_tpu_torch.serve.health`) reports ``ok``:
  every bucket shape warmed, every endpoint self-probed, no kernel
  library built or loaded since the warm snapshot, and the cache version
  the supervisor expects.  A worker that exits ``RC_VERSION_SKEW``,
  ``RC_COLD_CACHE`` or ``RC_NO_DEVICE`` is parked ``failed`` at once (a
  restart cannot fix any of them) with its stderr as the reason.
- **Crash restart with exponential backoff and jitter**: a dead worker
  is respawned after ``backoff_base_s * 2^k``, jittered ±50% (seeded),
  capped at ``backoff_cap_s``; after ``max_restarts`` consecutive young
  deaths (within ``min_uptime_s``) the slot is parked ``failed``.
- **Rolling restart, warm-before-ready**: a replacement spawns on a
  fresh socket and must report ready before its predecessor drains; a
  replacement that refuses or times out aborts the roll and the
  predecessor keeps serving.

Workers run ``sys.executable -m csmom_tpu_torch.serve.worker`` with the
port's checkout first on ``PYTHONPATH`` and the rest of the environment
inherited unchanged (``CUDA_VISIBLE_DEVICES`` and fault plans
included).  Several torch workers share one card.

Pinning (``devices_per_worker`` > 0, the mesh engine): slot k owns the
fixed slice ``k*N:N`` (:func:`~csmom_tpu_torch.mesh.pinning.
slice_for_slot`), derived again at every spawn, respawn and roll of the
slot, so a replacement re-pins its predecessor's devices by
construction; the slice rides the worker's ``--device-slice``, its
ready report and the stats.  What the slice indexes follows the pool's
``device``: the visible cards for ``"cuda"`` (a slice past them makes
the worker raise at start), or ``N`` logical shards of a single device
(``"cpu"``, ``"cuda:0"``), as ``auto_mesh(n, device=...)`` reads it.
The router reads :meth:`ready_workers` per dispatch attempt, so the
routable set is the supervised set.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import subprocess
import sys
import threading

from csmom_tpu_torch.mesh.pinning import slice_for_slot
from csmom_tpu_torch.serve import health, proto
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["PoolConfig", "PoolSupervisor", "WorkerHandle", "pick_transport"]

# the checkout that owns this module: spawned workers run
# ``sys.executable -m csmom_tpu_torch...``, so the package must resolve in
# the child whatever the caller's cwd (a copied checkout included)
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# an AF_UNIX path holds at most 107 bytes (sun_path is 108 with its NUL);
# the longest name a slot takes is "w<slot>.g<generation>.sock"
_UNIX_PATH_MAX = 107
_LONGEST_SLOT_NAME = "w99.g9999.sock"


def pick_transport(run_dir: str) -> str:
    """``"unix"`` when every slot's socket path fits under ``run_dir``,
    else ``"tcp"`` (loopback ports): a long temporary directory must not
    make the pool unbindable."""
    path = os.path.join(run_dir, _LONGEST_SLOT_NAME)
    return "unix" if len(os.fsencode(path)) <= _UNIX_PATH_MAX else "tcp"


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Everything the supervisor needs to run one worker fleet."""

    n_workers: int = 2
    profile: str = "serve"
    engine: str = "torch"             # "torch" | "torch-mesh" | "stub"
    # the torch engines' device: "cuda" (the visible cards), or a single
    # device ("cpu", "cuda:0") whose logical shards a pinned slice counts
    device: str = "cuda"
    # wire transport for the fleet's sockets: "unix" (run-dir socket
    # files) or "tcp" (loopback ports)
    transport: str = "unix"
    capacity: int = 64
    max_wait_ms: float = 10.0
    deadline_ms: float = 500.0
    # > 0 pins slot k to the fixed device slice k*N:N; a replacement
    # spawned into the slot re-pins the same slice (mesh/pinning)
    devices_per_worker: int = 0
    # the warm-up report's subdirectory the workers read their evidence
    # from (build/csmom_tpu_torch/warmup/<cache_subdir>/)
    cache_subdir: str = "bench"
    require_warm_cache: bool = False
    expect_cache_version: str | None = None  # None = compute from health
    ready_timeout_s: float = 120.0
    poll_interval_s: float = 0.2
    backoff_base_s: float = 0.2
    backoff_cap_s: float = 5.0
    max_restarts: int = 5
    min_uptime_s: float = 2.0
    seed: int = 0


@dataclasses.dataclass
class WorkerHandle:
    """One supervised worker slot (the process may change; the slot
    persists across restarts and rolls)."""

    slot: int
    worker_id: str
    socket_path: str
    proc: subprocess.Popen | None = None
    state: str = "starting"   # starting | ready | draining | dead | failed
    # how the CURRENT process came to exist: cold | respawn | roll |
    # spare-promotion (ready walls are kept apart by kind)
    spawn_kind: str = "cold"
    generation: int = 0
    restarts: int = 0          # consecutive young deaths (resets on uptime)
    next_restart_at: float | None = None
    t_spawned_s: float = 0.0
    t_ready_s: float | None = None
    reason: str | None = None
    ready_report: dict | None = None
    log_path: str | None = None
    device_slice: str | None = None   # "<start>:<count>" when pinned


class PoolSupervisor:
    """Spawn and babysit N workers; expose the READY set to the router.

    The machinery is tier-agnostic: what a slot runs comes from
    :meth:`_slot_argv` and where it listens from :meth:`_slot_address`.
    The router-replica supervisor
    (:class:`csmom_tpu_torch.serve.fabric.RouterSupervisor`) overrides
    those two hooks and inherits spawn, demonstrated-ready probing,
    backoff restarts, crash-loop parking and rolling restarts unchanged.
    """

    slot_prefix = "w"   # worker ids are "<prefix><slot>"

    def __init__(self, config: PoolConfig, run_dir: str):
        if config.transport == "unix" and pick_transport(run_dir) != "unix":
            raise ValueError(
                f"run dir {run_dir!r} is too long for unix socket paths "
                f"({_UNIX_PATH_MAX} bytes): use a shorter run dir or "
                "transport='tcp' (pick_transport chooses)")
        self.config = config
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.expect_cache_version = (
            config.expect_cache_version
            or health.aot_cache_version(
                config.profile, engine=config.engine,
                mesh_devices=health.mesh_devices_of(
                    config.engine, config.device, config.devices_per_worker)))
        self.handles: list = []
        self.events: list = []      # [{t_s, event, worker_id, ...}]
        # merged last into every spawned process's environment: a caller
        # arms a chaos plan in one tier (the fabric's router replicas,
        # say) without arming it in its own process
        self.extra_env: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self._rng = random.Random(config.seed)
        self._t0 = mono_now_s()
        self.kills_observed = 0
        self.restarts_total = 0
        self.rolls_completed = 0
        # the elastic tier (serve/fleet.py) attaches here when armed:
        # death hooks run on the monitor thread before backoff or
        # parking, and a hook that returns True claims the death (a
        # spare promoted into the slot: no re-warm is scheduled)
        self.fleet = None
        self.death_hooks: list = []

    @property
    def t0_mono_s(self) -> float:
        """The monotonic instant this supervisor's event clock started:
        ``event["t_s"] + t0_mono_s`` puts lifecycle events on the
        timeline the fleet observatory samples on
        (``obs.fleet.absolute_events``)."""
        return self._t0

    def ready_walls(self) -> list:
        """Every (re)spawn's spawn -> ready wall with the worker-reported
        bind/warm walls, and the spawn kind it came by (``cold``,
        ``respawn``, ``roll``, ``spare-promotion``)."""
        with self._lock:
            return [{"worker_id": e["worker_id"],
                     "generation": e.get("generation"),
                     "kind": e.get("spawn_kind") or "cold",
                     "wall_s": e.get("wall_s"),
                     "walls": e.get("walls")}
                    for e in self.events if e["event"] == "ready"]

    # -------------------------------------------------------------- events

    def _event(self, event: str, worker_id: str, **ctx) -> None:
        rec = {"t_s": round(mono_now_s() - self._t0, 4), "event": event,
               "worker_id": worker_id, **ctx}
        with self._lock:
            self.events.append(rec)

    # --------------------------------------------------------------- spawn

    def _slot_address(self, slot: int, generation: int = 0) -> str:
        """Where the process in ``slot`` (at ``generation``) listens.
        Unix sockets are run-dir files; tcp binds a freshly probed
        loopback port per (slot, generation): a rolling replacement must
        not race its predecessor for the same port."""
        if self.config.transport == "tcp":
            return f"tcp:127.0.0.1:{proto.free_tcp_port()}"
        name = (f"{self.slot_prefix}{slot}.sock" if generation == 0
                else f"{self.slot_prefix}{slot}.g{generation}.sock")
        return os.path.join(self.run_dir, name)

    def _slot_argv(self, h: WorkerHandle) -> list:
        """The command a slot runs (the router tier overrides this)."""
        return self._worker_argv(h)

    def _worker_argv(self, h: WorkerHandle) -> list:
        c = self.config
        argv = [sys.executable, "-m", "csmom_tpu_torch.serve.worker",
                "--socket", h.socket_path,
                "--worker-id", h.worker_id,
                "--profile", c.profile,
                "--engine", c.engine,
                "--device", c.device,
                "--capacity", str(c.capacity),
                "--max-wait-ms", str(c.max_wait_ms),
                "--deadline-ms", str(c.deadline_ms),
                "--cache-subdir", c.cache_subdir,
                "--expect-cache-version", self.expect_cache_version,
                "--require-warm-cache" if c.require_warm_cache
                else "--no-require-warm-cache"]
        if h.device_slice:
            argv += ["--device-slice", h.device_slice]
        return argv

    def _spawn_env(self) -> dict:
        """The environment every worker runs under: this process's
        (fault plans and ``CUDA_VISIBLE_DEVICES`` included), with the
        checkout first on ``PYTHONPATH`` and :attr:`extra_env` merged
        last."""
        env = dict(os.environ)
        env["PYTHONPATH"] = (_PKG_ROOT + os.pathsep
                             + env.get("PYTHONPATH", ""))
        env.update(self.extra_env)
        return env

    def _spawn(self, h: WorkerHandle) -> None:
        from csmom_tpu_torch.chaos.inject import checkpoint

        checkpoint("pool.spawn", worker=h.worker_id, gen=h.generation)
        dpw = self.config.devices_per_worker
        if h.slot >= 0 and dpw > 0:
            # derived from the slot at every (re)spawn and roll: the
            # slot's devices, whatever process held them before
            h.device_slice = slice_for_slot(h.slot, dpw)
        h.log_path = os.path.join(
            self.run_dir, f"{h.worker_id}.g{h.generation}.log")
        env = self._spawn_env()
        log = open(h.log_path, "ab")
        try:
            h.proc = subprocess.Popen(
                self._slot_argv(h), stdout=log, stderr=log, env=env)
        finally:
            log.close()
        h.state = "starting"
        h.t_spawned_s = mono_now_s()
        h.t_ready_s = None
        h.ready_report = None
        self._event("spawn", h.worker_id, pid=h.proc.pid,
                    generation=h.generation, device_slice=h.device_slice)

    def _stderr_tail(self, h: WorkerHandle, n: int = 400) -> str:
        try:
            with open(h.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 4096))
                return f.read().decode("utf-8", "replace")[-n:].strip()
        except (OSError, TypeError):
            return ""

    def _probe_until_ready(self, h: WorkerHandle,
                           timeout_s: float) -> bool:
        """Poll readiness until ok / worker exit / timeout.  A worker
        that EXITS while starting is classified: a version-skew, cold
        build or missing-device refusal parks the slot as ``failed``
        (restart cannot fix any); anything else is a crash (restartable),
        its stderr tail kept as the reason."""
        from csmom_tpu_torch.serve.worker import (
            RC_COLD_CACHE, RC_NO_DEVICE, RC_VERSION_SKEW)

        give_up = mono_now_s() + timeout_s
        while mono_now_s() < give_up and not self._stop.is_set():
            rc = h.proc.poll()
            if rc is not None:
                tail = self._stderr_tail(h)
                if rc in (RC_VERSION_SKEW, RC_COLD_CACHE, RC_NO_DEVICE):
                    # a restart cannot fix skew, a cold build or a missing
                    # card: park the slot with the worker's own pointed
                    # message, no backoff loop, no build in the window
                    h.state = "failed"
                    h.reason = (
                        f"worker refused ready (rc={rc}): {tail}")
                    self._event("refused_ready", h.worker_id, rc=rc,
                                reason=tail[:200])
                else:
                    # a startup crash is a crash: same backoff/park
                    # machinery as a death in service
                    self._event("died_starting", h.worker_id, rc=rc,
                                stderr=tail[-200:])
                    self._on_death(h, mono_now_s())
                    h.reason = f"{h.reason}: {tail}"
                return False
            report = health.readiness(h.socket_path, timeout_s=2.0)
            if report.get("ok"):
                h.state = "ready"
                h.t_ready_s = mono_now_s()
                h.ready_report = report
                # wall_s is the supervisor-observed spawn→ready; "walls"
                # the worker's own bind/warm stamps from its ready report
                self._event("ready", h.worker_id,
                            generation=h.generation,
                            spawn_kind=h.spawn_kind,
                            fresh_compiles=report.get("fresh_compiles"),
                            wall_s=round(h.t_ready_s - h.t_spawned_s, 3),
                            walls=report.get("walls"))
                self._gauge_ready()
                return True
            self._stop.wait(self.config.poll_interval_s)
        if h.state == "starting":
            h.state = "failed"
            h.reason = f"never became ready within {timeout_s:.0f}s"
            self._event("ready_timeout", h.worker_id)
        return False

    # ----------------------------------------------------------- lifecycle

    def start(self, require_ready: bool = True) -> "PoolSupervisor":
        """Spawn the fleet and wait until every slot resolved (ready,
        failed, or scheduled for a backoff restart).  With
        ``require_ready`` (default), raises when NO worker became ready
        — an empty pool is a dead service, better to fail loudly at
        start; ``require_ready=False`` lets the monitor keep working a
        crash-looping fleet (the backoff tests drive this)."""
        for slot in range(self.config.n_workers):
            h = WorkerHandle(
                slot=slot, worker_id=f"{self.slot_prefix}{slot}",
                socket_path=self._slot_address(slot))
            self.handles.append(h)
            self._spawn(h)
        for h in self.handles:
            self._probe_until_ready(h, self.config.ready_timeout_s)
        if require_ready and not self.ready_workers():
            reasons = "; ".join(
                f"{h.worker_id}: {h.reason}" for h in self.handles)
            self.stop()
            raise RuntimeError(f"no worker became ready — {reasons}")
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="csmom-pool-monitor",
            daemon=True)
        self._monitor.start()
        return self

    def ready_workers(self) -> list:
        return [h for h in self.handles if h.state == "ready"]

    def retry_after_s(self) -> float | None:
        """The backoff-state retry hint for a fleet with NO ready worker:
        seconds until the NEXT scheduled restart could plausibly serve
        (its backoff delay plus the ready timeout's headroom is the
        caller's problem — the hint is the floor, not a promise).  None
        while any worker is ready (no hint needed) or when every slot is
        parked ``failed`` (retrying cannot help; redeploying can —
        callers should surface the park reason instead)."""
        now = mono_now_s()
        best = None
        for h in self.handles:
            if h.state == "ready":
                return None
            if h.state == "starting":
                # a spawn in flight: readiness is typically one probe
                # interval away
                cand = self.config.poll_interval_s
            elif h.state == "dead" and h.next_restart_at is not None:
                cand = max(self.config.poll_interval_s,
                           h.next_restart_at - now)
            else:
                continue  # parked/failed: no restart is coming
            best = cand if best is None else min(best, cand)
        return None if best is None else round(best, 3)

    def _gauge_ready(self) -> None:
        from csmom_tpu_torch.obs import metrics

        metrics.gauge("serve_pool.ready_workers").set(
            len(self.ready_workers()))

    # -------------------------------------------------------------- monitor

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            now = mono_now_s()
            for h in list(self.handles):
                if h.state == "ready" and h.proc.poll() is not None:
                    self._on_death(h, now)
                elif h.state == "dead" and h.next_restart_at is not None \
                        and now >= h.next_restart_at:
                    h.next_restart_at = None
                    self._restart(h)
            self._stop.wait(self.config.poll_interval_s)

    def _on_death(self, h: WorkerHandle, now: float) -> None:
        rc = h.proc.returncode
        uptime = now - (h.t_ready_s or h.t_spawned_s)
        young = uptime < self.config.min_uptime_s
        h.restarts = h.restarts + 1 if young else 1
        with self._lock:
            self.kills_observed += 1
        h.state = "dead"
        h.reason = f"died rc={rc} after {uptime:.2f}s"
        self._event("death", h.worker_id, rc=rc,
                    uptime_s=round(uptime, 3), young=young,
                    consecutive=h.restarts)
        self._gauge_ready()
        # the elastic tier's seam: a hook that promotes a hot spare into
        # the slot returns True and the re-warm below never runs
        for hook in list(self.death_hooks):
            try:
                if hook(h, now):
                    return
            except Exception as e:  # a broken hook must not kill the monitor
                self._event("death_hook_error", h.worker_id,
                            error=f"{type(e).__name__}: {e}"[:200])
        if h.restarts > self.config.max_restarts:
            h.state = "failed"
            h.reason = (f"crash loop: {h.restarts - 1} consecutive young "
                        f"deaths — parked (not hot-spinning a broken "
                        "worker)")
            self._event("crash_loop_parked", h.worker_id,
                        restarts=h.restarts - 1)
            return
        # exponential backoff with seeded ±50% jitter, capped
        base = min(self.config.backoff_cap_s,
                   self.config.backoff_base_s * (2 ** (h.restarts - 1)))
        delay = base * (1.0 + self._rng.uniform(-0.5, 0.5))
        h.next_restart_at = now + delay
        self._event("restart_scheduled", h.worker_id,
                    delay_s=round(delay, 3), backoff_base_s=round(base, 3))

    def _restart(self, h: WorkerHandle) -> None:
        h.generation += 1
        h.spawn_kind = "respawn"
        if self.config.transport == "tcp":
            # the crash may have BEEN a lost port race (or the port got
            # claimed while the slot was down): a replacement probes a
            # fresh port like a rolling replacement does — retrying the
            # dead port every backoff cycle can only crash-loop to
            # parked, even with unlimited free ports available
            h.socket_path = self._slot_address(h.slot, h.generation)
        with self._lock:
            self.restarts_total += 1
        self._spawn(h)
        threading.Thread(
            target=self._probe_until_ready,
            args=(h, self.config.ready_timeout_s), daemon=True).start()

    # ------------------------------------------------------------- rolling

    def rolling_restart(self) -> dict:
        """Replace every worker, one at a time, warm-before-ready.

        Per slot: spawn the replacement on a fresh socket; it must
        report READY — including zero fresh compiles — before the
        predecessor drains.  Returns a summary; ``aborted`` carries the
        first failure (the old worker keeps serving in that case)."""
        rolled, aborted = [], None
        for slot in range(len(self.handles)):
            old = self.handles[slot]
            if old.state != "ready":
                continue
            repl = WorkerHandle(
                slot=slot, worker_id=old.worker_id,
                socket_path=self._slot_address(slot, old.generation + 1),
                spawn_kind="roll",
                generation=old.generation + 1)
            self._event("roll_start", old.worker_id,
                        from_generation=old.generation,
                        to_generation=repl.generation)
            self._spawn(repl)
            if not self._probe_until_ready(repl,
                                           self.config.ready_timeout_s):
                aborted = (f"{repl.worker_id} g{repl.generation}: "
                           f"{repl.reason}")
                self._event("roll_aborted", old.worker_id,
                            reason=repl.reason)
                self._reap(repl)
                break
            # replacement is demonstrably warm: NOW drain the predecessor.
            # Swap before draining so the router's next pick sees the new
            # generation — zero-capacity gap by construction.
            self.handles[slot] = repl
            old.state = "draining"
            self._drain_stop(old)
            rolled.append({"worker_id": repl.worker_id,
                           "generation": repl.generation,
                           "fresh_compiles":
                               (repl.ready_report or {}).get(
                                   "fresh_compiles")})
            with self._lock:
                self.rolls_completed += 1
            self._event("roll_done", repl.worker_id,
                        generation=repl.generation)
        return {"rolled": rolled, "aborted": aborted}

    # ---------------------------------------------------------------- stop

    def _drain_stop(self, h: WorkerHandle, timeout_s: float = 15.0) -> None:
        stop_acked = False
        try:
            proto.request_once(h.socket_path, {"op": "stop"},
                          timeout_s=timeout_s)
            stop_acked = True
        except (OSError, proto.ProtocolError):
            pass  # dead, wedged, or mid-start (socket not bound yet)
        if h.proc is not None:
            try:
                # a worker that never acked the stop op (e.g. still
                # importing before its bind) gets only a short grace
                # before SIGTERM — its own handler drains on TERM
                h.proc.wait(timeout=timeout_s if stop_acked else 0.5)
            except subprocess.TimeoutExpired:
                h.proc.terminate()
                try:
                    h.proc.wait(timeout=3.0)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
        h.state = "dead" if h.state != "failed" else h.state
        self._event("stopped", h.worker_id, generation=h.generation)

    def _reap(self, h: WorkerHandle) -> None:
        if h.proc is not None and h.proc.poll() is None:
            h.proc.terminate()
            try:
                h.proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                h.proc.kill()

    def stop(self) -> None:
        """Drain-stop the fleet and the monitor (idempotent)."""
        fleet = self.fleet
        if fleet is not None:
            # the elastic tier first: no promotion, backfill or scaling
            # may race the drain (its stop is idempotent)
            fleet.stop()
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        for h in self.handles:
            if h.proc is not None and h.proc.poll() is None:
                self._drain_stop(h)

    # ---------------------------------------------------------------- info

    def kill_worker(self, worker_id: str, sig=signal.SIGKILL) -> bool:
        """Chaos hook: hard-kill one worker's CURRENT process (the
        rehearsal's worker-process death; the monitor sees it like any
        crash)."""
        for h in self.handles:
            if h.worker_id == worker_id and h.proc is not None \
                    and h.proc.poll() is None:
                os.kill(h.proc.pid, sig)
                self._event("chaos_kill", worker_id, sig=int(sig))
                return True
        return False

    def worker_stats(self) -> list:
        """Per-worker stats from every live worker (a corpse contributes
        its handle state and a reason instead — lost books are REPORTED,
        the router's accounting is the closed ledger)."""
        out = []
        for h in self.handles:
            rec = {"worker_id": h.worker_id, "state": h.state,
                   "generation": h.generation, "restarts": h.restarts,
                   "device_slice": h.device_slice}
            if h.t_ready_s is not None and h.t_spawned_s is not None:
                rec["lifecycle"] = {
                    "ready_wall_s": round(h.t_ready_s - h.t_spawned_s, 3),
                    "walls": (h.ready_report or {}).get("walls"),
                }
            if h.state == "ready":
                try:
                    obj, _ = proto.request_once(h.socket_path, {"op": "stats"},
                                           timeout_s=5.0)
                    rec.update({
                        "accounting": obj.get("accounting"),
                        "batches": obj.get("batches"),
                        "cache": obj.get("cache"),
                        "fresh_compiles": obj.get("fresh_compiles"),
                        "kernel_launches": obj.get("kernel_launches"),
                        "libraries_built_or_loaded":
                            obj.get("libraries_built_or_loaded"),
                    })
                except (OSError, proto.ProtocolError) as e:
                    rec["stats_error"] = f"{type(e).__name__}: {e}"[:120]
            elif h.reason:
                rec["reason"] = h.reason[:300]
            out.append(rec)
        return out

    def summary(self) -> dict:
        with self._lock:
            return {
                "n_workers": self.config.n_workers,
                "expect_cache_version": self.expect_cache_version,
                "kills": self.kills_observed,
                "restarts": self.restarts_total,
                "rolls_completed": self.rolls_completed,
                "events": list(self.events),
            }
