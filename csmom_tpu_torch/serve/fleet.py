"""The fleet's elastic tier: hot spares, the prefork warm path, autoscaling.

Counterpart of ``csmom_tpu.serve.fleet``, the tier above
:mod:`csmom_tpu_torch.serve.supervisor`.  A SIGKILLed worker costs its
slot's capacity while the replacement re-warms (on the card most of that
wall is ``import torch`` and the CUDA context); this tier pays for the
capacity before the outage instead:

- **Hot spares** (:class:`FleetController`): N pre-spawned workers,
  each demonstrated ready (every bucket shape warmed through the
  engine, K1 included), parked out of the hash ring and the routes
  file.  On a worker death the controller's death hook promotes a spare
  into the victim's slot (swap the handle, publish the routes), so the
  kill costs one failover instead of a re-warm; the pool backfills off
  the hot path.  Spare lifecycle lands in the supervisor's event book
  under ``spare_*`` names, which the serving consumers (kill windows,
  lifecycle walls, the router's ready set) never read, and the capacity
  account credits a parked spare as warm reserve
  (:func:`csmom_tpu_torch.obs.fleet.capacity_account`).
- **The prefork warm path** (:class:`PreforkServer`,
  ``python -m csmom_tpu_torch.serve.fleet``): a parent with torch and the
  serve stack imported (``serve.worker``, ``serve.service``,
  ``serve.engine``, ``registry.builtin``) and the engine's kernel
  libraries read into the page cache (read, never loaded), which forks
  each spare.  The parent never initializes CUDA (a child forked after
  the driver was touched cannot use the card): it calls nothing of
  ``torch.cuda`` but ``is_initialized``, loads no kernel library and runs
  no tensor op.  It runs with one native thread: its environment sets
  the BLAS and OpenMP pools to one thread before numpy loads, its accept
  loop is single-threaded, no fleet emitter is armed in it, and
  ``spawn`` refuses to fork while a second native thread is alive
  (``/proc/self/task``).  Its ``ping`` and ``spawn`` replies report
  ``cuda_initialized`` and ``native_threads``.  A child initializes its
  own CUDA context and arms its own emitter in ``worker.main``.
- **The demand-driven autoscaler** (:class:`AutoscalerPolicy` and the
  controller's loop): reads the fleet aggregator's trailing demand
  (``demand_recent_rps``), hysteresis-banded with sustain and cooldown,
  grows or shrinks the fleet within declared floor and ceiling, and
  tunes the ``bulk`` class's admission quota through the workers'
  ``tune_quota`` op.  While a worker warms (a scale-up or a respawn in
  flight) the loop asks the policy nothing: the policy counts ready
  workers, and a second scale-up before the first is ready would pass
  the ceiling.  Every decision, the reasoned holds included, lands
  in the ``fleet.elastic`` artifact block.

A forked child is the prefork parent's child, not the supervisor's:
:class:`_PreforkChild` polls it through the parent (``waitpid`` with
cached statuses), because ``os.kill(pid, 0)`` succeeds on a zombie, and
the parent reaps it.  Clock discipline: ``mono_now_s`` only.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import threading

from csmom_tpu_torch.serve import health, proto
from csmom_tpu_torch.serve.supervisor import WorkerHandle
from csmom_tpu_torch.utils.deadline import mono_now_s

__all__ = ["AutoscalerPolicy", "FleetConfig", "FleetController",
           "PreforkServer", "main", "native_threads"]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Everything the elastic tier needs, with declared bounds."""

    spares: int = 0                    # hot spares held in reserve
    prefork: bool = False              # spawn spares via the prefork parent
    autoscale: bool = False            # arm the demand control loop
    poll_interval_s: float = 0.2       # spare monitor cadence
    spare_ready_timeout_s: float = 120.0
    # -- autoscaler (hysteresis band on offered rps per ready worker) --
    autoscale_interval_s: float = 0.5
    demand_horizon_s: float = 2.0      # trailing window the rate reads
    high_rps_per_worker: float = 200.0
    low_rps_per_worker: float = 5.0
    sustain_s: float = 1.5             # band breach must persist this long
    cooldown_s: float = 5.0            # dead time after any action
    min_workers: int = 1               # declared floor (never shrink past)
    max_workers: int = 8               # declared ceiling (never grow past)
    # -- SLO-class quota auto-tune (bulk is the only quota'd class) -----
    quota_class: str = "bulk"
    quota_floor_rps: float = 8.0
    quota_ceiling_rps: float = 64.0
    quota_headroom: float = 1.25       # quota = headroom x offered rate
    quota_min_rel_change: float = 0.25  # retune only past this delta


# ------------------------------------------------------------- prefork ----

# what the parent imports before its first fork, by engine: torch and the
# serve stack a torch worker runs; the stub worker's stack has no torch
PREFORK_IMPORTS = {
    "torch": ("torch,csmom_tpu_torch.serve.worker,"
              "csmom_tpu_torch.serve.service,csmom_tpu_torch.serve.engine,"
              "csmom_tpu_torch.registry.builtin"),
    "stub": "csmom_tpu_torch.serve.worker",
}

# the parent's environment: the BLAS and OpenMP thread pools start with
# numpy's and torch's imports, so they are held to one thread before
# either loads (a fork copies only the forking thread; its children
# inherit these pools)
PREFORK_THREAD_ENV = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1",
                      "MKL_NUM_THREADS": "1"}


def native_threads() -> int:
    """This process's native threads (``/proc/self/task``), the Python
    interpreter's own and every library's."""
    return len(os.listdir("/proc/self/task"))


def _cuda_initialized() -> bool:
    """Whether this process initialized CUDA, asked without initializing
    it (False when torch was never imported)."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


class _PreforkChild:
    """``subprocess.Popen`` stand-in for a forked worker.

    The supervisor touches only ``pid`` / ``poll`` / ``wait`` /
    ``terminate`` / ``kill`` / ``returncode``.  ``poll`` asks the prefork
    parent (``waitpid`` with cached statuses), because ``os.kill(pid,
    0)`` succeeds on a zombie.  If the parent is gone, the child was
    reparented (and the parent reaped what it could at shutdown), so the
    signal probe is the fallback.
    """

    def __init__(self, pid: int, control_address: str):
        self.pid = pid
        self._address = control_address
        self.returncode: int | None = None

    def _probe_parent(self) -> dict:
        """One-shot liveness probe of the child through the parent's
        control socket (a fresh dial a probe: never a request path)."""
        obj, _ = proto.request_once(
            self._address, {"op": "poll", "pid": self.pid}, timeout_s=2.0)
        return obj

    def poll(self) -> int | None:
        if self.returncode is not None:
            return self.returncode
        try:
            rc = self._probe_parent().get("returncode")
            if rc is not None:
                self.returncode = int(rc)
        except (OSError, proto.ProtocolError):
            # the parent is gone: the probe by signal is the fallback
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                self.returncode = -1  # exited; its status went elsewhere
            except PermissionError:
                pass
        return self.returncode

    def wait(self, timeout: float | None = None) -> int:
        give_up = None if timeout is None else mono_now_s() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if give_up is not None and mono_now_s() >= give_up:
                raise subprocess.TimeoutExpired("prefork-child", timeout)
            threading.Event().wait(0.05)

    def _signal(self, sig) -> None:
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)


class PreforkServer:
    """The prefork parent (``python -m csmom_tpu_torch.serve.fleet``).

    Single-threaded: one accept loop, ops handled inline, ``fork`` with
    exactly one native thread alive.  Ops:

    - ``ping``     -> liveness, what was imported and prewarmed, the
      native thread count and ``cuda_initialized``;
    - ``spawn``    -> fork (refused while a second native thread is alive
      or CUDA is initialized); the child points stdio at the requested
      log, applies the environment overrides and runs
      ``serve.worker.main(argv)``;
    - ``poll``     -> ``waitpid(WNOHANG)`` with cached exit statuses;
    - ``shutdown`` -> reply, reap the children (SIGTERM, then SIGKILL
      after a grace), leave the loop.

    The loop also ends when the process that started the parent dies.
    """

    def __init__(self, address: str, preimport: str = "",
                 prewarm: str = ""):
        self.address = address
        self.preimport = [m for m in preimport.split(",") if m]
        self.prewarm = [p for p in prewarm.split(",") if p]
        self.imported: list = []
        self.prewarmed_bytes = 0
        self.prewarmed_files = 0
        self._children: dict = {}   # pid -> returncode | None
        self._listener = None
        self._conn = None
        self._stopping = False
        self._ppid = os.getppid()

    # ------------------------------------------------------------ warmup

    def warm(self) -> None:
        import importlib

        for mod in self.preimport:
            try:
                importlib.import_module(mod)
                self.imported.append(mod)
            except Exception as e:  # a missing engine dependency must not
                self.imported.append(f"{mod}!{type(e).__name__}")  # kill it
        for path in self.prewarm:
            self._prewarm_file(path)

    def _prewarm_file(self, path: str, budget_bytes: int = 1 << 29) -> None:
        """Read one file into the page cache (never ``dlopen``: a kernel
        library loaded here would be the parent's, and the CUDA runtime
        it links must not start before the fork)."""
        if self.prewarmed_bytes >= budget_bytes:
            return
        try:
            with open(path, "rb") as f:
                while f.read(1 << 20):
                    pass
            self.prewarmed_bytes += os.path.getsize(path)
            self.prewarmed_files += 1
        except OSError:
            pass

    # -------------------------------------------------------------- ops

    def _fork_state(self) -> dict:
        return {"native_threads": native_threads(),
                "cuda_initialized": _cuda_initialized()}

    def _op_spawn(self, obj: dict) -> dict:
        state = self._fork_state()
        if state["native_threads"] > 1 or state["cuda_initialized"]:
            return {"state": "rejected", **state,
                    "error": ("refusing to fork: "
                              + ("CUDA is initialized in the parent"
                                 if state["cuda_initialized"] else
                                 f"{state['native_threads']} native threads "
                                 "are alive (a fork copies only the forking "
                                 "one)"))}
        argv = list(obj.get("argv") or [])
        log_path = obj.get("log_path")
        env = obj.get("env") or {}
        pid = os.fork()
        if pid == 0:
            # the child: shed the parent's sockets, point stdio at the slot
            # log, then become the worker (never return)
            rc = 70  # EX_SOFTWARE unless the worker says otherwise
            try:
                for sock in (self._listener, self._conn):
                    if sock is not None:
                        sock.close()
                if log_path:
                    fd = os.open(log_path,
                                 os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                                 0o644)
                    os.dup2(fd, 1)
                    os.dup2(fd, 2)
                    os.close(fd)
                os.environ.update({str(k): str(v) for k, v in env.items()})
                from csmom_tpu_torch.serve import worker as worker_mod

                rc = worker_mod.main(argv)
            except SystemExit as e:
                rc = (e.code if isinstance(e.code, int)
                      else 0 if e.code is None else 1)
            except BaseException:
                import traceback

                traceback.print_exc()
            finally:
                # the child must never unwind into the parent's stack
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(int(rc or 0) & 0xFF)
        self._children[pid] = None
        return {"state": "ok", "pid": pid, **state}

    def _reap(self, pid: int):
        rc = self._children.get(pid)
        if rc is None and pid in self._children:
            try:
                done, status = os.waitpid(pid, os.WNOHANG)
                if done == pid:
                    rc = (os.WEXITSTATUS(status) if os.WIFEXITED(status)
                          else -os.WTERMSIG(status))
                    self._children[pid] = rc
            except ChildProcessError:
                rc = -1  # not ours or already reaped: report it exited
                self._children[pid] = rc
        return rc

    def _op_poll(self, obj: dict) -> dict:
        return {"state": "ok", "returncode": self._reap(int(obj.get("pid", -1)))}

    def _reap_all(self, grace_s: float = 5.0) -> None:
        """At shutdown: every child still running gets SIGTERM (a worker
        drains on it), then SIGKILL after ``grace_s``; all are reaped."""
        live = [p for p in self._children if self._reap(p) is None]
        for pid in live:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        give_up = mono_now_s() + grace_s
        while live and mono_now_s() < give_up:
            live = [p for p in live if self._reap(p) is None]
            if live:
                threading.Event().wait(0.05)
        for pid in live:
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                pass

    def handle(self, obj: dict) -> dict:
        op = obj.get("op")
        if op == "ping":
            return {"state": "ok", "pid": os.getpid(),
                    "imported": list(self.imported),
                    "prewarmed_bytes": self.prewarmed_bytes,
                    "prewarmed_files": self.prewarmed_files,
                    "children": len(self._children),
                    **self._fork_state()}
        if op == "spawn":
            return self._op_spawn(obj)
        if op == "poll":
            return self._op_poll(obj)
        if op == "shutdown":
            self._stopping = True
            return {"state": "ok"}
        return {"state": "rejected", "error": f"unknown op {op!r}"}

    # ------------------------------------------------------------- loop

    def run(self) -> int:
        self._listener = proto.listen(self.address)
        self._listener.settimeout(0.25)
        try:
            while not self._stopping:
                if os.getppid() != self._ppid:
                    break  # the process that started us is gone
                try:
                    conn, _addr = self._listener.accept()
                except TimeoutError:
                    continue
                except OSError:
                    break
                self._conn = conn
                try:
                    conn.settimeout(5.0)
                    msg = proto.recv_msg(conn, deadline_s=5.0)
                    if msg is None:
                        continue
                    obj, _arrays = msg
                    obj.pop("_mux", None)
                    proto.send_msg(conn, self.handle(obj))
                except (OSError, proto.ProtocolError):
                    pass  # a broken client must not kill the parent
                finally:
                    self._conn = None
                    try:
                        conn.close()
                    except OSError:
                        pass
        finally:
            try:
                self._listener.close()
            except OSError:
                pass
            proto.unlink_address(self.address)
            self._reap_all()
        return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="csmom_tpu_torch.serve.fleet",
        description="prefork parent for serve workers: imports the serve "
                    "stack, never initializes CUDA, forks workers on request")
    ap.add_argument("--socket", required=True,
                    help="control address (unix path or tcp:host:port)")
    ap.add_argument("--preimport", default=PREFORK_IMPORTS["stub"],
                    help="comma-separated modules to import before the first "
                         "fork (never initializes CUDA)")
    ap.add_argument("--prewarm", default="",
                    help="comma-separated files (the engine's kernel "
                         "libraries) to read into the page cache before the "
                         "first fork, without loading them")
    args = ap.parse_args(argv)
    srv = PreforkServer(args.socket, preimport=args.preimport,
                        prewarm=args.prewarm)
    srv.warm()
    print(f"[prefork] pid {os.getpid()} imported {srv.imported}, prewarmed "
          f"{srv.prewarmed_files} file(s) ({srv.prewarmed_bytes} bytes), "
          f"{native_threads()} native thread(s), cuda initialized "
          f"{_cuda_initialized()}", file=sys.stderr, flush=True)
    return srv.run()


# ---------------------------------------------------------- autoscaler ----

class AutoscalerPolicy:
    """Pure hysteresis-banded scaling policy (no clocks, no I/O).

    ``decide(now_s, offered_rps, n_ready)`` returns one reasoned decision
    a tick: ``scale_up`` / ``scale_down`` / ``hold``, always with a
    ``reason``.  A band breach must sustain (``sustain_s``) before it
    acts, every action starts a cooldown, and the floor and ceiling are
    hard bounds.  The clock is an argument, so tests drive synthetic
    demand without sleeping.
    """

    def __init__(self, *, high_rps_per_worker: float,
                 low_rps_per_worker: float, sustain_s: float,
                 cooldown_s: float, min_workers: int, max_workers: int):
        if low_rps_per_worker >= high_rps_per_worker:
            raise ValueError("hysteresis band inverted: low >= high")
        self.high = float(high_rps_per_worker)
        self.low = float(low_rps_per_worker)
        self.sustain_s = float(sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self._above_since: float | None = None
        self._below_since: float | None = None
        self._cooldown_until: float | None = None

    def _decision(self, now_s, action, reason, rps, n_ready) -> dict:
        return {"t_s": round(float(now_s), 4), "action": action,
                "reason": reason, "offered_rps": round(float(rps), 3),
                "n_ready": int(n_ready)}

    def decide(self, now_s: float, offered_rps: float,
               n_ready: int) -> dict:
        per = offered_rps / max(1, n_ready)

        def mk(action, reason):
            return self._decision(now_s, action, reason, offered_rps, n_ready)

        if self._cooldown_until is not None:
            if now_s < self._cooldown_until:
                return mk("hold", f"cooldown: {self._cooldown_until - now_s:.1f}s "
                                  "until the last action's dead time ends")
            self._cooldown_until = None
        if per > self.high:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now_s
            held = now_s - self._above_since
            if held < self.sustain_s:
                return mk("hold", f"{per:.1f} rps/worker above high "
                                  f"watermark {self.high:.0f}, sustaining "
                                  f"({held:.1f}/{self.sustain_s:.1f}s)")
            self._above_since = None
            if n_ready >= self.max_workers:
                return mk("hold", f"sustained burst ({per:.1f} rps/worker) "
                                  f"but at declared ceiling "
                                  f"{self.max_workers} workers")
            self._cooldown_until = now_s + self.cooldown_s
            return mk("scale_up", f"{per:.1f} rps/worker > high watermark "
                                  f"{self.high:.0f} sustained "
                                  f"{self.sustain_s:.1f}s")
        if per < self.low:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now_s
            held = now_s - self._below_since
            if held < self.sustain_s:
                return mk("hold", f"{per:.1f} rps/worker below low "
                                  f"watermark {self.low:.0f}, sustaining "
                                  f"({held:.1f}/{self.sustain_s:.1f}s)")
            self._below_since = None
            if n_ready <= self.min_workers:
                return mk("hold", f"drained ({per:.1f} rps/worker) but at "
                                  f"declared floor {self.min_workers} "
                                  "workers")
            self._cooldown_until = now_s + self.cooldown_s
            return mk("scale_down", f"{per:.1f} rps/worker < low watermark "
                                    f"{self.low:.0f} sustained "
                                    f"{self.sustain_s:.1f}s")
        self._above_since = self._below_since = None
        return mk("hold", f"{per:.1f} rps/worker inside hysteresis band "
                          f"[{self.low:.0f}, {self.high:.0f}]")


# ---------------------------------------------------------- controller ----

class FleetController:
    """Owns the spare pool, the promotion seam and the control loop.

    Attaches to a running :class:`~csmom_tpu_torch.serve.supervisor.
    PoolSupervisor` as ``wsup.fleet`` and registers a death hook.  Spare
    lifecycle lands in the supervisor's event book under ``spare_*``
    names, so ``summary()["events"]`` -> ``absolute_events`` -> the fleet
    artifact carries it, and the serving consumers, which filter by
    event name, never see a spare.
    """

    def __init__(self, wsup, config: FleetConfig, publisher=None,
                 aggregator=None):
        self.wsup = wsup
        self.config = config
        self.publisher = publisher    # RoutesPublisher | None (pool mode)
        self.aggregator = aggregator  # FleetAggregator | None
        self.spares: list = []        # parked WorkerHandles, not in wsup
        self.promotions: list = []
        self.promotions_missed = 0
        self.decisions: list = []
        self.quota_applied: list = []
        self.counts = {"spawned": 0, "ready": 0, "promoted": 0,
                       "backfills": 0, "died_parked": 0}
        self._all_spare_ids: list = []
        self._spare_seq = 0
        self._lock = threading.Lock()
        self._backfill_lock = threading.Lock()
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None
        self._prefork_proc = None
        self._prefork_address: str | None = None
        self._policy = AutoscalerPolicy(
            high_rps_per_worker=config.high_rps_per_worker,
            low_rps_per_worker=config.low_rps_per_worker,
            sustain_s=config.sustain_s, cooldown_s=config.cooldown_s,
            min_workers=config.min_workers,
            max_workers=config.max_workers) if config.autoscale else None
        self._quota_current: float | None = None
        self._quota_cooldown_until: float | None = None
        self._last_hold_reason: str | None = None

    # ------------------------------------------------------------ prefork

    def _address(self, name: str) -> str:
        """A control or spare address in the supervisor's transport."""
        if self.wsup.config.transport == "tcp":
            return f"tcp:127.0.0.1:{proto.free_tcp_port()}"
        return os.path.join(self.wsup.run_dir, f"{name}.sock")

    def _start_prefork(self) -> None:
        c = self.wsup.config
        self._prefork_address = self._address("prefork")
        engine = "stub" if c.engine == "stub" else "torch"
        argv = [sys.executable, "-m", "csmom_tpu_torch.serve.fleet",
                "--socket", self._prefork_address,
                "--preimport", PREFORK_IMPORTS[engine]]
        if engine == "torch":
            # the engine's kernel libraries, read into the page cache
            from csmom_tpu_torch.ops import build
            from csmom_tpu_torch.serve.engine import KERNELS

            argv += ["--prewarm",
                     ",".join(str(build.library_path(n)) for n in KERNELS)]
        env = {**self.wsup._spawn_env(), **PREFORK_THREAD_ENV}
        log_path = os.path.join(self.wsup.run_dir, "prefork.log")
        log = open(log_path, "ab")
        try:
            self._prefork_proc = subprocess.Popen(
                argv, stdout=log, stderr=log, env=env)
        finally:
            log.close()
        give_up = mono_now_s() + 60.0
        last_err = "never pinged"
        while mono_now_s() < give_up:
            if self._prefork_proc.poll() is not None:
                last_err = f"exited rc={self._prefork_proc.returncode}"
                break
            try:
                obj = self._probe_prefork()
                if obj.get("state") == "ok":
                    self.wsup._event(
                        "prefork_ready", "prefork", pid=obj.get("pid"),
                        imported=obj.get("imported"),
                        prewarmed_bytes=obj.get("prewarmed_bytes"),
                        prewarmed_files=obj.get("prewarmed_files"),
                        native_threads=obj.get("native_threads"),
                        cuda_initialized=obj.get("cuda_initialized"))
                    return
            except (OSError, proto.ProtocolError) as e:
                last_err = f"{type(e).__name__}: {e}"[:120]
            self._stop.wait(0.1)
        # spares fall back to plain spawns rather than fail the fleet
        self.wsup._event("prefork_failed", "prefork", reason=last_err)
        self._stop_prefork()

    def _probe_prefork(self) -> dict:
        """One-shot readiness probe of the prefork parent (a fresh dial:
        the control socket is not a request path)."""
        obj, _ = proto.request_once(self._prefork_address,
                                    {"op": "ping"}, timeout_s=2.0)
        return obj

    def _prefork_admin(self, obj: dict, timeout_s: float = 2.0) -> dict:
        """One-shot admin op (spawn, shutdown) to the prefork parent."""
        out, _ = proto.request_once(self._prefork_address, obj,
                                    timeout_s=timeout_s)
        return out

    def _stop_prefork(self) -> None:
        proc, self._prefork_proc = self._prefork_proc, None
        if proc is None:
            return
        try:
            self._prefork_admin({"op": "shutdown"})
        except (OSError, proto.ProtocolError):
            pass
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5.0)

    # ------------------------------------------------------------- spares

    def _spawn_spare(self, kind: str = "spare") -> WorkerHandle | None:
        """Spawn one spare and probe it to demonstrated ready (blocking).
        The spare is a full worker on its own socket; it enters the
        routes only when promoted."""
        with self._lock:
            seq = self._spare_seq
            self._spare_seq += 1
        sid = f"s{seq}"
        h = WorkerHandle(slot=-1, worker_id=sid,
                         socket_path=self._address(sid))
        h.log_path = os.path.join(self.wsup.run_dir, f"{sid}.g0.log")
        h.spawn_kind = "spare"
        argv = self.wsup._worker_argv(h)
        t_spawn = mono_now_s()
        spawned_via = "popen"
        fork_state: dict = {}
        if self._prefork_proc is not None \
                and self._prefork_proc.poll() is None:
            try:
                obj = self._prefork_admin(
                    {"op": "spawn", "argv": argv[3:],
                     "log_path": h.log_path}, timeout_s=5.0)
                fork_state = {k: obj.get(k) for k in ("native_threads",
                                                      "cuda_initialized")}
                if obj.get("state") == "ok":
                    h.proc = _PreforkChild(int(obj["pid"]),
                                           self._prefork_address)
                    spawned_via = "prefork"
                else:
                    self.wsup._event("prefork_refused", sid,
                                     error=obj.get("error"), **fork_state)
            except (OSError, proto.ProtocolError):
                pass
        if h.proc is None:
            log = open(h.log_path, "ab")
            try:
                h.proc = subprocess.Popen(argv, stdout=log, stderr=log,
                                          env=self.wsup._spawn_env())
            finally:
                log.close()
        h.t_spawned_s = t_spawn
        with self._lock:
            self.counts["spawned"] += 1
            self._all_spare_ids.append(sid)
        self.wsup._event("spare_spawn", sid, pid=h.proc.pid, via=spawned_via,
                         kind=kind, **fork_state)
        give_up = t_spawn + self.config.spare_ready_timeout_s
        while mono_now_s() < give_up and not self._stop.is_set():
            rc = h.proc.poll()
            if rc is not None:
                self.wsup._event("spare_death", sid, rc=rc, phase="starting")
                with self._lock:
                    self.counts["died_parked"] += 1
                return None
            report = health.readiness(h.socket_path, timeout_s=2.0)
            if report.get("ok"):
                h.state = "ready"
                h.t_ready_s = mono_now_s()
                h.ready_report = report
                with self._lock:
                    self.counts["ready"] += 1
                self.wsup._event(
                    "spare_ready", sid, via=spawned_via,
                    fresh_compiles=report.get("fresh_compiles"),
                    wall_s=round(h.t_ready_s - t_spawn, 3),
                    walls=report.get("walls"))
                return h
            self._stop.wait(self.wsup.config.poll_interval_s)
        self.wsup._event("spare_ready_timeout", sid)
        self.wsup._reap(h)
        return None

    def _fill_pool(self, target: int, kind: str) -> None:
        """Grow the parked pool to ``target`` ready spares (serialized by
        the backfill lock, so racing deaths do not double-spawn; nothing
        on a request path takes it)."""
        with self._backfill_lock:
            while not self._stop.is_set():
                with self._lock:
                    if len(self.spares) >= target:
                        return
                # the backfill lock exists to serialize slow spawns:
                # nothing on a request path contends it (only the fill
                # and backfill threads), so blocking under it is the
                # design, not a hidden wait
                # lint: allow[lock-order] backfill lock serializes slow spawns by design
                h = self._spawn_spare(kind=kind)
                if h is None:
                    return  # failed: stay short rather than hot-spin
                with self._lock:
                    self.spares.append(h)

    def _backfill_async(self) -> None:
        with self._lock:
            self.counts["backfills"] += 1
        self.wsup._event("spare_backfill", "fleet",
                         pool=len(self.spares),
                         target=self.config.spares)
        threading.Thread(target=self._fill_pool,
                         args=(self.config.spares, "backfill"),
                         name="csmom-fleet-backfill", daemon=True).start()

    # ---------------------------------------------------------- promotion

    def _on_worker_death(self, victim: WorkerHandle, t_kill: float) -> bool:
        """The supervisor's death hook: promote a parked spare into the
        victim's slot.  True claims the death (no backoff re-warm); False
        hands the slot back to the supervisor (no spare left, or every
        parked spare was dead too)."""
        if self._stop.is_set():
            return False
        while True:
            with self._lock:
                spare = None
                for i, s in enumerate(self.spares):
                    if s.state == "ready":
                        spare = self.spares.pop(i)
                        break
            if spare is None:
                with self._lock:
                    self.promotions_missed += 1
                self.wsup._event("spare_promotion_missed",
                                 victim.worker_id,
                                 reason="no ready spare parked")
                return False
            # demonstrated ready at promotion time, not just at spawn: a
            # spare that died parked falls through to the next one
            if spare.proc.poll() is not None \
                    or not health.readiness(spare.socket_path,
                                            timeout_s=2.0).get("ok"):
                self.wsup._event("spare_death", spare.worker_id,
                                 rc=spare.proc.poll(), phase="parked")
                with self._lock:
                    self.counts["died_parked"] += 1
                continue
            break
        t0 = self.wsup.t0_mono_s
        with self._lock:
            victim.proc = spare.proc
            victim.socket_path = spare.socket_path
            victim.log_path = spare.log_path
            victim.generation += 1
            victim.spawn_kind = "spare-promotion"
            victim.restarts = 0
            victim.t_spawned_s = t_kill
            victim.t_ready_s = mono_now_s()
            victim.ready_report = spare.ready_report
            victim.state = "ready"
            victim.reason = None
            victim.next_restart_at = None
            self.counts["promoted"] += 1
            wall = victim.t_ready_s - t_kill
            self.promotions.append({
                "victim": victim.worker_id,
                "spare": spare.worker_id,
                "generation": victim.generation,
                "t_kill_s": round(t_kill - t0, 4),
                "t_ready_s": round(victim.t_ready_s - t0, 4),
                "wall_s": round(wall, 4),
            })
        self.wsup._event("spare_promoted", spare.worker_id,
                         victim=victim.worker_id,
                         generation=victim.generation)
        # the promotion is the victim slot's ready transition: one
        # lifecycle sample of kind spare-promotion, closing the kill
        # window of the capacity account
        self.wsup._event(
            "ready", victim.worker_id, generation=victim.generation,
            spawn_kind="spare-promotion",
            fresh_compiles=(victim.ready_report or {}).get(
                "fresh_compiles"),
            wall_s=round(wall, 3),
            walls=(victim.ready_report or {}).get("walls"))
        self.wsup._gauge_ready()
        if self.publisher is not None:
            # routable one routes publish away: O(publish), not O(re-warm)
            try:
                self.publisher.publish_once()
            except OSError:
                pass  # the interval publisher retries on its own clock
        self._backfill_async()
        return True

    # -------------------------------------------------------- autoscaling

    def _record_decision(self, d: dict) -> None:
        """Actions always land; a hold lands only when its reason
        changes (the elastic block stays reasoned, not flooded)."""
        with self._lock:
            if d["action"] == "hold":
                if d["reason"] == self._last_hold_reason:
                    return
                self._last_hold_reason = d["reason"]
            else:
                self._last_hold_reason = None
            self.decisions.append(d)

    def _scale_up(self) -> None:
        wsup = self.wsup
        slot = len(wsup.handles)
        h = WorkerHandle(slot=slot,
                         worker_id=f"{wsup.slot_prefix}{slot}",
                         socket_path=wsup._slot_address(slot))
        wsup.handles.append(h)
        wsup._spawn(h)
        threading.Thread(target=wsup._probe_until_ready,
                         args=(h, wsup.config.ready_timeout_s),
                         daemon=True).start()

    def _scale_down(self) -> None:
        wsup = self.wsup
        victim = None
        for h in reversed(wsup.handles):
            if h.state == "ready":
                victim = h
                break
        if victim is None:
            return
        victim.state = "draining"
        self.wsup._event("scale_down_drain", victim.worker_id,
                         generation=victim.generation)
        threading.Thread(target=wsup._drain_stop, args=(victim,),
                         daemon=True).start()

    def _admin_tune_quota(self, now_rel: float, offered_rps: float) -> None:
        """One-shot ``tune_quota`` to each ready worker (a fresh dial:
        a retune must not ride a channel the request path may sever)."""
        c = self.config
        desired = min(c.quota_ceiling_rps,
                      max(c.quota_floor_rps,
                          offered_rps * c.quota_headroom))
        if self._quota_cooldown_until is not None \
                and mono_now_s() < self._quota_cooldown_until:
            return
        cur = self._quota_current
        if cur is not None and cur > 0 \
                and abs(desired - cur) / cur < c.quota_min_rel_change:
            return
        applied_to = []
        for h in self.wsup.ready_workers():
            try:
                obj, _ = proto.request_once(
                    h.socket_path,
                    {"op": "tune_quota", "slo_class": c.quota_class,
                     "quota_rps": desired,
                     "quota_burst": desired * 1.5}, timeout_s=2.0)
                if obj.get("state") == "ok":
                    applied_to.append(h.worker_id)
            except (OSError, proto.ProtocolError):
                pass
        if not applied_to:
            return
        self._quota_current = desired
        self._quota_cooldown_until = mono_now_s() + c.cooldown_s
        rec = {"t_s": round(now_rel, 4), "slo_class": c.quota_class,
               "quota_rps": round(desired, 3),
               "applied_to": applied_to}
        with self._lock:
            self.quota_applied.append(rec)
        self._record_decision({
            "t_s": round(now_rel, 4), "action": "tune_quota",
            "reason": (f"{c.quota_class} offered {offered_rps:.1f} rps → "
                       f"quota {desired:.1f} rps (headroom "
                       f"{c.quota_headroom}×, within "
                       f"[{c.quota_floor_rps:.0f}, "
                       f"{c.quota_ceiling_rps:.0f}])"),
            "offered_rps": round(offered_rps, 3),
            "n_ready": len(self.wsup.ready_workers())})

    def _autoscale_tick(self) -> None:
        agg = self.aggregator
        if agg is None or self._policy is None:
            return
        now = mono_now_s()
        now_rel = now - self.wsup.t0_mono_s
        rps = agg.demand_recent_rps(self.config.demand_horizon_s)
        n_ready = len(self.wsup.ready_workers())
        warming = [h.worker_id for h in self.wsup.handles
                   if h.state == "starting"]
        if warming:
            # the policy counts ready workers; while one warms, another
            # scale-up would pass the ceiling it cannot see (a cold worker
            # outlasts the cooldown on the card), so no decision is asked
            # until the fleet's size is settled
            d = {"t_s": round(now_rel, 4), "action": "hold",
                 "reason": (f"{', '.join(warming)} warming: no scaling "
                            "decision until the fleet's size settles"),
                 "offered_rps": round(float(rps), 3), "n_ready": n_ready}
        else:
            d = self._policy.decide(now, rps, n_ready)
            d = dict(d, t_s=round(now_rel, 4))
        self._record_decision(d)
        if d["action"] == "scale_up":
            self._scale_up()
        elif d["action"] == "scale_down":
            self._scale_down()
        cls_rps = agg.demand_recent_rps(self.config.demand_horizon_s,
                                        slo_class=self.config.quota_class)
        self._admin_tune_quota(now_rel, cls_rps)

    # --------------------------------------------------------------- loop

    def _loop(self) -> None:
        next_autoscale = mono_now_s()
        while not self._stop.is_set():
            # parked spares must be live spares: a corpse in the pool
            # would promote nothing
            dead = []
            with self._lock:
                parked = list(self.spares)
            for s in parked:
                if s.state == "ready" and s.proc.poll() is not None:
                    dead.append(s)
            for s in dead:
                with self._lock:
                    if s in self.spares:
                        self.spares.remove(s)
                    self.counts["died_parked"] += 1
                self.wsup._event("spare_death", s.worker_id,
                                 rc=s.proc.poll(), phase="parked")
                self._backfill_async()
            if self.config.autoscale \
                    and mono_now_s() >= next_autoscale:
                next_autoscale = (mono_now_s()
                                  + self.config.autoscale_interval_s)
                try:
                    self._autoscale_tick()
                except Exception as e:  # the loop must outlive a bad tick
                    self.wsup._event("autoscale_error", "fleet",
                                     error=f"{type(e).__name__}: {e}"[:200])
            self._stop.wait(self.config.poll_interval_s)

    # ---------------------------------------------------------- lifecycle

    def start(self, wait_ready: bool = True) -> "FleetController":
        if self.config.prefork:
            self._start_prefork()
        if self.config.spares > 0:
            if wait_ready:
                self._fill_pool(self.config.spares, "initial")
            else:
                threading.Thread(target=self._fill_pool,
                                 args=(self.config.spares, "initial"),
                                 daemon=True).start()
        self.wsup.death_hooks.append(self._on_worker_death)
        self.wsup.fleet = self
        self._loop_thread = threading.Thread(
            target=self._loop, name="csmom-fleet-controller", daemon=True)
        self._loop_thread.start()
        return self

    def stop(self) -> None:
        """Teardown, idempotent: unhook, stop the loop, drain the parked
        spares and every serving worker the prefork parent forked (a
        promoted spare: its status is the parent's to reap), then shut
        the parent down, which reaps the rest."""
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self.wsup.death_hooks.remove(self._on_worker_death)
        except ValueError:
            pass
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=3.0)
        with self._backfill_lock:
            with self._lock:
                parked, self.spares = list(self.spares), []
        for s in parked:
            self.wsup._drain_stop(s)
            self.wsup._event("spare_stopped", s.worker_id)
        for h in list(self.wsup.handles):
            if isinstance(h.proc, _PreforkChild) and h.proc.poll() is None:
                # the supervisor's monitor still runs: a handle left
                # "ready" whose process exits would be booked a death
                # (and a kill window) and respawned mid-teardown
                h.state = "draining"
                self.wsup._drain_stop(h)
        self._stop_prefork()

    # ------------------------------------------------------------ summary

    def summary(self) -> dict:
        """The ``fleet.elastic`` block (validated by
        ``chaos/invariants._validate_fleet_elastic``)."""
        c = self.config
        with self._lock:
            return {
                "armed": True,
                "spares_configured": c.spares,
                "prefork": bool(self._prefork_address is not None),
                "autoscale": c.autoscale,
                "spare_ids": list(self._all_spare_ids),
                "spares": dict(self.counts),
                "promotions": [dict(p) for p in self.promotions],
                "promotions_missed": self.promotions_missed,
                "decisions": [dict(d) for d in self.decisions],
                "quota": {
                    "slo_class": c.quota_class,
                    "floor_rps": c.quota_floor_rps,
                    "ceiling_rps": c.quota_ceiling_rps,
                    "applied": [dict(q) for q in self.quota_applied],
                },
                "bounds": {"min_workers": c.min_workers,
                           "max_workers": c.max_workers},
            }


if __name__ == "__main__":
    sys.exit(main())
