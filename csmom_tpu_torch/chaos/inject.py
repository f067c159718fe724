"""Checkpoint runtime: where armed fault plans actually fire.

Counterpart of ``csmom_tpu.chaos.inject``, copied.  Instrumentation
points call ``checkpoint("serve.dispatch", kind=...)``.  Unarmed (no
``CSMOM_FAULT_PLAN`` and no ``CSMOM_TELEMETRY`` in the environment) the
call is two ``os.environ`` membership tests.  Armed, the active plan is
parsed once per process and each visit is counted per checkpoint name;
faults whose (point pattern, role, hit window) match execute their
action.  With run telemetry armed (:mod:`csmom_tpu_torch.obs`) every
visit is also a durationless point in the event stream, recorded before
any fault fires.

Self-executing actions (kill / exit / sleep / trip_deadline / clock_skew
/ corrupt_file / truncate_file / stdout_noise) happen inside the call;
``raise_oserror`` raises ``OSError`` into the caller; ``fail`` returns
the string ``"fail"`` for points whose failure mode is a result.  The
point names are :data:`csmom_tpu_torch.chaos.plan.KNOWN_POINTS`.

The ``serve.*`` points run in the signal service's own threads, where a
process-fatal action takes the whole service down; the in-process
worker crash is the ``fail`` action at ``serve.dispatch`` (the batch
ends ``rejected`` and the queue still drains).
"""

from __future__ import annotations

import glob
import os
import random
import sys
import threading
import time

from csmom_tpu_torch.chaos.plan import PLAN_ENV, current_role, load_active_plan

__all__ = ["checkpoint", "reset"]

# csmom_tpu_torch.obs.spans.ENV_STREAM, spelled out so the unarmed fast path
# never imports the obs package just to read one constant
_OBS_ENV = "CSMOM_TELEMETRY"


def _obs_point(point: str, ctx: dict) -> None:
    """Mirror a checkpoint visit into the armed telemetry stream.

    No-op (after the lazy import) in processes that inherited the env
    var but never armed a collector; never raises — observability must
    not become a new fault injector."""
    try:
        from csmom_tpu_torch.obs import spans as _spans

        if _spans._COLLECTOR is not None:
            _spans.point(f"chaos.{point}", **ctx)
    except Exception:
        pass

_STATE_LOCK = threading.Lock()
_PLAN = None
_PLAN_LOADED = False
_HITS: dict = {}


def reset() -> None:
    """Forget the cached plan and hit counters (tests re-arm per case)."""
    global _PLAN, _PLAN_LOADED
    with _STATE_LOCK:
        _PLAN = None
        _PLAN_LOADED = False
        _HITS.clear()


def _plan():
    global _PLAN, _PLAN_LOADED
    if not _PLAN_LOADED:
        with _STATE_LOCK:
            if not _PLAN_LOADED:
                _PLAN = load_active_plan()
                _PLAN_LOADED = True
    return _PLAN


def checkpoint(point: str, **ctx) -> str | None:
    """Visit an instrumentation point; fire any matching armed faults.

    Returns the last fired action name (``"fail"`` is the one callers
    branch on), or None when nothing fired.  Unarmed cost: two environ
    lookups (fault plan + telemetry).
    """
    if os.environ.get(_OBS_ENV, "0") not in ("", "0"):
        # telemetry first, fault second: a kill/exit fault must not erase
        # the evidence that its checkpoint was reached
        _obs_point(point, ctx)
    if PLAN_ENV not in os.environ:
        return None
    plan = _plan()
    if plan is None or not plan.faults:
        return None
    with _STATE_LOCK:
        hit = _HITS.get(point, 0)
        _HITS[point] = hit + 1
    role = current_role()
    fired = None
    for i, fault in enumerate(plan.faults):
        if fault.matches(point, hit, role):
            if fault.global_once and not _claim_global(plan, i):
                continue  # another process in the tree already fired this
            _execute(fault, plan.seed + i, point, ctx)
            fired = fault.action
    return fired


def _claim_global(plan, fault_index: int) -> bool:
    """Atomically claim a tree-wide single firing of fault ``fault_index``.

    The claim is an ``O_CREAT | O_EXCL`` marker file in
    ``CSMOM_FAULT_STATE``, which the whole process tree shares by env
    inheritance (a rehearsal sets it per scenario sandbox).
    Exactly one process wins; a SIGKILLed winner leaves the marker
    behind, which is the point — its successors must not re-fire.

    Without ``CSMOM_FAULT_STATE`` a FRESH tempdir is created and exported
    into this process's environment so its descendants share it.  A
    run-keyed dir, not a plan-keyed one: a stale marker from yesterday's
    manually-armed run must not silently disarm today's fault (a
    rehearsal that never experienced its fault certifies nothing).  The
    cost: siblings spawned by an ancestor that never claimed first do not
    share a dir — trees that need cross-sibling global_once must set
    ``CSMOM_FAULT_STATE`` explicitly.
    """
    import tempfile

    state = os.environ.get("CSMOM_FAULT_STATE", "")
    if not state:
        state = tempfile.mkdtemp(prefix="csmom_chaos_")
        os.environ["CSMOM_FAULT_STATE"] = state
        _log(f"no CSMOM_FAULT_STATE set; using fresh claim dir {state}")
    try:
        os.makedirs(state, exist_ok=True)
        fd = os.open(
            os.path.join(state, f"fired_{fault_index}"),
            os.O_CREAT | os.O_EXCL | os.O_WRONLY,
        )
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        return True
    except FileExistsError:
        return False
    except OSError as e:
        _log(f"global_once claim failed ({e}); firing anyway")
        return True


def _log(msg: str) -> None:
    # stderr, never stdout: the trailing-JSON stdout contract is exactly
    # what several faults exist to attack
    print(f"[chaos] {msg}", file=sys.stderr, flush=True)


def _execute(fault, seed: int, point: str, ctx: dict) -> None:
    act = fault.action
    _log(f"fire {act} at {point} (role={current_role()}, ctx={ctx or '{}'})")
    if act == "kill":
        import signal

        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # pragma: no cover - SIGKILL is not instantaneous
    elif act == "exit":
        os._exit(fault.code)
    elif act == "sleep":
        time.sleep(fault.seconds)
    elif act == "trip_deadline":
        from csmom_tpu_torch.utils.deadline import trip_active_guard

        if not trip_active_guard():
            _log("trip_deadline: no guard armed in this process")
    elif act == "clock_skew":
        _skew_wall_clock(fault.seconds)
    elif act == "corrupt_file":
        _damage_files(fault, seed, truncate=False)
    elif act == "truncate_file":
        _damage_files(fault, seed, truncate=True)
    elif act == "raise_oserror":
        raise OSError(
            fault.errno_,
            f"chaos raise_oserror at {point} (injected, errno={fault.errno_})",
        )
    elif act == "stdout_noise":
        _start_stdout_noise(fault, seed)
    elif act in ("fail", "tick_late", "tick_dup", "tick_drop",
                 "version_skew", "cache_poison", "conn_reset",
                 "net_delay", "partition"):
        pass  # the return value is the fault; the caller interprets it
    else:  # pragma: no cover - plan.validate() bars unknown actions
        raise ValueError(f"unknown fault action {act!r}")


def _skew_wall_clock(seconds: float) -> None:
    """Monkeypatch ``time.time`` to jump by ``seconds`` — an NTP step.

    Monotonic clocks are untouched (exactly as on a real NTP step), so a
    deadline anchored per the ``utils.deadline`` contract keeps its true
    fuse; anything anchored on the wall clock visibly breaks under this
    fault.  Patching is process-local and deliberately not undone: a real
    clock step does not revert either.
    """
    real_time = time.time

    def skewed():
        # this wrapper IS the skew under test
        return real_time() + seconds

    time.time = skewed


def _damage_files(fault, seed: int, *, truncate: bool) -> None:
    pattern = os.path.expandvars(fault.path)
    paths = sorted(p for p in glob.glob(pattern) if os.path.isfile(p))
    if not paths:
        _log(f"no files match {pattern!r}; nothing to damage")
        return
    rng = random.Random(seed)
    for p in paths:
        try:
            if truncate:
                with open(p, "r+b") as f:
                    f.truncate(max(0, fault.bytes))
                _log(f"truncated {p} to {fault.bytes} bytes")
            else:
                with open(p, "r+b") as f:
                    data = bytearray(f.read())
                    if not data:
                        continue
                    n = max(1, len(data) // 64)
                    for _ in range(n):
                        data[rng.randrange(len(data))] ^= 0xFF
                    f.seek(0)
                    f.write(data)
                _log(f"flipped {n} bytes in {p}")
        except OSError as e:  # damaging must never crash the rehearsal
            _log(f"could not damage {p}: {e}")


def _start_stdout_noise(fault, seed: int) -> None:
    """A daemon thread racing buffered junk against the trailing JSON.

    The payload never starts with ``{`` so a *correctly* quarantined
    summary line stays the only parseable JSON on stdout; if the summary
    emit is not a single atomic write, the interleave corrupts it and the
    invariant checker catches the damage.
    """
    rng = random.Random(seed)
    stop_at = time.monotonic() + max(0.5, fault.seconds or 1.0)

    def spam():
        while time.monotonic() < stop_at:
            print(f"{fault.text} {rng.random():.17f} " * 8, end="", flush=rng.random() < 0.5)
            time.sleep(0.001)

    t = threading.Thread(target=spam, daemon=True)
    t.start()
