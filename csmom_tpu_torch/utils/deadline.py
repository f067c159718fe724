"""Clocks and a deadline guard.

Counterpart of ``csmom_tpu.utils.deadline``, copied: :func:`mono_now_s`
is the clock of every duration and deadline in the serving tier
(``time.monotonic()``, immune to a wall-clock step or to the chaos
``clock_skew`` fault, which perturbs ``time.time`` only);
:func:`wall_now_s`, :func:`file_age_s` and :func:`marker_fresh` read the
wall clock through ``CLOCK_REALTIME`` where a check needs it (file ages,
identity stamps), clamped toward "stale".

:func:`deadline_guard` arms a timer for a process that runs under an
external time limit: just before the limit it prints a caller-built
partial summary line and exits 0 (3 when nothing was measured), under a
lock so exactly one summary line reaches stdout.  The deadline is
anchored at the caller's ``t0``, which must come from
``time.monotonic()``; a wall-clock anchor is re-anchored to now with a
note on stderr.  :func:`trip_active_guard` fires the armed guard at once
(the chaos ``trip_deadline`` fault).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["deadline_guard", "file_age_s", "marker_fresh", "mono_now_s",
           "trip_active_guard", "wall_now_s"]


def mono_now_s() -> float:
    """Current monotonic seconds — THE clock for durations and deadlines.

    The serving tier's queue, batcher and service read time through this
    helper instead of calling ``time.monotonic()`` inline: one documented
    home, skew-proof by construction (a chaos ``clock_skew`` fault
    perturbs ``time.time`` only).
    """
    return time.monotonic()


# -- skew-resistant wall-clock helpers ---------------------------------------
#
# Some checks genuinely need the wall clock: a file-mtime TTL ("is this
# probe-success marker recent?") compares against st_mtime, which IS wall
# time — no monotonic clock can age a file written by another process.
# But ``time.time`` is exactly what the chaos ``clock_skew`` fault (and a
# real NTP step, partially) perturbs.  These helpers are the one documented home for such
# checks: they read CLOCK_REALTIME through ``time.clock_gettime``, which
# the skew fault's monkeypatch cannot touch, and they clamp the
# pathological cases (negative ages from a backwards step) toward the
# SAFE side — "stale", never "fresh forever".

def wall_now_s() -> float:
    """Current wall-clock seconds (CLOCK_REALTIME), immune to the chaos
    ``clock_skew`` monkeypatch of ``time.time``.  For identity stamps and
    file-age comparisons only — NEVER for durations (use monotonic)."""
    return time.clock_gettime(time.CLOCK_REALTIME)


def file_age_s(path: str) -> float:
    """Age of ``path`` in seconds (>= 0) per its mtime.  A negative raw
    age (mtime in the future: a backwards clock step, a copied file)
    clamps to +inf — an unknowable age must read as stale, not fresh.
    Raises ``OSError`` when the file is absent/unstatable."""
    age = wall_now_s() - os.path.getmtime(path)
    return age if age >= 0 else float("inf")


def marker_fresh(path: str, ttl_s: float) -> bool:
    """True iff ``path`` exists and is younger than ``ttl_s`` — the
    skew-safe form of the wall-clock-minus-getmtime TTL idiom.
    ``ttl_s <= 0`` means "never fresh" (TTL disabled); a missing or
    unstatable marker is simply not fresh."""
    if ttl_s <= 0:
        return False
    try:
        return file_age_s(path) < ttl_s
    except OSError:
        return False

# the most recently armed guard's fire callable, for the chaos
# ``trip_deadline`` fault (one guard per capture process by construction)
_ACTIVE_FIRE: Optional[Callable[[], None]] = None


def trip_active_guard() -> bool:
    """Fire the armed deadline guard NOW (chaos hook).

    Behaves exactly as if the budget expired at this instant: the partial
    line (if any) is emitted through the quarantined path and the process
    exits.  Returns False when no guard is armed in this process (the
    caller logs; a rehearsal asserting on guard behavior treats that as a
    wiring failure, not a pass).
    """
    fire = _ACTIVE_FIRE
    if fire is None:
        return False
    fire()
    return True  # pragma: no cover - fire() exits the process


def _emit(line: str, *, flush_first: bool) -> None:
    """Write the summary as ONE ``os.write`` syscall, preceded by a newline.

    A reader parses the process's TRAILING JSON line, and callers print
    per-row progress concurrently with the watchdog thread — two buffered
    ``print``s can interleave at the stream-buffer level and corrupt that
    line.  A single ``os.write`` to fd 1 is one syscall (atomic for pipe
    writes up to PIPE_BUF-sized chunks and never interleaved mid-call by
    the kernel for regular files), and the leading newline terminates any
    half-flushed progress row so the JSON always starts at column 0.

    ``flush_first`` orders any buffered progress output BEFORE the summary
    — safe only on the caller's own thread.  The watchdog must NOT flush:
    the main thread may be blocked mid-write holding the stream's internal
    lock (a full pipe), and the watchdog taking that lock
    would deadlock the very dump that exists to beat the SIGKILL.  Its
    half-buffered rows die with ``os._exit``, which is the safe outcome.

    On the watchdog path there is one more race: between this write and
    the ``os._exit`` that follows it, the main thread can fill its stream
    buffer and flush a progress fragment AFTER the summary, displacing the
    trailing line.  So the watchdog first points fd 1 at ``/dev/null``
    (late flushes vanish) and emits on a private dup of the real stream.
    """
    fd = 1
    if flush_first:
        try:
            sys.stdout.flush()
        except Exception:
            pass
    else:
        try:
            fd = os.dup(1)
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, 1)
        except OSError:
            fd = 1  # quarantine unavailable: emit on the raw fd anyway
    os.write(fd, ("\n" + line + "\n").encode())


def deadline_guard(
    env_var: str,
    partial_line: Callable[[], Optional[str]],
    t0: float,
    margin_s: float = 45.0,
    min_delay_s: float = 30.0,
) -> Callable[[str], None]:
    """Arm a partial-dump watchdog; returns ``finish(line)`` for the caller.

    ``env_var`` names the wall-budget env (seconds since ``t0``); unset or
    0 arms nothing.  When the budget (minus ``margin_s``) expires,
    ``partial_line()`` is called: a string is printed and the process
    exits 0 (an explicitly-partial but parseable record); ``None`` means
    nothing worth a line was measured yet and the process exits 3.  The
    caller's normal path ends with ``finish(full_line)``, which wins the
    lock, cancels the timer, and prints — whichever of the two prints
    first is the process's single stdout summary line.
    """
    global _ACTIVE_FIRE
    budget = float(os.environ.get(env_var, "0") or 0)
    lock = threading.Lock()
    done = threading.Event()

    # a wall-clock anchor (epoch seconds from time.time, ~1.7e9) instead of
    # a monotonic one would push the fuse past any real budget and the
    # guard would silently never fire — re-anchor and say so, loudly
    if abs(time.monotonic() - t0) > 2 * 86400:
        print(
            "deadline_guard: t0 does not look like a time.monotonic() "
            "anchor (wall-clock seconds?); re-anchoring to now — pass "
            "t0=time.monotonic() captured at process start",
            file=sys.stderr, flush=True,
        )
        t0 = time.monotonic()

    def _fire():
        with lock:
            if done.is_set():
                return  # full line already printed (or printing won race)
            # partial_line() serializes live progress state the main thread
            # is still mutating; a mid-mutation
            # snapshot can raise ("dictionary changed size during
            # iteration") and an unguarded raise here would kill the timer
            # thread with NO line and NO exit — the exact lost-window
            # failure this guard exists to prevent.  Retry a few times
            # (each attempt re-snapshots), then fall through to exit 3.
            line = None
            for _ in range(5):
                try:
                    line = partial_line()
                    break
                except Exception:
                    # dying process: the dump
                    time.sleep(0.02)  # beat retries under the emit lock on
                    # purpose — once the guard fires, no waiter may print
            if line is None:
                os._exit(3)  # nothing measured: no artifact-worthy line
            _emit(line, flush_first=False)  # no flush: see _emit
            os._exit(0)

    timer = None
    if budget:
        # min_delay_s floors the fuse so a guard armed late (or a tiny
        # budget) still gives the measurement a beat to land its first
        # result; tests shrink it to exercise the firing path quickly
        delay = max(min_delay_s, budget - (time.monotonic() - t0) - margin_s)
        timer = threading.Timer(delay, _fire)
        timer.daemon = True
        timer.start()
        _ACTIVE_FIRE = _fire

    def finish(line: str) -> None:
        global _ACTIVE_FIRE
        with lock:
            done.set()
            _ACTIVE_FIRE = None
            if timer is not None:
                timer.cancel()
            # caller's thread: progress rows it printed flush first, then
            # the summary lands as one uninterleavable write
            _emit(line, flush_first=True)

    return finish
