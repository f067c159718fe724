"""Nestable, thread-safe spans emitting a JSON-lines event stream.

Counterpart of ``csmom_tpu.obs.spans``, copied; only :meth:`fetch`
differs (it synchronizes a tensor's device and copies it to the host).
A span is a timed block with a name, optional attributes, and a parent,
the innermost open span on the same thread.  Timestamps are
``time.monotonic()`` (system-wide on Linux, so events of a child
process compose with the parent's on one timeline).

Usage::

    with span("serve.dispatch", kind="momentum") as sp:
        out = sp.fetch(score(batch))
        sp.set(n=len(batch))

    point("serve.ready", ok=True)          # a durationless event

``sp.fetch(t)`` waits for ``t``'s device and returns it as a numpy
array, adding the blocking wall to the span's ``device_s``.

Zero-cost disarmed: with no collector armed, ``span()`` returns one
shared no-op singleton and ``point()`` is a single global load.  Armed,
every event is appended to the stream as one flushed JSON line under a
lock.

Env contract:

- ``CSMOM_TELEMETRY``      ``0``/empty = disarmed; ``1`` = armed
  in-memory (no file); anything else = path of the JSONL event stream
  (opened append — children inherit and interleave whole lines).
- ``CSMOM_TELEMETRY_RUN``  run id stamped on every event (defaults to
  ``<proc>-<pid>``).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

__all__ = [
    "arm",
    "arm_from_env",
    "arm_policy",
    "armed",
    "disarm",
    "point",
    "span",
    "ENV_STREAM",
    "ENV_RUN",
]

ENV_STREAM = "CSMOM_TELEMETRY"
ENV_RUN = "CSMOM_TELEMETRY_RUN"

# the armed collector, or None.  Module-global on purpose: span()/point()
# disarmed must cost one global load + compare, nothing else.
_COLLECTOR = None

_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class Collector:
    """Sink for one process's telemetry events (see :func:`arm`).

    Keeps every event in memory (same-process assembly) and, when given a
    path, appends each as one flushed JSON line (cross-process assembly).
    Thread-safe: one lock around sequence allocation and emission.
    """

    def __init__(self, path: str | None, run_id: str, proc: str):
        self.path = path
        self.run_id = run_id
        self.proc = proc
        self.pid = os.getpid()
        self.events: list = []
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = None
        if path:
            try:
                self._fh = open(path, "a", encoding="utf-8")
            except OSError as e:
                # an unwritable stream must not cost the run (the layer's
                # own contract): degrade to in-memory, loudly
                self.path = None
                print(f"[obs] cannot open telemetry stream {path!r} "
                      f"({e}); continuing in-memory", file=sys.stderr)

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def emit(self, event: dict) -> None:
        event.setdefault("run", self.run_id)
        event.setdefault("proc", self.proc)
        event.setdefault("pid", self.pid)
        with self._lock:
            if self._fh is None:
                # in-memory mode (and the fallback of a stream that died
                # mid-run): the list is what assembly reads
                self.events.append(event)
                return
            try:
                # one write + flush per event: a SIGKILL costs at most
                # the line in flight, never the stream.  The file is the
                # single store — assembly reads it back, so a long run
                # does not also accumulate every event dict in RAM.
                self._fh.write(json.dumps(event) + "\n")
                self._fh.flush()
            except (OSError, ValueError):
                self._fh = None  # a dead stream must not kill the run
                self.events.append(event)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


class _NullSpan:
    """The disarmed span: one shared instance, every method a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self

    def fetch(self, y):
        return _fetch(y)


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_col", "name", "attrs", "seq", "parent", "t0", "t1",
                 "device_s", "_thread")

    def __init__(self, col: Collector, name: str, attrs: dict):
        self._col = col
        self.name = name
        self.attrs = attrs
        self.device_s = 0.0
        self.seq = col.next_seq()
        self.parent = None
        self.t0 = self.t1 = 0.0
        self._thread = threading.get_ident()

    def __enter__(self):
        st = _stack()
        if st:
            self.parent = st[-1].seq
        st.append(self)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, etype, evalue, tb):
        self.t1 = time.monotonic()
        st = _stack()
        if self in st:  # tolerate mis-nesting: drop self and anything above
            del st[st.index(self):]
        rec = {
            "kind": "span",
            "name": self.name,
            "seq": self.seq,
            "parent": self.parent,
            "thread": self._thread,
            "t0_s": round(self.t0, 6),
            "t1_s": round(self.t1, 6),
            "dur_s": round(self.t1 - self.t0, 6),
        }
        if self.device_s:
            rec["device_s"] = round(self.device_s, 6)
        if self.attrs:
            rec["attrs"] = _jsonable(self.attrs)
        if etype is not None:
            rec["error"] = f"{etype.__name__}: {evalue}"[:200]
        self._col.emit(rec)
        return False

    def set(self, **attrs):
        """Attach attributes to this span's record (last write wins)."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs):
        """A durationless event parented to this span."""
        _emit_point(self._col, name, attrs, parent=self.seq)
        return self

    def fetch(self, y):
        """:func:`_fetch` of ``y`` with the blocking wall accumulated into
        this span's ``device_s``."""
        t0 = time.monotonic()
        out = _fetch(y)
        self.device_s += time.monotonic() - t0
        return out


def _fetch(y):
    """``y`` on the host as a numpy array: a tensor's device is
    synchronized and the tensor copied; anything else goes through
    ``numpy.asarray``."""
    import numpy as np

    if hasattr(y, "detach") and hasattr(y, "device"):
        import torch

        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)
        return y.detach().cpu().numpy()
    return np.asarray(y)


def _jsonable(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)[:120]
    return out


def _emit_point(col: Collector, name: str, attrs: dict,
                parent: int | None = None) -> None:
    if parent is None:
        st = _stack()
        parent = st[-1].seq if st else None
    rec = {
        "kind": "point",
        "name": name,
        "seq": col.next_seq(),
        "parent": parent,
        "thread": threading.get_ident(),
        "t_s": round(time.monotonic(), 6),
    }
    if attrs:
        rec["attrs"] = _jsonable(attrs)
    col.emit(rec)


# ------------------------------------------------------------- frontend ----

def span(name: str, **attrs):
    """Open a span (context manager).  Disarmed: the shared no-op
    singleton, no allocation."""
    col = _COLLECTOR
    if col is None:
        return _NULL_SPAN
    return _Span(col, name, attrs)


def point(name: str, **attrs) -> None:
    """Record a durationless event.  Disarmed: a no-op."""
    col = _COLLECTOR
    if col is None:
        return
    _emit_point(col, name, attrs)


def armed() -> bool:
    return _COLLECTOR is not None


def arm(path: str | None = None, run_id: str | None = None,
        proc: str = "main") -> Collector:
    """Arm telemetry for this process; returns the collector.

    ``path``: the JSONL event stream to append to (None = in-memory
    only).  Re-arming replaces the previous collector (closing its
    stream).  Exports ``CSMOM_TELEMETRY``/``CSMOM_TELEMETRY_RUN`` so
    children spawned after this call join the same stream and run id.
    """
    global _COLLECTOR
    if run_id is None:
        run_id = os.environ.get(ENV_RUN) or f"{proc}-{os.getpid()}"
    old, _COLLECTOR = _COLLECTOR, Collector(path, run_id, proc)
    if old is not None:
        old.close()
    # export what the collector actually USES: if the stream open failed
    # and it degraded to in-memory, children must not append to a path
    # the assembler will never read
    os.environ[ENV_STREAM] = _COLLECTOR.path if _COLLECTOR.path else "1"
    os.environ[ENV_RUN] = run_id
    return _COLLECTOR


def disarm() -> None:
    """Close and drop the armed collector (span()/point() become no-ops)
    and retract the env contract :func:`arm` exported, so processes
    spawned later do not join a stream nobody is assembling."""
    global _COLLECTOR
    old, _COLLECTOR = _COLLECTOR, None
    if old is not None:
        old.close()
        os.environ.pop(ENV_STREAM, None)
        os.environ.pop(ENV_RUN, None)


def arm_from_env(proc: str) -> Collector | None:
    """Arm from the env contract, or return None (disarmed).

    The supervisor arms with an explicit path and exports it; children
    call this and join the stream.  ``CSMOM_TELEMETRY`` unset, empty, or
    ``0`` leaves the process disarmed.
    """
    val = os.environ.get(ENV_STREAM, "")
    if not val or val == "0":
        return None
    return arm(None if val == "1" else val,
               run_id=os.environ.get(ENV_RUN), proc=proc)


def arm_policy(proc: str, default_path: str | None = None,
               run_id: str | None = None) -> Collector | None:
    """The one arming decision every entry point shares, so the env
    contract cannot drift between copies:

    - ``CSMOM_TELEMETRY=0``: disarmed, full stop;
    - ``CSMOM_TELEMETRY`` set (a path, or ``1``): the operator's
      contract — join it verbatim, including their run id;
    - unset/empty: arm the caller's ``default_path`` when it provides
      one (the default-ON runs) and stay disarmed otherwise (env-armed
      -only entry points).
    """
    val = os.environ.get(ENV_STREAM, "")
    if val == "0":
        return None
    if val:
        return arm_from_env(proc)
    if default_path is None:
        return None
    return arm(default_path, run_id=run_id, proc=proc)


def current_collector() -> Collector | None:
    return _COLLECTOR
