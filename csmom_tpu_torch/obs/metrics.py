"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``csmom_tpu.obs.metrics``, copied but for
:func:`snapshot`'s memory and build blocks.  One flat registry per
process, keyed by dotted metric name; handles are cached, and every
mutator checks the telemetry arming flag first: disarmed,
``inc()``/``set()``/``observe()`` are one global load and one compare.

:func:`snapshot` returns every registered value, plus the CUDA caching
allocator's statistics when torch has initialized a card, and the
number of kernel libraries built or loaded in this process
(:mod:`csmom_tpu_torch.ops.build`).  Every snapshot is sequence-numbered
and stamped with the process identity (:func:`set_identity`);
:func:`snapshot_delta` turns two snapshots of one process into a delta
whose counter parts are non-negative by construction.
"""

from __future__ import annotations

import math
import os
import sys
import threading

from csmom_tpu_torch.obs import spans as _spans

__all__ = ["budget_burn", "counter", "gauge", "histogram", "set_identity",
           "snapshot", "snapshot_delta", "reset"]

_LOCK = threading.Lock()
_REGISTRY: dict = {}  # name -> metric handle
_SEQ = 0  # monotonic per-process snapshot sequence number
_IDENTITY = {"role": "main", "slot": None}  # stamped into every snapshot


class Counter:
    """Monotone event count.  ``inc(n)`` is a no-op while disarmed."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if _spans._COLLECTOR is None:
            return
        with _LOCK:
            self.value += n


class Gauge:
    """Last-written value (deadline margin, queue depth, a flag)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        if _spans._COLLECTOR is None:
            return
        with _LOCK:
            self.value = v


class Histogram:
    """Streaming summary of observations with bounded log-bucket
    quantile estimation — p50/p95/p99 with NO per-sample storage.

    Buckets are geometric with ratio ``2**0.25`` (four per doubling)
    spanning [2^-20, 2^20) ≈ [1 µs, 1 M] in whatever unit the caller
    observes, with one underflow and one overflow bucket — 162 ints,
    allocated ONCE at registration.  A quantile answer is the geometric
    midpoint of the bucket holding that rank, so the relative error is
    bounded by the bucket ratio (≈ ±9%) — tight enough for a live tail
    snapshot; the artifact pipeline keeps exact reservoirs where a gate
    needs them.  The disarmed fast path is unchanged: one global load,
    one compare, return.
    """

    # four buckets per doubling across 2^[-20, 20): index 0 = underflow
    # (v < 2^-20, incl. zero/negative), index -1 = overflow
    _LOG_MIN = -20
    _LOG_MAX = 20
    _PER_DOUBLING = 4
    _N_BUCKETS = (_LOG_MAX - _LOG_MIN) * _PER_DOUBLING + 2

    __slots__ = ("name", "count", "total", "min", "max", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.buckets = [0] * self._N_BUCKETS

    def _index(self, v: float) -> int:
        if v < 2.0 ** self._LOG_MIN:
            return 0
        i = int((math.log2(v) - self._LOG_MIN) * self._PER_DOUBLING) + 1
        return min(i, self._N_BUCKETS - 1)

    def _bucket_value(self, i: int) -> float:
        """The geometric midpoint of bucket ``i`` (edges for the under/
        overflow buckets — an out-of-range estimate must not extrapolate
        past what was observable)."""
        if i <= 0:
            return 2.0 ** self._LOG_MIN
        if i >= self._N_BUCKETS - 1:
            return 2.0 ** self._LOG_MAX
        lo = self._LOG_MIN + (i - 1) / self._PER_DOUBLING
        return 2.0 ** (lo + 0.5 / self._PER_DOUBLING)

    def observe(self, v: float) -> None:
        if _spans._COLLECTOR is None:
            return
        with _LOCK:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.buckets[self._index(v)] += 1

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile estimate from the log buckets (None
        until something was observed).  Clamped into [min, max] so a
        one-sample histogram answers that sample, not a bucket edge.

        Lock-free read, like ``summary()`` always was: ``snapshot()``
        calls this while holding the registry lock (which is NOT
        reentrant), and a torn read costs one snapshot a stale count,
        never a wrong bucket."""
        if not self.count:
            return None
        rank = max(1, math.ceil(q * self.count))
        acc = 0
        for i, n in enumerate(self.buckets):
            acc += n
            if acc >= rank:
                est = self._bucket_value(i)
                return max(self.min, min(self.max, est))
        return self.max

    def summary(self) -> dict:
        out = {
            "count": self.count,
            "sum": round(self.total, 6),
            "min": self.min,
            "max": self.max,
            "mean": round(self.total / self.count, 6) if self.count else None,
        }
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            out[name] = None if v is None else round(v, 6)
        return out


def _get(name: str, cls):
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get(name, Histogram)


def budget_burn(n_served: int, n_violations: int,
                slo_target: float = 0.99) -> float | None:
    """Per-class SLO error-budget burn rate.

    The class's budget promise is an SLO: ``slo_target`` of served
    requests finish inside the class deadline budget.  The error budget
    is the allowed violation fraction (``1 - slo_target``), and the burn
    rate is observed violations over allowance::

        burn = (n_violations / n_served) / (1 - slo_target)

    1.0 means the run consumed its error budget exactly; under 1.0 is
    headroom; over 1.0 is an SLO breach scaled by how hard (burn 2.0 =
    violating at twice the allowed rate; lower is better).  None when nothing was served — "no traffic" must never
    be spelled "no burn".
    """
    if n_served <= 0:
        return None
    allowed = 1.0 - float(slo_target)
    if allowed <= 0:
        raise ValueError(f"slo_target must be < 1, got {slo_target}")
    return round((n_violations / n_served) / allowed, 4)


def set_identity(role: str, slot=None) -> None:
    """Declare who this process is in the fleet (``worker``/``router``/
    ``loadgen``/...).  Stamped into every subsequent snapshot so a delta
    landing at the aggregator names its emitter without side-channel
    bookkeeping.  The pid is read at snapshot time, not here — a fork
    after ``set_identity`` must not inherit a stale pid."""
    with _LOCK:
        _IDENTITY["role"] = str(role)
        _IDENTITY["slot"] = slot


def reset() -> None:
    """Drop every registered metric (tests re-register per case).  The
    sequence number is NOT reset — it is a per-process lifetime counter,
    and rewinding it would let a post-reset snapshot alias a pre-reset
    one in a delta stream."""
    with _LOCK:
        _REGISTRY.clear()


def snapshot(include_compile: bool = True) -> dict:
    """All registered metrics as one JSON-ready dict.

    ``memory`` holds the CUDA caching allocator's current and peak
    allocated and reserved bytes and its segment count, present only
    once torch has initialized a card in this process.  ``compile``
    holds the number of kernel libraries built or loaded in this process
    (:func:`csmom_tpu_torch.ops.build.libraries_built_or_loaded`), or
    the reason it is absent when the kernel layer was never imported.
    """
    global _SEQ
    with _LOCK:
        _SEQ += 1
        out: dict = {
            "seq": _SEQ,
            "identity": {"pid": os.getpid(), "role": _IDENTITY["role"],
                         "slot": _IDENTITY["slot"]},
            "counters": {m.name: m.value for m in _REGISTRY.values()
                         if isinstance(m, Counter)},
            "gauges": {m.name: m.value for m in _REGISTRY.values()
                       if isinstance(m, Gauge)},
            "histograms": {m.name: m.summary() for m in _REGISTRY.values()
                           if isinstance(m, Histogram)},
        }
    # read lazily, and only when already imported: a process that never
    # touched a card or a kernel snapshots its registry without paying
    # for either
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        st = torch.cuda.memory_stats()
        out["memory"] = {k: st.get(k, 0) for k in (
            "allocated_bytes.all.current", "allocated_bytes.all.peak",
            "reserved_bytes.all.current", "reserved_bytes.all.peak",
            "segment.all.current")}
    if include_compile:
        build = sys.modules.get("csmom_tpu_torch.ops.build")
        if build is not None:
            out["compile"] = {"kernel_libraries_built_or_loaded":
                              build.libraries_built_or_loaded()}
        else:
            out["compile"] = ("not applicable: the kernel layer was not "
                              "imported in this process")
    return out


def snapshot_delta(prev: dict, cur: dict) -> dict:
    """The change between two snapshots of the SAME process, wire-ready.

    This is the primitive every exporter shares: counters become
    non-negative deltas (a counter first seen in ``cur`` deltas from
    zero), gauges carry their current value (a gauge is a last-write,
    not an accumulation), histograms carry count/sum deltas.  Three
    things are refused loudly instead of smoothed over:

    - a pid or role mismatch (a delta across two different processes is
      not a delta, it is a splice);
    - a non-advancing sequence number (``cur`` must be strictly newer);
    - a counter or histogram count that went DOWN — counters are monotone
      by construction, so a regression means registry corruption, and
      emitting it would poison every downstream cumulative series.
    """
    pid_prev = prev.get("identity", {}).get("pid")
    pid_cur = cur.get("identity", {}).get("pid")
    if pid_prev != pid_cur:
        raise ValueError(
            f"snapshot_delta across processes: prev pid {pid_prev}, "
            f"cur pid {pid_cur}"
        )
    seq_prev, seq_cur = prev.get("seq"), cur.get("seq")
    if seq_prev is None or seq_cur is None or seq_cur <= seq_prev:
        raise ValueError(
            f"snapshot_delta needs advancing seq: prev {seq_prev}, "
            f"cur {seq_cur}"
        )
    counters = {}
    prev_c = prev.get("counters", {})
    for name, v in cur.get("counters", {}).items():
        d = v - prev_c.get(name, 0)
        if d < 0:
            raise ValueError(
                f"counter {name!r} went backwards ({prev_c.get(name)} -> "
                f"{v}): counters are monotone by construction"
            )
        counters[name] = d
    hists = {}
    prev_h = prev.get("histograms", {})
    for name, s in cur.get("histograms", {}).items():
        p = prev_h.get(name, {})
        dc = s.get("count", 0) - p.get("count", 0)
        if dc < 0:
            raise ValueError(
                f"histogram {name!r} count went backwards "
                f"({p.get('count')} -> {s.get('count')})"
            )
        hists[name] = {
            "count": dc,
            "sum": round(s.get("sum", 0.0) - p.get("sum", 0.0), 6),
        }
    return {
        "seq": seq_cur,
        "identity": dict(cur.get("identity", {})),
        "counters": counters,
        "gauges": dict(cur.get("gauges", {})),
        "histograms": hists,
    }
