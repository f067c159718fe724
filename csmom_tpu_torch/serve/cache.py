"""Version-keyed scoring result cache + in-flight request coalescing.

Counterpart of ``csmom_tpu.serve.cache``, copied.  Scoring is
idempotent: the same panel, signal params and engine give the same
result, so an identical request need not be scored twice.

- :class:`ResultCache` is an LRU keyed by ``(endpoint, signal params,
  months, n_assets, panel fingerprint, panel_version)``.  The
  fingerprint hashes the request's values and mask; ``panel_version``
  rides in the key and in a separate **version floor**: a version bump
  (:meth:`ResultCache.set_version_floor`) drops every older entry and
  the get path refuses any entry below the floor (``stale_blocked``).
  ``stale_hits``, a stale entry actually returned, is structurally 0
  and the artifact schema holds it there.
- :class:`InflightCoalescer` lets identical concurrent requests share
  one dispatch: the first leads, later ones attach as followers and are
  resolved from the leader's terminal state, each exactly once, and
  counted (``served_coalesced``).

Memory is bounded by ``max_entries`` and ``max_bytes`` (measured payload
bytes); eviction is LRU and counted.  The ``serve.cache`` chaos
checkpoint fires on every lookup; its ``cache_poison`` action plants an
entry below the floor under the looked-up key, to show that the floor
check keeps it from being served.

Stdlib + numpy only, thread-safe, no clock reads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["CacheKey", "InflightCoalescer", "ResultCache",
           "panel_fingerprint"]


def panel_fingerprint(values: np.ndarray, mask: np.ndarray) -> str:
    """Content hash of one request panel (shape + dtype + bytes of both
    arrays): byte-identical panels collide, nothing else does."""
    h = hashlib.blake2b(digest_size=12)
    v = np.ascontiguousarray(values)
    m = np.ascontiguousarray(mask)
    h.update(repr((v.shape, str(v.dtype), m.shape, str(m.dtype))).encode())
    h.update(v.tobytes())
    h.update(m.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """The idempotency key: what must match for a result to be reusable."""

    kind: str                    # endpoint
    params: tuple                # (engine, lookback, skip, n_bins, mode)
    months: int
    n_assets: int
    fingerprint: str             # content hash of values+mask
    panel_version: int | None    # stream ingestion version (None = batch)


@dataclasses.dataclass
class _Entry:
    result: object
    version: int | None
    nbytes: int


def _result_nbytes(result) -> int:
    """Measured payload size of one cached result."""
    if isinstance(result, np.ndarray):
        return int(result.nbytes)
    if isinstance(result, dict):
        return 64 * max(1, len(result))
    return 64


class ResultCache:
    """Bounded LRU of scoring results with a panel-version floor."""

    def __init__(self, max_entries: int = 512, max_bytes: int = 32 << 20):
        if max_entries < 1 or max_bytes < 1:
            raise ValueError("max_entries/max_bytes must be >= 1")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self.version_floor = 0
        # stats (the SERVE artifact's cache book)
        self.hits = 0
        self.misses = 0
        self.stale_blocked = 0   # stale entry found by GET and REFUSED
        self.stale_hits = 0      # stale entry RETURNED — structurally 0,
                                 # counted so the artifact claims it
        self.stale_put_refused = 0  # dispatch raced an invalidation: its
                                    # result arrived already-stale and
                                    # was refused insertion
        self.inserts = 0
        self.evictions = 0
        self.invalidated = 0

    # --------------------------------------------------------------- get --

    def get(self, key: CacheKey):
        """``(hit, result)``; a hit refreshes LRU order.  An entry whose
        stamped version sits below the floor is never returned — it is
        evicted and counted ``stale_blocked``."""
        from csmom_tpu_torch.chaos.inject import checkpoint

        fired = checkpoint("serve.cache", kind=key.kind)
        with self._lock:
            if fired == "cache_poison":
                # plant a poisoned entry under this exact key, stamped
                # below the floor: only the get-path version check below
                # stands between it and a caller
                self._insert_locked(key, _Entry(
                    result="POISONED-STALE-RESULT",
                    version=self.version_floor - 1, nbytes=64))
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return False, None
            if e.version is not None and e.version < self.version_floor:
                # the floor gate: a stale entry is refused, never served
                self._remove_locked(key)
                self.stale_blocked += 1
                return False, None
            self._entries.move_to_end(key)
            self.hits += 1
            return True, e.result

    # --------------------------------------------------------------- put --

    def put(self, key: CacheKey, result) -> bool:
        """Insert (idempotent per key); refuses results already below the
        version floor — a dispatch that raced an invalidation must not
        resurrect stale data."""
        if isinstance(result, dict):
            # the cache keeps its OWN copy of mutable dict payloads, so
            # a caller editing its response cannot poison later hits
            # (ndarray payloads arrive frozen by the dispatch path)
            result = dict(result)
        with self._lock:
            if (key.panel_version is not None
                    and key.panel_version < self.version_floor):
                self.stale_put_refused += 1
                return False
            self._insert_locked(key, _Entry(
                result=result, version=key.panel_version,
                nbytes=_result_nbytes(result)))
            self.inserts += 1
            return True

    def _insert_locked(self, key: CacheKey, entry: _Entry) -> None:
        if key in self._entries:
            self._remove_locked(key)
        self._entries[key] = entry
        self._bytes += entry.nbytes
        while (len(self._entries) > self.max_entries
               or self._bytes > self.max_bytes):
            if len(self._entries) == 1 and self._bytes <= self.max_bytes:
                break  # a single oversize-entry cache still holds one
            oldest = next(iter(self._entries))
            if oldest == key and len(self._entries) == 1:
                break
            self._remove_locked(oldest)
            self.evictions += 1

    def _remove_locked(self, key: CacheKey) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes

    # -------------------------------------------------------- invalidate --

    def set_version_floor(self, floor: int) -> int:
        """Raise the version floor (monotone; a lower floor is ignored)
        and drop every entry stamped below it.  Returns how many entries
        were invalidated.  This is the ``panel_version``-bump hook of the
        live-panel side, :mod:`csmom_tpu_torch.stream` (ROADMAP.md, Queue
        1 item 6d), whose ring bumps a version on every mutation."""
        with self._lock:
            if floor <= self.version_floor:
                return 0
            self.version_floor = int(floor)
            stale = [k for k, e in self._entries.items()
                     if e.version is not None and e.version < floor]
            for k in stale:
                self._remove_locked(k)
            self.invalidated += len(stale)
            return len(stale)

    # -------------------------------------------------------------- stats --

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses + self.stale_blocked
            return {
                "hits": self.hits,
                "misses": self.misses,
                "stale_blocked": self.stale_blocked,
                "stale_hits": self.stale_hits,
                "stale_put_refused": self.stale_put_refused,
                "lookups": lookups,
                "hit_rate": (round(self.hits / lookups, 4)
                             if lookups else 0.0),
                "inserts": self.inserts,
                "evictions": self.evictions,
                "invalidated": self.invalidated,
                "entries": len(self._entries),
                "size_bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "version_floor": self.version_floor,
            }


class InflightCoalescer:
    """Identical concurrent requests share one dispatch.

    The FIRST submission of a key becomes the leader and proceeds
    through the queue normally; later submissions of the same key attach
    as followers on the leader's request object (the queue resolves them
    in the leader's exactly-once terminal transition, so each waiter
    gets its terminal state exactly once).  The map holds only live
    leaders: the service unregisters a key when its leader goes
    terminal, and ``lead_or_follow`` refuses to attach to a leader that
    is already terminal (the caller then consults the cache, which the
    leader's completion just filled).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._leaders: dict = {}

    def lead_or_follow(self, key: CacheKey, req, attach_fn) -> str:
        """Register ``req`` as the key's leader, or attach it to the
        current leader via ``attach_fn(leader, req) -> bool``.  Returns
        ``"leader"`` | ``"follower"`` | ``"retry"``.  ``"retry"`` means
        the leader reached a terminal state between the map lookup and
        the attach: the dead slot is freed and the caller must RE-CHECK
        the cache — a served leader's completion just filled it, so
        taking over the slot blindly would re-dispatch work whose result
        already exists."""
        with self._lock:
            leader = self._leaders.get(key)
            if leader is None:
                self._leaders[key] = req
                return "leader"
            if attach_fn(leader, req):
                return "follower"
            if self._leaders.get(key) is leader:
                del self._leaders[key]
            return "retry"

    def unregister(self, key: CacheKey, req) -> None:
        """Drop the key's leader slot iff ``req`` still owns it."""
        with self._lock:
            if self._leaders.get(key) is req:
                del self._leaders[key]

    def inflight(self) -> int:
        with self._lock:
            return len(self._leaders)
