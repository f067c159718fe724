"""SLO classes: named service classes with budgets, quotas, and shares.

Counterpart of ``csmom_tpu.serve.slo``, copied.  A policy of named
classes, each carrying:

- a **deadline budget** (``deadline_s``): the default per-request
  deadline of the class and the p99 target its books are judged against
  (``within_budget`` in the artifact);
- an **admission quota** (token bucket: ``quota_rps`` + ``quota_burst``):
  a class offered more than its quota is rejected at the door
  (``rejected_quota``) before it can occupy queue capacity;
- a **queue share** (``queue_share``): the fraction of the bounded queue
  the class may occupy.

Dispatch prefers lower ``rank`` (interactive first), the queue share
bounds how much of the buffer bulk can hold, and the token bucket bounds
how fast bulk can ask, so bulk load cannot starve interactive scoring.
The priority name ``batch`` resolves to ``bulk`` (:data:`ALIASES`).

Stdlib-only: the token bucket never reads a clock itself; callers pass
``now_s`` from :func:`csmom_tpu_torch.utils.deadline.mono_now_s`.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ALIASES", "SLOClass", "SLOPolicy", "TokenBucket",
           "default_policy"]

# other priority names -> canonical SLO class names
ALIASES = {"batch": "bulk"}


class TokenBucket:
    """Sustained-rate admission quota with bounded burst credit.

    ``rate`` tokens/second refill up to ``burst``; each admission takes
    one token.  Clock-free by design: every call passes ``now_s`` (the
    caller's ``mono_now_s()``), which also makes quota behavior exactly
    testable without sleeping.
    """

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be > 0, got {rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last_s: float | None = None

    def try_take(self, now_s: float) -> bool:
        """Take one token if available (refilling first); False = over
        quota right now."""
        if self._last_s is not None and now_s > self._last_s:
            self._tokens = min(self.burst,
                               self._tokens + (now_s - self._last_s)
                               * self.rate)
        self._last_s = now_s
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One named service class: budget, quota, share, dispatch rank."""

    name: str
    rank: int                      # dispatch order: lower collects first
    deadline_s: float              # latency budget = default deadline AND
                                   # the per-class p99 promise
    quota_rps: float | None = None  # token-bucket rate (None = unlimited)
    quota_burst: float | None = None  # bucket depth (default: 1.5x rate)
    queue_share: float = 1.0       # max fraction of queue capacity

    def make_bucket(self) -> TokenBucket | None:
        if self.quota_rps is None:
            return None
        burst = (self.quota_burst if self.quota_burst is not None
                 else 1.5 * self.quota_rps)
        return TokenBucket(self.quota_rps, burst)

    def max_queued(self, capacity: int) -> int:
        """Slots of a ``capacity``-bounded queue this class may occupy."""
        share = min(1.0, max(0.0, self.queue_share))
        return max(1, int(share * capacity))


class SLOPolicy:
    """An ordered set of SLO classes (rank order = dispatch order)."""

    def __init__(self, classes: tuple):
        if not classes:
            raise ValueError("an SLO policy needs at least one class")
        ordered = sorted(classes, key=lambda c: c.rank)
        names = [c.name for c in ordered]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")
        self.classes = tuple(ordered)
        self._by_name = {c.name: c for c in ordered}

    def names(self) -> tuple:
        """Class names in dispatch (rank) order."""
        return tuple(c.name for c in self.classes)

    def resolve(self, name: str) -> SLOClass:
        """The class for ``name`` (aliases honored); raises on unknown —
        an unknown class must fail at the door, not invent a bucket."""
        canonical = ALIASES.get(name, name)
        try:
            return self._by_name[canonical]
        except KeyError:
            raise ValueError(
                f"unknown SLO class {name!r} (known: "
                f"{list(self.names())}, aliases: {ALIASES})"
            ) from None

    def resolve_name(self, name: str) -> str:
        return self.resolve(name).name

    def summary(self) -> dict:
        """The policy as artifact-ready JSON (budgets in ms)."""
        return {
            c.name: {
                "rank": c.rank,
                "budget_ms": round(1e3 * c.deadline_s, 3),
                "quota_rps": c.quota_rps,
                "queue_share": c.queue_share,
            }
            for c in self.classes
        }


def default_policy() -> SLOPolicy:
    """The production default: three classes.

    - ``interactive``: tight budget, no rate quota, may use the whole
      queue — the class the service exists to protect.
    - ``standard``: middling budget, no rate quota, bounded to 3/4 of
      the queue.
    - ``bulk``: the backtest tenant — generous budget, rate-limited
      (16 req/s sustained, 24 burst), and never more than half the
      queue, so bulk saturation cannot starve interactive admission.
    """
    return SLOPolicy((
        SLOClass("interactive", rank=0, deadline_s=0.5),
        SLOClass("standard", rank=1, deadline_s=1.0, queue_share=0.75),
        SLOClass("bulk", rank=2, deadline_s=3.0,
                 quota_rps=16.0, quota_burst=24.0, queue_share=0.5),
    ))
