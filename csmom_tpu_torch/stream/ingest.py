"""Streaming ingestion: event-time watermarks over the live ring.

Counterpart of ``csmom_tpu.stream.ingest``, copied (numpy only; the
``stream.ingest`` checkpoint is the port's
:func:`csmom_tpu_torch.chaos.inject.checkpoint`).  Real tick streams
arrive late, out of order, duplicated and gapped; this front end makes
each of those a counted, bounded behavior:

- **Watermark**: event time only (the tick log's bar stamps; this
  module reads no clock).  The watermark trails the newest bar time
  seen by ``allowed_lateness_bars`` bar periods.  A tick below it is too
  old to change anything already served: it is quarantined (kept, with
  its reason, up to a bound) and counted, never merged.
- **Late merge**: a tick for a past bar still above the watermark
  merges in place; the cell is written and the ring version bumps, so
  the incremental updaters rebuild off exactly this signal.
- **Dedupe**: ticks are idempotent by ``(asset, bar_time)``: the first
  write wins, repeats count as ``deduped`` and change nothing.  Dedupe
  state is pruned as the watermark passes.
- **Gaps**: a tick that jumps the bar grid materializes the skipped
  bars as masked, NaN, ``stale``-flagged columns.
- **Non-finite prices** are quarantined without touching the dedupe
  state, so the real tick for that cell still lands.

Closed accounting is the contract the replay artifact's schema
enforces::

    applied + merged_late + quarantined + deduped == offered
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from csmom_tpu_torch.chaos.inject import checkpoint
from csmom_tpu_torch.stream.ring import LiveRing

__all__ = ["StreamIngestor", "Tick", "WatermarkPolicy"]


@dataclasses.dataclass(frozen=True)
class Tick:
    """One bar tick: event-time stamped, per-asset, per-bar values.

    ``bar_time`` is int64 epoch-ns aligned to the bar grid; ``seq`` is
    the feed's arrival sequence number (provenance only — ordering
    decisions use event time, never arrival order).
    """

    asset: str
    bar_time: int
    price: float
    volume: float = float("nan")
    seq: int = -1


@dataclasses.dataclass(frozen=True)
class WatermarkPolicy:
    """Event-time lateness policy, in whole bars.

    ``allowed_lateness_bars = L`` means: once bar ``t`` has been seen,
    ticks for bars older than ``t - L`` periods are quarantined.  L = 0
    quarantines everything out of order; the replay default keeps a few
    bars of grace, which is what real consolidated feeds need.
    """

    bar_period_ns: int
    allowed_lateness_bars: int = 2

    def __post_init__(self):
        if self.bar_period_ns <= 0:
            raise ValueError("bar_period_ns must be positive")
        if self.allowed_lateness_bars < 0:
            raise ValueError("allowed_lateness_bars must be >= 0")

    def watermark(self, max_bar_time: int) -> int:
        """Oldest bar time still writable given the newest seen."""
        return max_bar_time - self.allowed_lateness_bars * self.bar_period_ns


class StreamIngestor:
    """Applies the watermark policy between a tick feed and a LiveRing."""

    # outcome names double as accounting keys (closed-world)
    OUTCOMES = ("applied", "merged_late", "quarantined", "deduped")

    def __init__(self, ring: LiveRing, policy: WatermarkPolicy,
                 quarantine_keep: int = 256):
        self.ring = ring
        self.policy = policy
        self.offered = 0
        self.applied = 0
        self.merged_late = 0
        self.quarantined = 0
        self.deduped = 0
        self.gap_bars = 0             # columns materialized as stale holes
        self.merge_version_bumps = 0  # ring versions spent on late merges
        self._max_bar_time: int | None = None
        # (bar_time -> set of assets written) — pruned below the watermark
        self._seen: dict = {}
        self._bar_index_of: dict = {}  # bar_time -> global bar index
        self.quarantine = deque(maxlen=max(1, quarantine_keep))

    # ------------------------------------------------------------ ingest --

    def offer(self, tick: Tick) -> str:
        """Ingest one tick; returns its outcome (one of ``OUTCOMES``)."""
        self.offered += 1
        checkpoint("stream.ingest", asset=tick.asset, seq=tick.seq)
        bar_time = int(tick.bar_time)

        if not np.isfinite(tick.price):
            # a non-finite price is rejected data, not data: it must
            # NOT advance the bar grid, and
            # above all must NOT mark the (asset, bar) cell seen — the
            # ring's mask would stay False (write() masks on finiteness)
            # while the dedupe state claimed the cell was filled, so the
            # later REAL tick would be counted `deduped` and the cell
            # would stay unfilled forever with the books still
            # balancing.  Quarantine keeps the ledger closed and the
            # reason auditable; dedupe state is untouched.
            self.quarantined += 1
            self.quarantine.append({
                "asset": tick.asset, "bar_time": bar_time,
                "seq": tick.seq,
                "reason": f"non-finite price {tick.price!r}",
            })
            return "quarantined"

        if self._max_bar_time is not None:
            wm = self.policy.watermark(self._max_bar_time)
            if bar_time < wm:
                self.quarantined += 1
                self.quarantine.append({
                    "asset": tick.asset, "bar_time": bar_time,
                    "seq": tick.seq,
                    "reason": f"below watermark by "
                              f"{(wm - bar_time) // self.policy.bar_period_ns}"
                              " bar(s)",
                })
                return "quarantined"

        key_assets = self._seen.get(bar_time)
        if key_assets is not None and tick.asset in key_assets:
            self.deduped += 1
            return "deduped"

        if self._max_bar_time is None or bar_time > self._max_bar_time:
            self._advance_to(bar_time)
            outcome = "applied"
        elif bar_time == self._max_bar_time:
            outcome = "applied"
        else:
            outcome = "merged_late"

        idx = self._bar_index_of.get(bar_time)
        if idx is None or not self.ring.in_window(idx):
            # the bar left the window (capacity wrap) between watermark
            # check and here — an edge only tiny rings can reach; the
            # honest outcome is quarantine, not a write into a reused column
            self.quarantined += 1
            self.quarantine.append({
                "asset": tick.asset, "bar_time": bar_time, "seq": tick.seq,
                "reason": "bar evicted from the ring window",
            })
            return "quarantined"

        v0 = self.ring.version
        self.ring.write("price", tick.asset, idx, float(tick.price))
        if "volume" in self.ring.fields and np.isfinite(tick.volume):
            self.ring.write("volume", tick.asset, idx, float(tick.volume))
        self._seen.setdefault(bar_time, set()).add(tick.asset)

        if outcome == "merged_late":
            self.merged_late += 1
            self.merge_version_bumps += self.ring.version - v0
        else:
            self.applied += 1
        return outcome

    def _advance_to(self, bar_time: int) -> None:
        """Materialize the bar grid up to ``bar_time``; skipped bars are
        stale holes, and dedupe state below the new watermark is pruned."""
        period = self.policy.bar_period_ns
        if self._max_bar_time is None:
            idx = self.ring.append_bar(bar_time)
            self._bar_index_of[bar_time] = idx
        else:
            t = self._max_bar_time + period
            while t < bar_time:
                idx = self.ring.append_bar(t, stale=True)
                self._bar_index_of[t] = idx
                self.gap_bars += 1
                t += period
            idx = self.ring.append_bar(bar_time)
            self._bar_index_of[bar_time] = idx
        self._max_bar_time = bar_time
        wm = self.policy.watermark(bar_time)
        for bt in [bt for bt in self._seen if bt < wm]:
            del self._seen[bt]
        for bt in [bt for bt in self._bar_index_of if bt < wm]:
            del self._bar_index_of[bt]

    # -------------------------------------------------------- accounting --

    @property
    def version(self) -> int:
        return self.ring.version

    @property
    def watermark_ns(self) -> int | None:
        if self._max_bar_time is None:
            return None
        return self.policy.watermark(self._max_bar_time)

    def accounting(self) -> dict:
        return {
            "offered": self.offered,
            "applied": self.applied,
            "merged_late": self.merged_late,
            "quarantined": self.quarantined,
            "deduped": self.deduped,
            "gap_bars": self.gap_bars,
            "merge_version_bumps": self.merge_version_bumps,
        }

    def invariant_violations(self) -> list:
        """The closed tick book (empty = holds)."""
        a = self.accounting()
        total = (a["applied"] + a["merged_late"] + a["quarantined"]
                 + a["deduped"])
        if total != a["offered"]:
            return [
                f"tick accounting broken: applied {a['applied']} + "
                f"merged_late {a['merged_late']} + quarantined "
                f"{a['quarantined']} + deduped {a['deduped']} = {total} "
                f"!= offered {a['offered']}"
            ]
        return []
