"""Ring-buffered live panel: a fixed-capacity time axis that absorbs ticks.

Counterpart of ``csmom_tpu.stream.ring``, copied (numpy only).  The
batch world's :class:`~csmom_tpu_torch.panel.panel.Panel` is built once
and frozen; the live world appends a bar at a time.  The ring is a dense
``[A, capacity]`` array family (one per field) whose columns are a
circular window over a global monotone bar index, so appending bar ``n``
costs one column write: no reallocation, no shifting.

Versioning is the consistency contract with the serving side:

- every mutation (bar append, tick write, late merge) bumps a
  monotonically increasing ``version``;
- :meth:`LiveRing.snapshot` captures an immutable copy (read-only numpy
  arrays) stamped with the version at capture time, so a response
  stamped ``panel_version=v`` was computed from exactly version ``v``,
  and the replay artifact's ingest-vs-serve version reconciliation is
  checkable arithmetic.

Staleness is explicit, never synthesized: a bar the stream skipped is a
masked, NaN, ``stale``-flagged column; the ring never carries the last
price forward into a gap.

Time discipline: this module reads no clock.  Bar times are event time
from the tick log (int64 epoch-ns), versions are counters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LiveRing", "RingSnapshot", "T_MIN"]

# sentinel bar time of a never-written column (int64 epoch-ns domain)
T_MIN = np.iinfo(np.int64).min


@dataclasses.dataclass(frozen=True)
class RingSnapshot:
    """An immutable, versioned view of the live window (oldest -> newest).

    Arrays are copies with ``writeable=False``: a snapshot taken at
    version ``v`` still describes version ``v`` after a million more
    ticks have landed in the ring.
    """

    version: int
    first_bar_index: int          # global index of column 0
    bar_times: np.ndarray         # int64[W] event-time ns, ascending
    values: dict                  # field -> f[A, W]
    mask: dict                    # field -> bool[A, W]
    stale: np.ndarray             # bool[W] gap-materialized bars
    tickers: tuple

    @property
    def n_bars(self) -> int:
        return int(self.bar_times.shape[0])

    @property
    def n_assets(self) -> int:
        return len(self.tickers)

    @property
    def last_bar_time(self) -> int:
        return int(self.bar_times[-1]) if self.n_bars else T_MIN

    def window(self, field: str, bars: int | None = None) -> tuple:
        """``(values, mask)`` of the trailing ``bars`` columns (all when
        None).  Views into the snapshot's read-only arrays — zero-copy,
        still immutable."""
        v = self.values[field]
        m = self.mask[field]
        if bars is None or bars >= v.shape[1]:
            return v, m
        return v[:, -bars:], m[:, -bars:]


class LiveRing:
    """Fixed-capacity multi-field ring over the time axis.

    Bars are identified by a GLOBAL monotone index (bar 0 is the first
    ever appended); column ``i % capacity`` holds bar ``i``.  The live
    window is ``[next_bar - min(next_bar, capacity), next_bar)``.
    """

    def __init__(self, tickers, capacity: int, fields=("price", "volume"),
                 dtype=np.float64):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        if not tickers:
            raise ValueError("need at least one ticker")
        self.tickers = tuple(tickers)
        self.capacity = int(capacity)
        self.fields = tuple(fields)
        self.dtype = np.dtype(dtype)
        A = len(self.tickers)
        self._values = {f: np.full((A, self.capacity), np.nan, self.dtype)
                        for f in self.fields}
        self._mask = {f: np.zeros((A, self.capacity), bool)
                      for f in self.fields}
        self._bar_times = np.full(self.capacity, T_MIN, np.int64)
        self._stale = np.zeros(self.capacity, bool)
        self._next_bar = 0            # global index the NEXT append gets
        self._version = 0
        self._evictions = 0           # bars overwritten by ring wrap
        self._asset_index = {t: i for i, t in enumerate(self.tickers)}

    # ------------------------------------------------------------ queries --

    @property
    def version(self) -> int:
        return self._version

    @property
    def n_bars(self) -> int:
        """Bars currently IN the window (<= capacity)."""
        return min(self._next_bar, self.capacity)

    @property
    def next_bar_index(self) -> int:
        return self._next_bar

    @property
    def first_bar_index(self) -> int:
        return self._next_bar - self.n_bars

    @property
    def evictions(self) -> int:
        return self._evictions

    @property
    def last_bar_time(self) -> int:
        if self._next_bar == 0:
            return T_MIN
        return int(self._bar_times[self._col(self._next_bar - 1)])

    def asset_index(self, ticker: str) -> int:
        return self._asset_index[ticker]

    def in_window(self, bar_index: int) -> bool:
        return self.first_bar_index <= bar_index < self._next_bar

    def bar_time(self, bar_index: int) -> int:
        if not self.in_window(bar_index):
            raise IndexError(
                f"bar {bar_index} outside the live window "
                f"[{self.first_bar_index}, {self._next_bar})")
        return int(self._bar_times[self._col(bar_index)])

    def _col(self, bar_index: int) -> int:
        return bar_index % self.capacity

    # ---------------------------------------------------------- mutations --

    def append_bar(self, bar_time: int, stale: bool = False) -> int:
        """Open a new bar column at event time ``bar_time``; returns its
        global index.  ``stale=True`` marks a gap-materialized bar (the
        stream skipped it; no data, no carry).  Bar times must be
        strictly ascending — out-of-order bars are the INGESTOR's
        business (it merges or quarantines them), never the ring's."""
        bar_time = int(bar_time)
        if self._next_bar and bar_time <= self.last_bar_time:
            raise ValueError(
                f"append_bar({bar_time}) not after the latest bar "
                f"({self.last_bar_time}); late data merges via write()")
        idx = self._next_bar
        col = self._col(idx)
        if idx >= self.capacity:
            self._evictions += 1
        for f in self.fields:
            self._values[f][:, col] = np.nan
            self._mask[f][:, col] = False
        self._bar_times[col] = bar_time
        self._stale[col] = stale
        self._next_bar = idx + 1
        self._version += 1
        return idx

    def write(self, field: str, asset: int | str, bar_index: int,
              value: float) -> None:
        """Set one (asset, bar) cell; bumps the version.  Writing into a
        past in-window bar IS the late-merge path — the cell's bar loses
        its stale flag only if every field stays NaN-consistent (a bar
        with any real observation is no longer a pure gap)."""
        if isinstance(asset, str):
            asset = self._asset_index[asset]
        if not self.in_window(bar_index):
            raise IndexError(
                f"bar {bar_index} outside the live window "
                f"[{self.first_bar_index}, {self._next_bar})")
        col = self._col(bar_index)
        self._values[field][asset, col] = value
        self._mask[field][asset, col] = np.isfinite(value)
        if np.isfinite(value):
            self._stale[col] = False
        self._version += 1

    def column(self, field: str, bar_index: int) -> tuple:
        """``(values[A], mask[A])`` copies of one in-window bar — the
        O(A) read the incremental updaters consume at bar close."""
        if not self.in_window(bar_index):
            raise IndexError(
                f"bar {bar_index} outside the live window "
                f"[{self.first_bar_index}, {self._next_bar})")
        col = self._col(bar_index)
        return (self._values[field][:, col].copy(),
                self._mask[field][:, col].copy())

    def cell_written(self, field: str, asset: int | str,
                     bar_index: int) -> bool:
        if isinstance(asset, str):
            asset = self._asset_index[asset]
        if not self.in_window(bar_index):
            return False
        return bool(self._mask[field][asset, self._col(bar_index)])

    # ----------------------------------------------------------- snapshot --

    def snapshot(self) -> RingSnapshot:
        """Immutable versioned copy of the live window, time-ordered."""
        n = self.n_bars
        first = self.first_bar_index
        cols = np.array([self._col(first + i) for i in range(n)], int)
        values = {}
        mask = {}
        for f in self.fields:
            v = self._values[f][:, cols].copy()
            m = self._mask[f][:, cols].copy()
            v.flags.writeable = False
            m.flags.writeable = False
            values[f] = v
            mask[f] = m
        bt = self._bar_times[cols].copy()
        st = self._stale[cols].copy()
        bt.flags.writeable = False
        st.flags.writeable = False
        return RingSnapshot(
            version=self._version, first_bar_index=first, bar_times=bt,
            values=values, mask=mask, stale=st, tickers=self.tickers,
        )

    def stats(self) -> dict:
        n = self.n_bars
        cells = n * len(self.tickers)
        unfilled = 0
        stale_bars = 0
        if n:
            first = self.first_bar_index
            cols = np.array([self._col(first + i) for i in range(n)], int)
            unfilled = int((~self._mask[self.fields[0]][:, cols]).sum())
            stale_bars = int(self._stale[cols].sum())
        return {
            "version": self._version,
            "bars_appended": self._next_bar,
            "bars_in_window": n,
            "capacity": self.capacity,
            "evictions": self._evictions,
            "stale_bars": stale_bars,
            "unfilled_cells": unfilled,
            "cells": cells,
        }
