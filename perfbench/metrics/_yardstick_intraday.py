"""The bytes one intraday pipeline call must move, for ``intraday_roofline``:
the compacted price and volume panels, their row validity (1 byte) and
minute index (int32) ``[A, R]`` and the two per-name risk maps read once,
the dense score panel ``[A, T]`` written once, and the event backtest's
own panels and outputs (:func:`event_bytes`).  A byte is counted once for
each input read and each output written, whatever the program reads
again: the features, the design and the fit's passes over it are the
program's own traffic."""

from __future__ import annotations

from perfbench.metrics._yardstick import bound_s, event_bytes  # noqa: F401


def intraday_bytes(A: int, R: int, T: int, itemsize: int) -> int:
    compact = A * R * (2 * itemsize + 1 + 4)
    risk_maps = 2 * A * itemsize
    dense_score = A * T * itemsize
    return compact + risk_maps + dense_score + event_bytes(A, T, itemsize)
