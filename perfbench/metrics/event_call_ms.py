"""Milliseconds per event backtest call: the window's wall over the number
of calls completed in it, each call ending with its PnL path, trade counts
and cost totals on the host."""

from perfbench.metrics._shared import call_ms as read  # noqa: F401
