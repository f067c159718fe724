"""Milliseconds per J x K grid call: the window's wall over the number of
calls completed in it, each call ending with its result table on the host."""

from perfbench.metrics._shared import call_ms as read  # noqa: F401
