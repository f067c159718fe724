"""The helpers hiding the escapes: host I/O, a clock read, and a
donated-surface call — none of them shard-looking on their own."""

import time

from .donated import grid_step_donated


def log_panel(panel):
    print("panel", panel)
    return time.monotonic()


def refresh_state(state):
    return grid_step_donated(state)
