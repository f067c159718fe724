"""A pure helper: no host I/O, no clocks, no donation — safe to reach
from a shard's function."""


def scale_panel(panel):
    return panel * 2.0
