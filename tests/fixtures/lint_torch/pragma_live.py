"""Fixture: a live pragma suppresses exactly its finding, nothing else."""

import time


def wall():
    # lint: allow[clock-discipline] fixture demonstrating a live suppression
    return time.time()
