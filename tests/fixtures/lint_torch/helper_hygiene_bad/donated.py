"""A donated surface (name-marked, like event_backtest_donated)."""


def grid_step_donated(state):
    return state
