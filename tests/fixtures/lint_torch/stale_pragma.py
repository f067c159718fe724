"""Known-bad fixture: an unused suppression is itself a finding."""


def fine():
    # lint: allow[clock-discipline] nothing below actually reads a clock
    return 42
