"""``idle_ms.event_decide``: milliseconds of an untraced call's device idle
time that fall to the span ``event.decide``
(``csmom_tpu_torch/backtest/event.py``): the span's share of the host-ops
stretch's idle gaps times the idle a call (see ``_phases.py``)."""

from perfbench.metrics._phases import idle_ms


def read(ctx):
    return idle_ms(ctx, "event.decide")
