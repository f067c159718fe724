"""``idle_ms.intraday_scatter``: milliseconds of an untraced call's device idle
time that fall to the span ``intraday.scatter``
(``csmom_tpu_torch/api.py::intraday_on_device``): the span's share of the
host-ops stretch's idle gaps times the idle a call (see ``_phases.py``)."""

from perfbench.metrics._phases import idle_ms


def read(ctx):
    return idle_ms(ctx, "intraday.scatter")
