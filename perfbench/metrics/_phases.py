"""The idle time of one engine phase in an untraced call, apportioned by
the trace's idle gaps.

The engines open their phases as spans (``grid.*`` in
``csmom_tpu_torch/backtest/grid.py``, ``event.*`` in
``csmom_tpu_torch/backtest/event.py``), and a span is a range of any
recording ``torch.profiler`` trace.  A range directly under a call's
``perfbench.call`` annotation owns the idle gaps it overlaps most
(``perfbench/trace.py``), so the host-ops stretch's ``idle_gaps`` name
each phase.  That stretch runs far slower than untraced calls (CUPTI and
the host's records), so its idle seconds are not read as such: a phase's
share of them is, times the idle a call of its own, the untraced wall a
call less the CUDA-only stretch's busy time a call (``idle_share``'s
numerator).  The phases' readings and the other owners' shares add up to
that idle a call.
"""

from __future__ import annotations

import inspect

from perfbench.trace import NamedStretch

# the most gap owners the trace keeps: a phase missing from a list this
# long may have been cut from it
TOP = inspect.signature(NamedStretch.idle_gaps).parameters["top"].default


def idle_ms(ctx, phase: str):
    """Milliseconds of an untraced call's device idle time that fall to the
    span ``phase``: its share of the host-ops stretch's idle gaps times the
    idle a call.  0.0 where the phase owns no gap; None where there is no
    trace, no device operation in it, no untraced wall, or the list of
    owners is full without the phase (a full list's shares are of the
    owners it kept)."""
    t = ctx.trace
    if t is None or not t.n_calls or not t.device_ops or not ctx.call_s:
        return None
    total = sum(seconds for _, seconds in t.idle_gaps)
    for name, seconds in t.idle_gaps:
        if name == phase:
            idle_s = ctx.call_s - t.busy_us() / t.n_calls / 1e6
            return seconds / total * idle_s * 1e3
    return None if len(t.idle_gaps) >= TOP else 0.0
