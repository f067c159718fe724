"""Profiler traces of two stretches of timed calls, and their reduction.

A traced run takes two stretches from the middle of its window.  The first
runs under ``torch.profiler`` with CUDA activity alone, which slows the host
the least: its device operations are what the per-layer metrics read, and
its wall is taken on the host's clock.  The second records the host's
operations too, with each call inside a ``perfbench.call`` annotation; that
slows every call, so it only names the idle gaps of the breakdown by the
host operation under them.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

CALL_SPAN = "perfbench.call"
# the profiler drops device records near a trace's edges: idle margins
# keep the calls away from them
MARGIN_S = 0.05
BETWEEN_OPS = "host: between ops"
BETWEEN_CALLS = "harness: between calls"


def _union(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted ``[start, end]``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _largest(d: dict, top: int) -> list:
    return [[n[:200], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


@dataclasses.dataclass
class Trace:
    """The CUDA-only stretch: ``n_calls`` calls, their wall on the host's
    clock, the device operations ``(name, start_us, end_us)`` they ran, and
    the named stretch's idle gaps ``[[name, seconds], ...]``."""

    n_calls: int
    wall_us: float
    device_ops: list
    idle_gaps: list = dataclasses.field(default_factory=list)

    def busy_us(self) -> float:
        """Microseconds in which some device operation ran."""
        return sum(e - s for s, e in _union((s, e) for _, s, e in self.device_ops))

    def kernels(self) -> list:
        """Device operations that are kernels (not copies or fills)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def kernel_us(self, match: str | None = None) -> float:
        return sum(e - s for n, s, e in self.kernels() if match is None or match in n)

    def kernel_count(self, match: str | None = None) -> int:
        return sum(1 for n, _, _ in self.kernels() if match is None or match in n)

    def breakdown(self, top: int = 10) -> dict:
        """Device operations by total seconds, the ``top`` largest, and the
        named stretch's idle gaps."""
        ops: dict = {}
        for n, s, e in self.device_ops:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
        return {"device_ops": _largest(ops, top), "idle_gaps": self.idle_gaps[:top]}


@dataclasses.dataclass
class NamedStretch:
    """The stretch with host operations: the call spans ``(start_us,
    end_us)``, device operations and the host operations each call made
    directly, ``(name, start_us, end_us)``, on the trace's clock."""

    calls: list
    device_ops: list
    host_ops: list

    def __post_init__(self):
        self.calls = sorted(self.calls)
        self.host_ops = sorted(self.host_ops, key=lambda op: op[1])
        self._host_starts = [op[1] for op in self.host_ops]
        self._call_starts = [c[0] for c in self.calls]

    def gaps(self) -> list:
        """``(start_us, end_us)`` of each stretch from the first call's start
        to the last call's end in which no device operation ran."""
        lo, hi = self.calls[0][0], self.calls[-1][1]
        out, cur = [], lo
        for s, e in _union((max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                           if e > lo and s < hi):
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            out.append((cur, hi))
        return out

    def gap_owner(self, s: float, e: float) -> str:
        """The host operation that overlaps an idle gap most, or what the
        host did between operations or between calls.  A call's own host
        operations follow one another, so the ones that overlap a gap are
        a run in start order, found by bisection."""
        i = bisect.bisect_right(self._call_starts, s) - 1
        in_call = any(0 <= j < len(self.calls) and self.calls[j][0] < e
                      and s < self.calls[j][1] for j in (i, i + 1))
        if not in_call:
            return BETWEEN_CALLS
        best, best_ov = BETWEEN_OPS, 0.0
        lo = max(bisect.bisect_right(self._host_starts, s) - 1, 0)
        hi = bisect.bisect_left(self._host_starts, e)
        for n, hs, he in self.host_ops[lo:hi]:
            ov = min(e, he) - max(s, hs)
            if ov > best_ov:
                best, best_ov = n, ov
        return best

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds by the host operation under them, the ``top`` largest."""
        if not self.calls:
            return []
        idle: dict = {}
        for s, e in self.gaps():
            k = self.gap_owner(s, e)
            idle[k] = idle.get(k, 0.0) + (e - s) / 1e6
        return _largest(idle, top)


def capture(call, n_calls: int, cuda: bool, host_ops: bool):
    """Run ``call()`` ``n_calls`` times under the profiler: CUDA activity
    alone, or with ``host_ops`` the host's operations too (the host's alone
    where ``cuda`` is False; no profiler where neither is asked).  Returns
    ``(outputs, profile or None, wall_s)``; the wall runs from the first
    call's start to the last call's end, each call ending with its fetch."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = ([ProfilerActivity.CPU] if host_ops else []) + \
                 ([ProfilerActivity.CUDA] if cuda else [])
    span = (lambda: record_function(CALL_SPAN)) if host_ops else contextlib.nullcontext
    outs = []
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) if activities else contextlib.nullcontext() as prof:
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(n_calls):
            with span():
                outs.append(call())
        wall = time.perf_counter() - t0
        time.sleep(MARGIN_S)
    return outs, prof, wall


def _device_ops(events) -> list:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name, float(ev.time_range.start), float(ev.time_range.end))
            for ev in events if ev.device_type == cuda
            and not getattr(ev, "is_user_annotation", False)]


def named_stretch(events) -> NamedStretch:
    """A :class:`NamedStretch` from a profile's ``FunctionEvent`` list."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    calls, host_ops = [], []
    for ev in events:
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.name == CALL_SPAN:
            if ev.device_type != cuda:
                calls.append((s, e))
        elif ev.device_type != cuda and ev.cpu_parent is not None \
                and ev.cpu_parent.name == CALL_SPAN:
            host_ops.append((ev.name, s, e))
    return NamedStretch(calls=calls, device_ops=_device_ops(events), host_ops=host_ops)


def reduce(device_stretch, named) -> Trace:
    """The :class:`Trace` of a run from its two captures, each
    ``(n_calls, profile or None, wall_s)``; read once the window has
    closed, since reading a profile takes time."""
    n, prof, wall = device_stretch
    ops = _device_ops(prof.events()) if prof is not None else []
    gaps = named_stretch(named[1].events()).idle_gaps() if named[1] is not None else []
    return Trace(n_calls=n, wall_us=wall * 1e6, device_ops=ops, idle_gaps=gaps)
