"""Where the time goes: the north-star engines split into their phases.

    python -m csmom_tpu_torch.phases [--out PATH]

Needs a CUDA card (builds the kernels on first use).  On the north-star
month-end panel in f32 it times the 16-cell grid (rank and qcut) and
the monthly engine (qcut, J=12) whole with :func:`time_call` (CUDA
events and host wall, median of ``REPS`` after warm-up), and traces one
call of each engine with ``torch.profiler`` to get the device's busy
share and kernel launch count.  On the north-star minute quarter (500
names x 60 days of synthetic minute bars, compacted, f64) it times the
intraday pipeline's device body, ridge, the same way, split by its
``intraday.*`` spans and its engine's ``event.*`` spans, with one armed
call's counters (the spans' ``rows``, ``features`` and ``solves``,
``ridge.solves``, and K4's ``ridge_moments.launches`` and
``ridge_moments.rows``).  The grid's trace is one warm call split
by its phase spans (``grid.signal``, ``grid.ranking``, ``grid.cohorts``,
``grid.stats``: ranges of the profiler's trace, see
:mod:`csmom_tpu_torch.obs.spans`): device ms, kernel launches and host
ms of each (:func:`span_phases`).  The monthly engine's phases are
still timed one by one.  Prints one JSON object
(and writes it to ``--out`` if given).  ``chip_smoke.py`` times with
the same helper and repetition count, and times each kernel by its own
device time with :func:`time_kernels`.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import time

import torch

from csmom_tpu_torch.backtest.grid import jk_grid_backtest
from csmom_tpu_torch.backtest.monthly import _assemble_result, monthly_spread_backtest
from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum,
    monthly_returns,
)
from csmom_tpu_torch.api import intraday_on_device
from csmom_tpu_torch.obs import spans
from csmom_tpu_torch.obs.metrics import counter
from csmom_tpu_torch.workloads import (
    GRID_JS,
    GRID_KS,
    GRID_SKIP,
    NORTH_STAR_MINUTES,
    minute_panels,
    north_star_month_panel,
)


# timed repetitions per measurement, after 3 warm-up calls
REPS = 25
# traces time_kernels may take before it gives up on a lossy profiler
TRACE_ATTEMPTS = 3
# idle host time at each end of a trace, seconds
_TRACE_MARGIN_S = 0.05
# L2 flush size for cold timings: 256 MB, over the H100's 50 MB L2
_FLUSH_INTS = 64 * 2**20
# the grid's phase spans, in the order a call opens them
GRID_SPANS = ("grid.signal", "grid.ranking", "grid.cohorts", "grid.stats")
# the intraday pipeline's, then its threshold engine's
INTRADAY_SPANS = ("intraday.features", "intraday.fit", "intraday.scatter",
                  "event.decide", "event.fill", "event.settle")


def time_call(fn, cold=False, reps=REPS, warmup=3):
    """(median device ms by CUDA events, median host ms) of ``fn()`` over
    ``reps`` calls after ``warmup`` warm-up calls.  ``cold`` overwrites a
    buffer larger than L2 before each call, outside the timed region.
    Calls that take seconds (a model fit at scale) pass fewer of both."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(_FLUSH_INTS, dtype=torch.int32, device="cuda") if cold else None
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        if cold:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(host)


def time_kernels(fn, names, split=False, clean=False):
    """(median device ms, kernels per call) of the CUDA kernels that
    ``fn()`` launches whose names contain one of ``names``, traced with
    ``torch.profiler`` over ``REPS`` calls after 3 warm-up calls, L2
    flushed before each call.  A call's time is the sum of its matching
    kernels' own durations, so the wrapper's host work before the launch
    is not in it; the flush's fill kernel matches no name.  With
    ``split=True`` a third item ``{name: median ms}`` gives each name's
    own share of a call (the kernels matching that name, summed per
    call).  The flush writes its buffer, so the call starts with L2 full
    of dirty lines that its reads must first write back; ``clean=True``
    flushes by reading the buffer instead (its reduction must match no
    name).

    The profiler now and then loses kernel records from a trace, which
    shows as a count of matching kernels that is not the same for every
    call; each trace has idle margins at both ends against that.  A
    trace that lost records all the same is taken again, up to
    ``TRACE_ATTEMPTS`` traces in all; each retry is reported on stderr,
    and a count that is still uneven raises."""
    for _ in range(3):
        fn()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        spans = _matching_spans(fn, names, clean)
        per_call, rest = divmod(len(spans), REPS)
        if per_call and not rest:
            break
        msg = (f"time_kernels: {len(spans)} kernels matching {list(names)} "
               f"in {REPS} calls (trace {attempt} of {TRACE_ATTEMPTS})")
        if attempt == TRACE_ATTEMPTS:
            raise RuntimeError(msg)
        print(f"{msg}; tracing again", file=sys.stderr, flush=True)
    calls = [spans[i:i + per_call] for i in range(0, len(spans), per_call)]
    median = statistics.median(sum(s[1] for s in c) / 1e3 for c in calls)
    if not split:
        return median, per_call
    by_name = {n: statistics.median(sum(s[1] for s in c if n in s[2]) / 1e3
                                    for c in calls)
               for n in names}
    return median, per_call, by_name


def _matching_spans(fn, names, clean):
    """(start, µs, name) of every CUDA kernel matching ``names`` in one
    trace of ``REPS`` flushed calls of ``fn()``, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(_FLUSH_INTS, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle margins keep the calls away from the trace's edges, where
        # device records whose times, moved onto the host's clock, fall
        # outside the capture window can be dropped
        time.sleep(_TRACE_MARGIN_S)
        for _ in range(REPS):
            if clean:
                flush.sum()
            else:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
        time.sleep(_TRACE_MARGIN_S)
    return sorted(
        (evt.time_range.start, evt.time_range.elapsed_us(), evt.name)
        for evt in prof.events()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and any(n in evt.name for n in names))


def _trace(fn, warm=True):
    """One traced call: device-busy ms (sum of kernel and copy times),
    wall ms, and the number of device activities (the device-side twins
    of profiler ranges, such as the phase spans', are not activities);
    ``warm`` calls ``fn()`` once untraced first."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_us, n = 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False):
            busy_us += evt.time_range.elapsed_us()
            n += 1
    return {"wall_ms": wall, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall if wall else None,
            "device_activities": n}


def _phase_events(fn, names):
    """One traced call of ``fn()`` (after an untraced one): ``(ranges,
    annotations, device_ops, wall_ms)``, the first three as plain tuples on
    the trace's clock, in µs.  ``ranges`` are the host ranges ``(name,
    start, end)`` of the spans in ``names``, ``annotations`` their
    device-side ranges (from the first start to the last end of the device
    work launched inside each), ``device_ops`` each kernel or copy
    ``(name, start, end)``, and ``wall_ms`` the traced call's host wall to
    its device's end."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(_TRACE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(_TRACE_MARGIN_S)
    cuda = torch.autograd.DeviceType.CUDA
    ranges, annotations, device_ops = [], [], []
    for ev in prof.events():
        item = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type != cuda:
            if ev.name in names:
                ranges.append(item)
        elif getattr(ev, "is_user_annotation", False):
            if ev.name in names:
                annotations.append(item)
        else:
            device_ops.append(item)
    return ranges, annotations, device_ops, wall


def span_phases(ranges, annotations, device_ops, names):
    """Device ms, kernel launches and host ms of each span in ``names``,
    from :func:`_phase_events`' tuples.  A device operation belongs to the
    span whose device-side range holds its start: the profiler links a
    kernel record to no host operation (torch 2.11), but gives each range
    a device-side twin.  ``whole`` sums every device operation of the
    trace, and ``unplaced`` counts those in no span."""
    out = {n: {"device_ms": 0.0, "launches": 0, "host_ms": 0.0} for n in names}
    for n, s, e in ranges:
        out[n]["host_ms"] += (e - s) / 1e3
    whole = {"device_ms": 0.0, "launches": 0, "unplaced": 0}
    annotations = sorted(annotations, key=lambda r: r[1])
    starts = [s for _, s, _ in annotations]
    for name, s, e in device_ops:
        ms, k = (e - s) / 1e3, int(not name.startswith(("Memcpy", "Memset")))
        whole["device_ms"] += ms
        whole["launches"] += k
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or s > annotations[i][2]:
            whole["unplaced"] += 1
            continue
        out[annotations[i][0]]["device_ms"] += ms
        out[annotations[i][0]]["launches"] += k
    out["whole"] = whole
    return out


def grid_phases(pm, mm, mode):
    """The 16-cell grid whole (:func:`time_call`), one traced warm call of
    it split by its phase spans (:func:`span_phases`; its ``whole`` is the
    traced call's device ms and launches), and one call's counts of K3
    (``rank_labels.launches``, and ``rank_labels.wide_rows``: rows too wide
    for K3, ranked by the plain sort)."""
    def call():
        return jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP, mode=mode)

    d, h = time_call(call)
    kernels.reset_launches()
    call()
    counts = {"rank_labels.launches": kernels.rank_labels.launches,
              "rank_labels.wide_rows": kernels.rank_labels.wide_rows}
    *events, wall = _phase_events(call, GRID_SPANS)
    return {"whole": {"device_ms": d, "host_ms": h, "traced_wall_ms": wall},
            "spans": span_phases(*events, GRID_SPANS), "counts": counts}


def intraday_counts(call):
    """The counters of one armed call of the intraday pipeline: each
    ``intraday.*`` span's attributes, as ``<span>.<attribute>``, the
    ``ridge.solves`` it added, and K4's ``ridge_moments.launches`` and
    ``ridge_moments.rows`` (the design rows the kernel passed over) in
    the call.  Arms in memory for the call, then disarms."""
    solves = counter("ridge.solves")
    col = spans.arm(None)
    try:
        before = solves.value
        kernels.reset_launches()
        call()
        added = solves.value - before
    finally:
        spans.disarm()
    counts = {f"{r['name']}.{k}": v for r in col.events
              if r["name"].startswith("intraday.") for k, v in r["attrs"].items()}
    counts["ridge.solves"] = added
    counts["ridge_moments.launches"] = kernels.ridge_moments.launches
    counts["ridge_moments.rows"] = kernels.ridge_moments.rows
    return counts


def intraday_phases(panels):
    """The intraday pipeline's device body (``intraday_on_device``, ridge,
    its defaults) on ``panels`` whole (:func:`time_call`), one traced warm
    call split by its phase spans and the engine's (:func:`span_phases`),
    and one armed call's counters (:func:`intraday_counts`)."""
    def call():
        return intraday_on_device(*panels)

    d, h = time_call(call)
    counts = intraday_counts(call)
    *events, wall = _phase_events(call, INTRADAY_SPANS)
    return {"whole": {"device_ms": d, "host_ms": h, "traced_wall_ms": wall},
            "spans": span_phases(*events, INTRADAY_SPANS), "counts": counts}


def monthly_phases(pm, mm):
    ret, ret_valid = monthly_returns(pm, mm)
    mom, mom_valid = momentum(pm, mm, 12, 1)
    mom_valid = mom_valid & formation_listed_mask(mm, 1)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, mode="qcut")
    phases = {
        "returns": lambda: monthly_returns(pm, mm),
        "signal": lambda: momentum(pm, mm, 12, 1),
        "ranking": lambda: decile_assign_panel(mom, mom_valid, mode="qcut"),
        "aggregate_and_stats": lambda: _assemble_result(ret, ret_valid, labels,
                                                        10, 12),
        "whole": lambda: monthly_spread_backtest(pm, mm, 12, 1, mode="qcut"),
    }
    return _run(phases)


def _run(phases):
    out = {}
    for name, fn in phases.items():
        d, h = time_call(fn)
        out[name] = {"device_ms": d, "host_ms": h}
    out["whole"]["trace"] = _trace(phases["whole"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    pm, mm, _ = north_star_month_panel(device="cuda", dtype=torch.float32)
    record = {
        "card": card,
        "panel": list(pm.shape),
        "reps": REPS,
        "grid16_rank": grid_phases(pm, mm, "rank"),
        "grid16_qcut": grid_phases(pm, mm, "qcut"),
        "monthly_qcut_J12": monthly_phases(pm, mm),
    }
    del pm, mm
    record["minute_panel"] = list(NORTH_STAR_MINUTES)
    record["intraday_ridge_f64"] = intraday_phases(
        minute_panels(*NORTH_STAR_MINUTES, device="cuda"))
    text = json.dumps(record)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
