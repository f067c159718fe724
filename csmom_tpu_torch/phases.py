"""Where the time goes: the north-star engines split into their phases.

    python -m csmom_tpu_torch.phases [--out PATH]

Needs a CUDA card (builds the kernels on first use).  On the north-star
month-end panel in f32 it times each phase of the 16-cell grid (rank and
qcut) and of the monthly engine (qcut, J=12) with :func:`time_call`
(CUDA events and host wall, median of ``REPS`` after warm-up), and
traces one call of each engine with ``torch.profiler`` to get the
device's busy share and kernel launch count.  Prints one JSON object
(and writes it to ``--out`` if given).  ``chip_smoke.py`` times with
the same helper and repetition count.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.backtest.grid import (
    _cohort_partial_sums,
    _finalize_cohorts,
    _holding_month_spreads,
    jk_grid_backtest,
)
from csmom_tpu_torch.backtest.monthly import _assemble_result, monthly_spread_backtest
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum,
    momentum_dynamic,
    monthly_returns,
)
from csmom_tpu_torch.workloads import GRID_JS, GRID_KS, GRID_SKIP, north_star_month_panel


# timed repetitions per measurement, after 3 warm-up calls
REPS = 25
# L2 flush size for cold timings: 256 MB, over the H100's 50 MB L2
_FLUSH_INTS = 64 * 2**20


def time_call(fn, cold=False):
    """(median device ms by CUDA events, median host ms) of ``fn()`` over
    ``REPS`` calls after 3 warm-up calls.  ``cold`` overwrites a buffer
    larger than L2 before each call, outside the timed region."""
    for _ in range(3):
        fn()
    flush = torch.empty(_FLUSH_INTS, dtype=torch.int32, device="cuda") if cold else None
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(REPS):
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


def _trace(fn):
    """One traced call: device-busy ms (sum of kernel and copy times),
    wall ms, and the number of device activities."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_us, n = 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += evt.time_range.elapsed_us()
            n += 1
    return {"wall_ms": wall, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall if wall else None,
            "device_activities": n}


def grid_phases(pm, mm, mode):
    Js = torch.tensor(GRID_JS, device=pm.device)
    Ks = torch.tensor(GRID_KS, device=pm.device)
    H = max(GRID_KS)
    ret, ret_valid = monthly_returns(pm, mm)
    mom, mom_valid = momentum_dynamic(pm, mm, Js, GRID_SKIP)
    mom_valid = mom_valid & formation_listed_mask(mm, GRID_SKIP)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, mode=mode)
    sums, counts = _cohort_partial_sums(labels, ret, ret_valid, 10, H)
    R, R_valid = _finalize_cohorts(sums, counts)
    spreads, live = _holding_month_spreads(R, R_valid, Ks)

    def stats():
        return (masked_mean(spreads, live), sharpe(spreads, live, 12),
                t_stat(spreads, live), nw_t_stat(spreads, live, lags=Ks[None, :],
                                                 max_lag=H))

    def signal():
        m, v = momentum_dynamic(pm, mm, Js, GRID_SKIP)
        v = v & formation_listed_mask(mm, GRID_SKIP)
        return torch.where(v, m, torch.nan)

    phases = {
        "returns": lambda: monthly_returns(pm, mm),
        "signal": signal,
        "ranking": lambda: decile_assign_panel(mom, mom_valid, mode=mode),
        "cohort_kernel": lambda: _cohort_partial_sums(labels, ret, ret_valid, 10, H),
        "holding_spreads": lambda: _holding_month_spreads(
            *_finalize_cohorts(sums, counts), Ks),
        "stats": stats,
        "whole": lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS,
                                          skip=GRID_SKIP, mode=mode),
    }
    return _run(phases)


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
    text = json.dumps(record)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
