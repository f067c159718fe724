#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (csmom_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them, and whenever
any phase fails (nothing is caught).  Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off;
2. build: both CUDA kernels from csmom_tpu_torch/csrc, one nvcc each,
   in parallel;
3. kernels: K1 and K2 against their plain PyTorch versions at the test
   shapes and at the north-star shape, in f64 and f32, each launched
   twice to show bit-for-bit repeatable sums;
4. golden: the monthly engine in f64 reproduces the pinned synthetic
   fingerprints (the JAX package's tests/test_synthetic_golden.py);
5. north star: the month-end panel (3,000 stocks x 15,120 days) built and
   aggregated on the card, the monthly engine (qcut, J=12) and the
   16-cell J x K grid (rank and qcut) in f32 through the kernels — launch
   counts read around this run — checked against the plain versions and
   timed with CUDA events;
6. research paths (BASELINE configs 3 and 5): (a) on the golden panel in
   f64, the sector-neutral engine, its net of costs, the grid's netting,
   break-evens, walk-forward selection, block-bootstrap CIs and the
   threefry draws reproduce the JAX package's pinned ``RESEARCH``
   fingerprints; (b) at the north star in f32, ``hist`` labels equal
   ``rank`` labels, the matmul cohort sums equal K2's counts, the
   sector-neutral engine (11 sectors) equals its plain run, and each new
   path is timed with CUDA events — launch counts read around the run;
7. data-in: (a) the committed 8-ticker CSV universe through the native
   parser and ``monthly_price_panel`` on the card reproduces the JAX
   package's CSV golden in f64 through K1; (b) the north-star daily panel
   written as a two-field f32 pack, read back memmapped and aggregated on
   the card equals ``north_star_month_panel()`` bit for bit, and
   ``run_monthly`` (K1) and ``run_grid`` (K2) from it equal phase 5's
   results bit for bit; banded rebalancing (band 0 = the plain engine's
   spread and turnover charge) and tearsheets of the 16 cells; launch
   counts read around this run, and each step timed; (c) 512 tickers x
   3,780 days of CSVs in both dialects -> native ingest -> pack, with the
   pack equal to its frames and equal month-end panels from either source;
8. cli: the port's CLI (``csmom_tpu_torch.cli.main``) in-process on
   phase 7(b)'s pack with ``--device cuda``: ``replicate`` with every
   reporting flag (its statistics equal phase 5's monthly engine, K1 once),
   five ``--strategy`` runs (momentum bit-equal to the monthly engine; K1
   once each), ``grid`` and ``sweep`` (equal to phase 5's rank grid; K2
   once each), K2 held against its plain version at the horizon shapes
   and timed there, then ``horizons`` at 36 and 60 months and
   ``--by-volume`` (K2 once each, tables equal to the engines' own),
   ``doublesort``, ``residual`` (3 x 3 cells, K1 once a cell),
   ``pack-info``, ``strategies``, and ``replicate`` on the committed CSV
   universe in f64 (the CSV golden); each command's host wall on a
   ``[cli]`` line, launch counts read around each command;
9. a ``{"kernels": [...]}`` line: per kernel its launches, error, times
   and bound at the main-path shape.  ``ms`` is one call's time by CUDA
   events (the wrapper's host work before the launch included);
   ``device_ms`` the kernels' own durations in a profiler trace of the
   same call, ``kernels_per_call`` how many kernels it launched,
   ``wrapper_ms`` the difference and ``bound_share`` = bound / device;
   ``research_launches``, ``data_in_launches`` and ``cli_launches`` the
   counts of phases 6, 7 and 8;
then the card's name line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the monthly leg of the JAX package's committed synthetic golden
# (tests/test_synthetic_golden.py: synthetic_daily_panel(40, 1260,
# seed=123, listing_gaps=True), J=12, skip=1, f64)
MONTHLY = {
    "n_months": 58,
    "n_valid_spreads": 44,
    "mean_spread": -0.024151046163,
    "ann_sharpe": -0.838545964552,
    "nw_t": -2.001284759867,
    "cum_return": 0.271094424165,
}

# the research paths' leg of the same golden panel: the JAX package's own
# outputs in f64 (jax_enable_x64, so its bootstrap draws int64 indices),
# recomputed from csmom_tpu by tests/test_torch_inference.py so these pins
# cannot drift.  Sector ids: golden_sector_ids(); grid: J, K in {3, 6, 9,
# 12}, skip 1, rank mode; costs at 10 bps half-spread (monthly) and a unit
# half-spread (grid); bootstrap and draws from PRNGKey(0).
GOLDEN_SECTORS = 3
RESEARCH = {
    "sector_valid": 44,
    "sector_mean_spread": -0.02184539400257678,
    "sector_nw_t": -2.1447455472780788,
    "net10_mean": -0.023087818245001022,
    "net10_sharpe": -0.8227915036932137,
    "grid_unit_net_mean": [
        -1.1375619411478115, -0.5766345049280238, -0.4088790438471827,
        -0.2985255023033044, -0.8246914593086627, -0.604875565048859,
        -0.41812075472667704, -0.2869995931006015, -0.7712193945631716,
        -0.5438731071001996, -0.40523748264861215, -0.28584517664729353,
        -0.6821371426437131, -0.4704619733012217, -0.3753955398595861,
        -0.2805966447665517,
    ],
    "grid_break_even_bps": [
        -43.103115730822594, -136.56586485885552, -367.02917934739133,
        -324.1207566925033, -144.26851996988572, -369.29540083758184,
        -464.5538702284668, -93.87346476063426, -342.51174828094344,
        -513.1186133406032, -252.64462347402034, 78.86049986897648,
        -326.3051629685034, -196.48981961894424, 81.96616625393713,
        264.34538602034314,
    ],
    "wf_choice": [
        -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
        -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 15, 15, 15, 15, 15, 15, 15, 15,
        15,
    ],
    "wf_oos_mean": 0.00013420447103893384,
    "ci_lo": [
        -0.017202204168308873, -0.021317994081515287, -0.031737939554437045,
        -0.024565331851112603, -0.04396679417973012, -0.053507869079660826,
        -0.043135847167136546, -0.01577099144566405, -0.058615576649757306,
        -0.05648369283213483, -0.031877705239885486, -0.015095789505290022,
        -0.043033728729207306, -0.03423074349276336, -0.016358061469760186,
        -0.011263989698251398,
    ],
    "ci_hi": [
        0.009305687620646149, 0.004067271771847802, -0.0017797179226282458,
        0.0018299452066358295, 0.011749231295398479, 0.002331093131830444,
        -0.0005929201760837455, 0.012356232631685312, 0.0028775928861093157,
        -0.0012209196075792668, 0.016723919247570055, 0.02244877744741283,
        -0.002649450482245071, 0.015277745920678428, 0.024139569073935104,
        0.026747658451305112,
    ],
    "randint32_sum": 8042429.0,
    "randint32_head": [349, 576, 296, 205, 155, 3, 528, 311],
    "randint64_sum": 8054003.0,
    "randint64_head": [87, 575, 119, 437, 357, 343, 530, 24],
    "uniform32_sum": 11577.633524537086,
    "uniform32_head": [
        0.9476670026779175, 0.9785798788070679, 0.33229148387908936,
        0.46866846084594727, 0.569888710975647, 0.16550302505493164,
        0.31019461154937744, 0.6894805431365967,
    ],
}


def golden_sector_ids(n_assets: int) -> np.ndarray:
    """Seeded sector ids in [-1, GOLDEN_SECTORS) (-1: unclassified)."""
    return np.random.default_rng(5).integers(-1, GOLDEN_SECTORS, size=n_assets)


def research_fingerprints(dev) -> dict:
    """The port's research paths on the golden panel in f64 on ``dev``:
    the values ``RESEARCH`` pins, by the same names."""
    import torch

    from csmom_tpu_torch import random
    from csmom_tpu_torch.analytics.tables import jk_grid_ci_table
    from csmom_tpu_torch.backtest.grid import (
        grid_break_even_bps, grid_net_of_costs, jk_grid_backtest,
    )
    from csmom_tpu_torch.backtest.monthly import net_of_costs, sector_neutral_backtest
    from csmom_tpu_torch.backtest.walkforward import walk_forward_select
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.panel import to_tensors
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.workloads import GRID_JS, GRID_KS

    daily = synthetic_daily_panel(40, 1260, seed=123, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device=dev)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    sid = torch.as_tensor(golden_sector_ids(pm.shape[0]), device=dev)
    sec = sector_neutral_backtest(pm, mm, sid, GOLDEN_SECTORS, lookback=12, skip=1)
    _, net_mean, net_sharpe = net_of_costs(sec, half_spread=0.001)
    g = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=1, mode="rank")
    unit = grid_net_of_costs(pm, mm, g, half_spread=1.0)
    be, _ = grid_break_even_bps(pm, mm, g, unit=unit)
    wf = walk_forward_select(g.spreads, g.spread_valid)
    lo, hi = jk_grid_ci_table(g.spreads, g.spread_valid, GRID_JS, GRID_KS,
                              key=random.PRNGKey(0, device=dev), n_samples=200,
                              index_dtype=torch.int64)
    key = random.PRNGKey(0, device=dev)
    draws = {
        "randint32": random.randint(key, (200, 116), 0, 696, dtype=torch.int32),
        "randint64": random.randint(key, (200, 116), 0, 696, dtype=torch.int64),
        "uniform32": random.uniform(key, (200, 116), dtype=torch.float32),
    }
    got = {
        "sector_valid": int(sec.spread_valid.sum()),
        "sector_mean_spread": float(sec.mean_spread),
        "sector_nw_t": float(sec.tstat_nw),
        "net10_mean": float(net_mean),
        "net10_sharpe": float(net_sharpe),
        "grid_unit_net_mean": unit.mean_spread.flatten().tolist(),
        "grid_break_even_bps": be.flatten().tolist(),
        "wf_choice": wf.choice.tolist(),
        "wf_oos_mean": float(wf.mean_spread),
        "ci_lo": lo.to_numpy().ravel().tolist(),
        "ci_hi": hi.to_numpy().ravel().tolist(),
    }
    for name, d in draws.items():
        got[f"{name}_sum"] = float(d.to(torch.float64).sum())
        got[f"{name}_head"] = d.flatten()[:8].tolist()
    return got


def check_research(got: dict) -> None:
    """Hold fingerprints to ``RESEARCH``: integers and draws exactly, floats
    to the f64 golden's ``rtol=1e-9``."""
    if set(got) != set(RESEARCH):
        raise AssertionError(f"research keys differ: {sorted(set(got) ^ set(RESEARCH))}")
    for k, want in RESEARCH.items():
        exact = isinstance(want, int) or k == "wf_choice" or k.endswith("_head") \
            or k.startswith("randint")
        if exact:
            if got[k] != want:
                raise AssertionError(f"research {k}: {got[k]} != {want}")
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-9, err_msg=k)


# tests/test_synthetic_golden.py::test_csv_universe_golden: the committed
# universe (tests/fixtures/universe, 8 tickers in both cache dialects),
# lookback 6, skip 1, 4 bins, f64
CSV_GOLDEN = {"shape": (8, 23), "n_valid_spreads": 15, "mean_spread": 0.007170869622,
              "ann_sharpe": 0.207281538823, "nw_t": 0.249081731114}
# the JAX package's ingest workload (BENCH_FULL_r05.json, pack_ingest_note)
CSV_AT_SCALE = (512, 3780)


def write_csv_cache(daily, volume, out_dir: str) -> list:
    """Each asset's listed days as one cache CSV, ``<ticker>_daily.csv``, in
    dialect A (Date header and a junk ticker row) for even rows and
    dialect B (Price/Ticker/Date preamble, no Adj Close) for odd ones, six
    decimals.  Returns the tickers."""
    import pandas as pd

    dates = np.datetime_as_string(daily.times.astype("datetime64[D]"))
    for i, t in enumerate(daily.tickers):
        live = daily.mask[i]
        close = daily.values[i, live]
        cols = {"Date": dates[live]}
        if i % 2 == 0:
            cols["Adj Close"] = close
            head = f"Date,Adj Close,Close,High,Low,Open,Volume\n,{t},{t},{t},{t},{t},{t}\n"
        else:
            head = f"Price,Close,High,Low,Open,Volume\nTicker,{t},{t},{t},{t},{t}\nDate,,,,,\n"
        cols.update({"Close": close, "High": close * 1.01, "Low": close * 0.99,
                     "Open": close * 1.002,
                     "Volume": volume[i, live].astype(np.int64)})
        body = pd.DataFrame(cols).to_csv(header=False, index=False, float_format="%.6f")
        with open(os.path.join(out_dir, f"{t}_daily.csv"), "w") as f:
            f.write(head + body)
    return list(daily.tickers)


def same(a, b) -> bool:
    """Bit-for-bit equal arrays or tensors (NaN where NaN), of one type."""
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and a[~nan].tobytes() == b[~nan].tobytes()


def data_in(dev, smi, pm, mm, ends, mres, grids, pack_dir) -> dict:
    """Phase 7: CSV caches and packs -> month-end panels on the card.

    ``pm, mm, ends`` are phase 5's north-star month-end panel, ``mres`` its
    monthly engine run and ``grids`` its grids; part (b) writes its pack to
    ``pack_dir``, which the caller keeps for phase 8.  Returns the kernel
    launch counts of part (b)'s run (the slice's main path at full width)."""
    import warnings

    import torch

    from csmom_tpu_torch import native
    from csmom_tpu_torch.analytics.stats import nw_t_stat
    from csmom_tpu_torch.analytics.tearsheet import tearsheet
    from csmom_tpu_torch.api import monthly_price_panel
    from csmom_tpu_torch.backends.dispatch import run_grid, run_monthly
    from csmom_tpu_torch.backtest.banded import banded_monthly_backtest
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
    from csmom_tpu_torch.costs.impact import long_short_weights, turnover_cost
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.panel.ingest import load_daily, long_to_panel
    from csmom_tpu_torch.panel.pack import load_packed, pack_csv_cache, save_packed
    from csmom_tpu_torch.panel.panel import Panel, PanelBundle
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.phases import REPS, time_call
    from csmom_tpu_torch.workloads import NORTH_STAR_GRID

    def wall(fn):
        """(result, host ms) of ``fn()``, the card synchronized around it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def copy_ms(dst, src, reps=5):
        """Median CUDA-event ms of ``dst.copy_(src)`` (asynchronous when
        ``src`` is pinned)."""
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def dir_bytes(path):
        return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))

    if not native.available():
        raise AssertionError("data-in: the native CSV parser did not build")

    # (a) the committed CSV universe, f64, through K1
    universe = os.path.join(REPO, "tests", "fixtures", "universe")
    tickers = sorted(n.split("_")[0] for n in os.listdir(universe))
    files0 = native.parse_price_csv_native.files
    kernels.reset_launches()
    (prices, _), golden_ms = wall(lambda: monthly_price_panel(universe, tickers))
    parsed = native.parse_price_csv_native.files - files0
    if parsed != len(tickers):
        raise AssertionError(f"data-in (a): {parsed} of {len(tickers)} files parsed natively")
    if prices.shape != CSV_GOLDEN["shape"] or prices.values.dtype != np.float64:
        raise AssertionError(f"data-in (a): panel {prices.shape} {prices.values.dtype}")
    v, m = prices.tensors()
    res = monthly_spread_backtest(v, m, lookback=6, skip=1, n_bins=4)
    k1_golden = kernels.decile_partial_sums.launches
    if k1_golden < 1:
        raise AssertionError("data-in (a): K1 was not launched")
    got = {"n_valid_spreads": int(res.spread_valid.sum()),
           "mean_spread": float(res.mean_spread), "ann_sharpe": float(res.ann_sharpe),
           "nw_t": float(nw_t_stat(res.spread, res.spread_valid))}
    if got["n_valid_spreads"] != CSV_GOLDEN["n_valid_spreads"]:
        raise AssertionError(f"data-in (a): {got['n_valid_spreads']} valid spreads")
    for k in ("mean_spread", "ann_sharpe", "nw_t"):
        np.testing.assert_allclose(got[k], CSV_GOLDEN[k], rtol=1e-9, err_msg=k)
    log("data-in", f"(a) CSV universe {len(tickers)} tickers, every file by the native "
                   f"parser -> {prices.shape[0]}x{prices.shape[1]} f64 month ends on "
                   f"{dev}: the JAX package's CSV golden reproduced ({got}); K1 "
                   f"launches {k1_golden}; monthly_price_panel {golden_ms:.2f} ms host")

    # (b) the north-star daily panel as a two-field f32 pack
    n_stocks, n_days = NORTH_STAR_GRID
    t0 = time.perf_counter()
    daily = synthetic_daily_panel(n_stocks, n_days, seed=7, listing_gaps=True)
    vol = np.random.default_rng(70).integers(10_000, 5_000_000, size=daily.shape
                                             ).astype(np.float32)
    vol[~daily.mask] = np.nan
    gen_ms = (time.perf_counter() - t0) * 1e3
    fields = {"adj_close": daily.values.astype(np.float32), "volume": vol}
    bundle = PanelBundle(
        panels={f: Panel(values=x, mask=daily.mask, tickers=daily.tickers,
                         times=daily.times, name=f) for f, x in fields.items()},
        tickers=daily.tickers, times=daily.times)
    _, write_ms = wall(lambda: save_packed(bundle, pack_dir))
    packed, open_ms = wall(lambda: load_packed(pack_dir))
    if not isinstance(packed["adj_close"].values, np.memmap):
        raise AssertionError("data-in (b): the pack did not open memmapped")
    # the hand-off of both memmapped fields (read into pinned host
    # memory, then copied), and its two parts for the price field
    _, tensors_ms = wall(lambda: [packed[f].tensors() for f in packed.fields])
    src = packed["adj_close"].values
    pinned = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        _, fill_ms = wall(lambda: pinned.copy_(torch.from_numpy(src)))
    pageable = torch.from_numpy(np.array(src))
    dst = torch.empty(src.shape, dtype=torch.float32, device=dev)
    h2d = {"pinned": copy_ms(dst, pinned), "pageable": copy_ms(dst, pageable)}
    if not same(dst, pageable):
        raise AssertionError("data-in (b): the copied panel differs from the pack")
    del pinned, pageable, dst

    # the slice's main path at full width; launch counts read around it
    kernels.reset_launches()
    (dprices, dvolume), mpp_ms = wall(lambda: monthly_price_panel(pack_dir, None))
    rep, run_monthly_ms = wall(lambda: run_monthly(dprices, lookback=12, skip=1,
                                                   mode="qcut"))
    grep, run_grid_ms = wall(lambda: run_grid(dprices, mode="rank"))
    dpm, dmm = dprices.tensors()
    band1 = banded_monthly_backtest(dpm, dmm, lookback=12, skip=1, mode="qcut", band=1)
    band0 = banded_monthly_backtest(dpm, dmm, lookback=12, skip=1, mode="qcut", band=0)
    gs = torch.as_tensor(grep.spreads, device=dev)
    gv = torch.as_tensor(grep.spread_valid, device=dev)
    ts = tearsheet(gs, gv)
    torch.cuda.synchronize()
    launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"data-in (b): a kernel was not launched: {launches}")
    pack_mb = dir_bytes(pack_dir) / 1e6
    mpp_again = [wall(lambda: monthly_price_panel(pack_dir, None))[1] for _ in range(2)]

    # the month ends are a selection, so the f32 pack aggregates to the
    # generated panel's month ends bit for bit
    if not (same(dprices.values, pm) and same(dprices.mask, mm)
            and np.array_equal(dprices.times, ends) and dprices.tickers == daily.tickers
            and dprices.values.dtype == np.float32):
        raise AssertionError("data-in (b): the pack's month ends differ from "
                             "north_star_month_panel()")
    if not (np.array_equal(dvolume.mask, dprices.mask)
            and bool((dvolume.values[dvolume.mask] > 0).all())
            and bool((dvolume.values[~dvolume.mask] == 0).all())):
        raise AssertionError("data-in (b): monthly volumes or their mask are wrong")
    np.testing.assert_allclose(dvolume.values.astype(np.float64).sum(),
                               np.nansum(vol, dtype=np.float64), rtol=1e-6)
    if not (same(rep.labels, mres.labels) and same(rep.decile_counts, mres.decile_counts)
            and same(rep.decile_means, mres.decile_means)
            and same(rep.spread, torch.where(mres.spread_valid, mres.spread, torch.nan))
            and rep.mean_spread == float(mres.mean_spread)
            and rep.tstat_nw == float(mres.tstat_nw)):
        raise AssertionError("data-in (b): run_monthly from the pack differs from phase 5")
    g5 = grids["rank"]
    if not all(same(getattr(grep, k), getattr(g5, k)) for k in
               ("spreads", "spread_valid", "mean_spread", "ann_sharpe", "tstat_nw")):
        raise AssertionError("data-in (b): run_grid from the pack differs from phase 5")
    # band 0 is the plain engine: its spread and its turnover charge
    if not torch.equal(band0.spread_valid, mres.spread_valid):
        raise AssertionError("data-in (b): band=0 validity differs from the plain engine")
    torch.testing.assert_close(band0.spread, mres.spread, rtol=0, atol=SPREAD_ATOL,
                               equal_nan=True)
    charge = turnover_cost(long_short_weights(mres.labels, mres.decile_counts, 10,
                                              dtype=torch.float32), half_spread=1.0)
    torch.testing.assert_close(band0.turnover, charge, rtol=F32_RTOL, atol=F32_ATOL)
    if not float(band1.turnover.mean()) < float(band0.turnover.mean()):
        raise AssertionError("data-in (b): the band did not cut turnover")
    # the tearsheet on the card against its CPU run on the same spreads
    ts_cpu = tearsheet(gs.cpu(), gv.cpu())
    for f in ts.__dataclass_fields__:
        a, b = getattr(ts, f).cpu(), getattr(ts_cpu, f)
        if f == "n_periods":
            if not torch.equal(a, b) or not torch.equal(a, gv.sum(-1).to(torch.int32).cpu()):
                raise AssertionError("data-in (b): tearsheet period counts")
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, equal_nan=True, msg=f)
    if tuple(ts.ann_return.shape) != (4, 4) or not bool(torch.isfinite(ts.ann_return).all()):
        raise AssertionError("data-in (b): tearsheet returns not finite over 4x4 cells")
    banded_ms = time_call(lambda: banded_monthly_backtest(dpm, dmm, 12, 1, mode="qcut", band=1))
    tear_ms = time_call(lambda: tearsheet(gs, gv))
    log("data-in", f"(b) {n_stocks}x{n_days} f32 pack ({pack_mb:.1f} MB: adj_close and "
                   f"volume, values and masks) -> {dprices.shape[0]}x{dprices.shape[1]} "
                   f"month ends on {dev} equal north_star_month_panel() bit for bit; "
                   f"run_monthly (qcut, J=12; K1) and run_grid (rank; K2) from it equal "
                   f"phase 5 bit for bit; band 0 = the plain engine's spread and "
                   f"turnover charge (max |turnover err| "
                   f"{(band0.turnover - charge).abs().max().item():.3g}); band 1 mean "
                   f"turnover {float(band1.turnover.mean()):.4f} vs "
                   f"{float(band0.turnover.mean()):.4f}; tearsheet of 16 cells equals "
                   f"its CPU run; launches {launches}")
    timings = {
        "generate_host_ms": gen_ms, "pack_write_ms": write_ms, "pack_open_ms": open_ms,
        "tensors_two_fields_ms": tensors_ms,
        "adj_close_read_into_pinned_ms": fill_ms,
        "adj_close_h2d_pinned_ms": h2d["pinned"], "adj_close_h2d_pageable_ms": h2d["pageable"],
        "adj_close_mb": src.nbytes / 1e6,
        "monthly_price_panel_ms": [mpp_ms] + mpp_again,
        "run_monthly_ms": run_monthly_ms, "run_grid_ms": run_grid_ms,
        "banded_band1_device_ms": banded_ms[0], "banded_band1_host_ms": banded_ms[1],
        "tearsheet_16_device_ms": tear_ms[0], "tearsheet_16_host_ms": tear_ms[1],
    }
    log("data-in", f"(b) times (host wall around a synchronized call unless named "
                   f"device: CUDA events, medians of {REPS}; H2D medians of 5) "
                   f"{json.dumps(timings)} | {smi}")

    # (c) CSVs at scale in both dialects -> native ingest -> pack
    n_csv, d_csv = CSV_AT_SCALE
    cdaily = synthetic_daily_panel(n_csv, d_csv, seed=7, listing_gaps=True)
    cvol = np.random.default_rng(71).integers(10_000, 5_000_000, size=cdaily.shape)
    with tempfile.TemporaryDirectory(prefix="csmom_smoke_") as tmp:
        csv_dir, cpack = os.path.join(tmp, "csv"), os.path.join(tmp, "pack")
        os.makedirs(csv_dir)
        ctk, csv_write_ms = wall(lambda: write_csv_cache(cdaily, cvol, csv_dir))
        csv_mb = dir_bytes(csv_dir) / 1e6
        files0 = native.parse_price_csv_native.files
        df, load_ms = wall(lambda: load_daily(csv_dir, ctk))
        _, pack_ms = wall(lambda: pack_csv_cache(csv_dir, ctk, cpack))
        parsed = native.parse_price_csv_native.files - files0
        if parsed != 2 * n_csv:
            raise AssertionError(f"data-in (c): {parsed} of {2 * n_csv} files parsed natively")
        cp = load_packed(cpack)
        for f in ("adj_close", "volume"):
            want = long_to_panel(df, f)
            if not (same(cp[f].values, want.values) and same(cp[f].mask, want.mask)
                    and cp[f].tickers == want.tickers
                    and np.array_equal(cp[f].times, want.times)):
                raise AssertionError(f"data-in (c): the pack's {f} differs from its frames")
        if len(cp["adj_close"].tickers) != n_csv or len(df) != int(cdaily.mask.sum()):
            raise AssertionError(f"data-in (c): {len(df)} rows of {int(cdaily.mask.sum())}")
        (csv_p, csv_v), csv_mpp_ms = wall(lambda: monthly_price_panel(csv_dir, ctk))
        (pk_p, pk_v), pack_mpp_ms = wall(lambda: monthly_price_panel(cpack, ctk))
        for a, b in ((csv_p, pk_p), (csv_v, pk_v)):
            if not (same(a.values, b.values) and same(a.mask, b.mask)
                    and a.tickers == b.tickers and np.array_equal(a.times, b.times)):
                raise AssertionError("data-in (c): CSV and pack month ends differ")
        cpack_mb = dir_bytes(cpack) / 1e6
    log("data-in", f"(c) {n_csv} tickers x {d_csv} days as CSVs in both dialects "
                   f"({csv_mb:.1f} MB, {len(df)} rows) -> native ingest -> f64 pack "
                   f"({cpack_mb:.1f} MB) equal to its frames; month ends "
                   f"{csv_p.shape[0]}x{csv_p.shape[1]} equal from the CSVs and the pack; "
                   + json.dumps({"csv_write_ms": csv_write_ms, "load_daily_native_ms": load_ms,
                                 "pack_csv_cache_ms": pack_ms,
                                 "monthly_price_panel_csv_ms": csv_mpp_ms,
                                 "monthly_price_panel_pack_ms": pack_mpp_ms})
                   + f" | {smi}")
    return launches


def k2_bound_inputs(labels, ret, ret_valid, n_bins: int, H: int):
    """(bytes, operations) K2 must move and do on these inputs: each input
    read once and both outputs written once; two adds per (member,
    horizon inside the panel)."""
    nJ, A, M = labels.shape
    out_bytes = 2 * nJ * 2 * M * H * ret.element_size()
    nbytes = labels.nbytes + ret.nbytes + ret_valid.nbytes + out_bytes
    members = ((labels == 0).sum(dim=(0, 1)) + (labels == n_bins - 1).sum(dim=(0, 1)))
    horizons = (M - 1 - np.arange(M)).clip(0, H)
    return nbytes, 2 * int((members.cpu().numpy().astype(np.int64) * horizons).sum())


def cli_phase(dev, smi, pack_dir, out_dir, mres, grids, assert_sums, bound) -> dict:
    """Phase 8: the port's CLI on phase 7(b)'s pack, in-process, on the card.

    ``mres`` and ``grids`` are phase 5's monthly engine run and grids on
    the same month ends.  Each command runs with the launch counts set to 0
    just before it and read just after; returns their sums per kernel."""
    import contextlib
    import io

    import torch

    from csmom_tpu_torch.analytics.tables import (
        double_sort_table,
        horizon_table,
        jk_grid_table,
        volume_horizon_table,
    )
    from csmom_tpu_torch.api import monthly_price_panel
    from csmom_tpu_torch.backends.dispatch import run_monthly
    from csmom_tpu_torch.backtest.double_sort import volume_double_sort
    from csmom_tpu_torch.backtest.horizon import (
        _momentum_labels,
        horizon_profile,
        volume_horizon_profile,
    )
    from csmom_tpu_torch.backtest.walkforward import walk_forward_select
    from csmom_tpu_torch.cli.main import main as cli
    from csmom_tpu_torch.ops import kernels
    from csmom_tpu_torch.phases import REPS, time_kernels
    from csmom_tpu_torch.signals.momentum import monthly_returns
    from csmom_tpu_torch.signals.turnover import turnover_features, volume_tercile_labels
    from csmom_tpu_torch.strategy import Momentum
    from csmom_tpu_torch.workloads import GRID_JS, GRID_KS

    common = ["--data-dir", pack_dir, "--device", "cuda", "--out", out_dir]
    totals = {"decile_partial_sums": 0, "cohort_partial_sums": 0}
    walls = {}

    def run(label, argv, k1, k2):
        """The command's stdout; it must exit 0 and launch K1 ``k1`` and
        K2 ``k2`` times."""
        buf = io.StringIO()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {"decile_partial_sums": kernels.decile_partial_sums.launches,
               "cohort_partial_sums": kernels.cohort_partial_sums.launches}
        if rc != 0:
            raise AssertionError(f"cli {label}: exit {rc}\n{buf.getvalue()}")
        if got != {"decile_partial_sums": k1, "cohort_partial_sums": k2}:
            raise AssertionError(f"cli {label}: launches {got}, expected K1 {k1}, K2 {k2}")
        for name, n in got.items():
            totals[name] += n
        walls[label] = ms
        log("cli", f"{label}: {ms:.2f} ms host wall, launches {got} | {smi}")
        return buf.getvalue()

    def expect(label, out, *texts):
        for text in texts:
            if text not in out:
                raise AssertionError(f"cli {label}: {text!r} not in its output:\n{out}")

    stats_lines = (f"Mean monthly spread: {float(mres.mean_spread):.6f}\n"
                   f"Annualized Sharpe:   {float(mres.ann_sharpe):.4f}\n"
                   f"t-stat (NW):         {float(mres.tstat_nw):.3f}\n"
                   f"t-stat (iid):        {float(mres.tstat):.3f}\n")

    prices, volume = monthly_price_panel(pack_dir, None)
    A, M = prices.shape

    # 1. replicate with every reporting flag: phase 5's monthly engine
    out = run("replicate", ["replicate", *common, "--tables", "--tc-bps", "10",
                            "--band", "1", "--bootstrap", "200", "--tearsheet"], 1, 0)
    expect("replicate", out, f"Universe: {A} tickers x {M} dates", stats_lines,
           "net of 10 bps half-spread turnover costs", "break-even half-spread",
           "hysteresis band 1", "Per-decile performance (R1 = losers):",
           "-- tearsheet: monthly spread (torch) --", "Per-year compounded spread:",
           "95% CI mean:", "95% CI Sharpe:")

    # 2. the strategies; momentum is the monthly engine bit for bit
    for name, extra in (("momentum", ()), ("low_volatility", ()),
                        ("volume_z_momentum", ()), ("residual_momentum", ()),
                        ("zscore_combo", ("--strategy-arg",
                                          "components=momentum:0.6,reversal:0.4"))):
        out = run(f"replicate --strategy {name}",
                  ["replicate", *common, "--strategy", name, *extra], 1, 0)
        expect(name, out, "strategy: ", "Mean monthly spread: ")
        if name == "momentum":
            expect(name, out, "strategy: Momentum(lookback=12, skip=1)\n", stats_lines)
    srep = run_monthly(prices, strategy=Momentum(), device="cuda")
    if not (same(srep.labels, mres.labels) and same(srep.decile_counts, mres.decile_counts)
            and same(srep.spread, torch.where(mres.spread_valid, mres.spread, torch.nan))
            and srep.mean_spread == float(mres.mean_spread)
            and srep.tstat_nw == float(mres.tstat_nw)):
        raise AssertionError("cli: --strategy momentum differs from the monthly engine")

    # 3. grid and sweep: phase 5's rank grid
    g = grids["rank"]
    out = run("grid --mode rank --tc-bps 5",
              ["grid", *common, "--mode", "rank", "--tc-bps", "5"], 0, 1)
    for title, df in zip(("mean monthly spread", "Newey-West t-stat (lag=K)",
                          "annualized Sharpe"),
                         jk_grid_table(g.spreads, g.spread_valid, GRID_JS, GRID_KS)):
        expect("grid", out, f"\n{title}:\n{df.round(4).to_string()}\n")
    expect("grid", out, "NET of 5 bps half-spread", "break-even half-spread (bps)",
           "95% CI mean spread, lower (200 block-bootstrap resamples):")
    out = run("sweep --mode rank", ["sweep", *common, "--mode", "rank"], 0, 1)
    wf = walk_forward_select(g.spreads, g.spread_valid, min_months=24)
    expect("sweep", out, "Selection basis:   gross\n",
           f"OOS months:        {int(wf.oos_valid.sum())}\n",
           f"OOS mean spread:   {float(wf.mean_spread):.6f}\n",
           f"OOS ann. Sharpe:   {float(wf.ann_sharpe):.4f}\n")

    # 4. K2 at the horizon commands' shapes against its plain version,
    # timed there; then the commands, each one K2 launch
    pm, mm = prices.tensors(device=dev)
    ret, ret_valid = monthly_returns(pm, mm)
    labels, mom_valid = _momentum_labels(pm, mm, 12, 1, 10, "qcut")
    turn, turn_valid = turnover_features(
        torch.as_tensor(volume.values, device=dev), torch.as_tensor(volume.mask, device=dev),
        np.ones(A), lookback=3)["turn_avg"]
    both = mom_valid & turn_valid
    vol_labels, _ = volume_tercile_labels(torch.where(both, turn, torch.nan), both)
    terciles = torch.arange(3, device=dev)[:, None, None]
    labels_v = torch.where(vol_labels[None] == terciles, labels[None], -1).to(torch.int32)
    absum_r = torch.where(ret_valid, torch.nan_to_num(ret), 0.0).abs()
    k2_shapes = []
    for lab, H in ((labels[None], 36), (labels[None], 60), (labels_v, 36)):
        shape = f"{list(lab.shape)} H={H}"
        s, c = kernels.cohort_partial_sums(ret, ret_valid, lab, 10, H)
        again = kernels.cohort_partial_sums(ret, ret_valid, lab, 10, H)
        p, pc = kernels.cohort_partial_sums_plain(ret, ret_valid, lab, 10, H)
        absum, _ = kernels.cohort_partial_sums_plain(absum_r, ret_valid, lab, 10, H)
        torch.cuda.synchronize()
        if not (torch.equal(s, again[0]) and torch.equal(c, again[1])):
            raise AssertionError(f"K2 {shape}: two launches differ")
        if not torch.equal(c, pc):
            raise AssertionError(f"K2 {shape}: counts differ from the plain version")
        assert_sums(s, p, absum, torch.float32, f"K2 {shape}")
        nbytes, ops = k2_bound_inputs(lab, ret, ret_valid, 10, H)
        b_ms, b_by = bound(nbytes, ops)
        device_ms, per_call = time_kernels(
            lambda: kernels.cohort_partial_sums(ret, ret_valid, lab, 10, H),
            kernels.cohort_partial_sums.device_kernels)
        k2_shapes.append({"shape": shape, "device_ms": device_ms, "kernels_per_call": per_call,
                          "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / device_ms,
                          "bytes": nbytes, "ops": ops,
                          "max_abs_err": (s - p).abs().max().item()})
    log("kernels", f"K2 at the horizons shapes, f32, equal to its plain version (counts "
                   f"exact, sums within 1e-6 + 1e-5 sum|x|), device ms medians of {REPS} "
                   f"with L2 flushed, bound as in the kernels line: "
                   f"{json.dumps(k2_shapes)} | {smi}")

    for max_h in (36, 60):
        argv = ["horizons", *common] + (["--max-h", str(max_h)] if max_h != 36 else [])
        out = run(f"horizons --max-h {max_h}", argv, 0, 1)
        hp = horizon_profile(pm, mm, lookback=12, skip=1, n_bins=10, mode="qcut", max_h=max_h)
        if not bool(torch.isfinite(hp.mean_spread[:max_h - 12]).all()):
            raise AssertionError(f"horizons {max_h}: non-finite mean spreads")
        expect("horizons", out, f"J=12 event-time profile, horizons 1..{max_h}:\n"
                                f"{horizon_table(hp).round(4).to_string()}\n")
    out = run("horizons --by-volume", ["horizons", *common, "--by-volume"], 0, 1)
    vhp = volume_horizon_profile(pm, mm, turn, turn_valid, lookback=12, skip=1,
                                 n_bins=10, mode="qcut", max_h=36)
    expect("horizons --by-volume", out,
           "J=12 momentum life cycle by volume tercile (turnover avg 3m), horizons "
           f"1..36:\n{volume_horizon_table(vhp).round(4).to_string()}\n")

    # 5. doublesort, residual, pack-info, strategies
    out = run("doublesort", ["doublesort", *common], 0, 0)
    ds = volume_double_sort(pm, mm, turn, turn_valid, lookback=12, skip=1)
    expect("doublesort", out, double_sort_table(ds).round(4).to_string())
    out = run("residual", ["residual", *common], 9, 0)
    expect("residual", out, "mean monthly spread:", "Newey-West t-stat:",
           "annualized Sharpe:", "est_window")
    out = run("pack-info", ["pack-info", pack_dir], 0, 0)
    expect("pack-info", out, f"universe: {A} tickers", "field adj_close: dtype float32",
           "field volume: dtype float32")
    out = run("strategies", ["strategies"], 0, 0)
    expect("strategies", out, *(f"\n{n}(" for n in (
        "intermediate_momentum", "low_volatility", "momentum", "residual_momentum",
        "reversal", "volume_z_momentum", "zscore_combo")), "high_52w(")

    # 6. the committed CSV universe in f64: the CSV golden
    universe = os.path.join(REPO, "tests", "fixtures", "universe")
    tickers = ",".join(sorted(n.split("_")[0] for n in os.listdir(universe)))
    out = run("replicate (CSV universe, f64)",
              ["replicate", "--data-dir", universe, "--tickers", tickers, "--lookback",
               "6", "--n-bins", "4", "--device", "cuda", "--out", out_dir], 1, 0)
    expect("replicate (CSV universe)", out,
           f"Mean monthly spread: {CSV_GOLDEN['mean_spread']:.6f}\n"
           f"Annualized Sharpe:   {CSV_GOLDEN['ann_sharpe']:.4f}\n"
           f"t-stat (NW):         {CSV_GOLDEN['nw_t']:.3f}\n")
    log("cli", f"every command exited 0 with its checks; host walls (ms) "
               f"{json.dumps(walls)}; launches over the phase {totals} | {smi}")
    return totals


# (name fragment, HBM bytes/s, f32 FLOP/s outside the tensor cores): the
# vendor data sheets' figures; the first fragment found in the device
# name wins
CARDS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),
)

# The first versions of K1 (one thread per month over asset chunks) and
# K2 (one thread per (j, month, 4 horizons) over asset chunks), each with
# a second pass over the chunk partials, since replaced: their device time
# at the main-path shape, f32, by phases.time_kernels on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md, section 6).  Recorded figures, printed
# beside this run's times on log lines and never in the kernels line,
# whose numbers are all measured by the run that prints them.
K1_FIRST_VERSION_DEVICE_MS = 0.0288
K2_FIRST_VERSION_DEVICE_MS = 0.408012

# f64: the JAX package's own tolerance between its kernel forms
F64_TOL = dict(rtol=1e-10, atol=1e-13)
# f32: 24-bit significands (u = 6e-8).  Two summations of n <= ~600 terms
# in different orders differ by about sqrt(n)*u*sum|x| and at worst by
# n*u*sum|x|, so the relative tolerance is taken against sum|x| (a sum
# can cancel to ~0 while its rounding error cannot): |a-b| <= 1e-6 +
# 1e-5 * sum|x|.
F32_RTOL, F32_ATOL = 1e-5, 1e-6
# f32 spreads: differences of member means of monthly returns (|r| ~ 0.1),
# each mean off by at most ~n*u*mean|r| ~ 2e-6; 1e-5 leaves room for the
# K-cohort average on top
SPREAD_ATOL = 1e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from csmom_tpu_torch import random
    from csmom_tpu_torch.analytics.bootstrap import block_bootstrap_grid
    from csmom_tpu_torch.analytics.stats import nw_t_stat
    from csmom_tpu_torch.backends.dispatch import run_grid, run_monthly
    from csmom_tpu_torch.backtest.grid import (
        _cohort_partial_sums, grid_break_even_bps, grid_net_from_unit,
        grid_net_of_costs, jk_grid_backtest,
    )
    from csmom_tpu_torch.backtest.monthly import (
        monthly_spread_backtest, sector_neutral_backtest,
    )
    from csmom_tpu_torch.backtest.walkforward import walk_forward_select
    from csmom_tpu_torch.ops import build, kernels
    from csmom_tpu_torch.ops.ranking import decile_assign_panel
    from csmom_tpu_torch.phases import REPS, time_call, time_kernels
    from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
    from csmom_tpu_torch.panel.panel import Panel, to_tensors
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
    from csmom_tpu_torch.signals.momentum import (
        formation_listed_mask, momentum_dynamic, monthly_returns,
    )
    from csmom_tpu_torch.workloads import (
        GRID_JS, GRID_KS, GRID_SKIP, NORTH_STAR_GRID, north_star_month_panel,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    bw, f32_peak = next(((b, f) for frag, b, f in CARDS if frag in kind),
                        (None, None))
    if bw is None:
        raise RuntimeError(f"no memory/compute peak known for {kind!r}")
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}"
                  f" | peaks {bw / 1e12:.2f} TB/s, f32 {f32_peak / 1e12:.0f} TFLOP/s")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    log("build", f"{len(logs)} kernel(s) compiled in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log("build", f"{name}: {line.strip()}")

    # -- helpers ---------------------------------------------------------------
    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def assert_sums(got, want, absum, dtype, what):
        if dtype == torch.float64:
            torch.testing.assert_close(got, want, **F64_TOL, msg=what)
        else:
            err = (got - want).abs()
            lim = F32_ATOL + F32_RTOL * absum
            if not bool((err <= lim).all()):
                raise AssertionError(f"{what}: max err {err.max().item()} over "
                                     f"its f32 limit")

    def bound(nbytes, ops):
        """The least time for the work: bytes over the memory rate or
        operations over the f32 peak, whichever is longer."""
        b_ms, o_ms = nbytes / bw * 1e3, ops / f32_peak * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    def k1_case(a, m, n_bins, dtype, all_invalid=False, wild=False):
        # wild: labels from -3 to B+2, so some are >= B or < -1 (no bin)
        lo, hi = (-3, n_bins + 3) if wild else (-1, n_bins)
        labels = rng.integers(lo, hi, size=(a, m)).astype(np.int32)
        valid = (rng.random((a, m)) > 0.2) & (not all_invalid)
        labels = np.where(valid, labels, -1).astype(np.int32)
        member = (labels >= 0) & (labels < n_bins)
        ret = np.where(member, rng.normal(0.0, 0.1, size=(a, m)), 0.0)
        return t(ret, dtype), t(labels)

    def check_k1(ret, labels, n_bins, what):
        s, c = kernels.decile_partial_sums(ret, labels, n_bins)
        again = kernels.decile_partial_sums(ret, labels, n_bins)
        ps, pc = kernels.decile_partial_sums_plain(ret, labels, n_bins)
        absum, _ = kernels.decile_partial_sums_plain(ret.abs(), labels, n_bins)
        torch.cuda.synchronize()
        if not (torch.equal(s, again[0]) and torch.equal(c, again[1])):
            raise AssertionError(f"{what}: two launches differ")
        if not torch.equal(c, pc):
            raise AssertionError(f"{what}: counts differ")
        assert_sums(s, ps, absum, ret.dtype, what)
        return (s - ps).abs().max().item() if s.numel() else 0.0

    def k2_case(nj, a, m, n_bins, dtype, extremes=False):
        labels = rng.integers(-1, n_bins, size=(nj, a, m)).astype(np.int32)
        if extremes:  # every lane a member of side 0 or side 1
            labels = np.where(labels % 2 == 0, 0, n_bins - 1).astype(np.int32)
        valid = rng.random((a, m)) > 0.25
        ret = np.where(valid, rng.normal(0.0, 0.1, size=(a, m)), np.nan)
        return t(ret, dtype), t(valid), t(labels)

    def check_k2(ret, valid, labels, n_bins, H, what):
        s, c = kernels.cohort_partial_sums(ret, valid, labels, n_bins, H)
        again = kernels.cohort_partial_sums(ret, valid, labels, n_bins, H)
        ps, pc = kernels.cohort_partial_sums_plain(ret, valid, labels, n_bins, H)
        absum, _ = kernels.cohort_partial_sums_plain(
            torch.where(valid, ret, 0.0).abs(), valid, labels, n_bins, H)
        torch.cuda.synchronize()
        if not (torch.equal(s, again[0]) and torch.equal(c, again[1])):
            raise AssertionError(f"{what}: two launches differ")
        if not torch.equal(c, pc):
            raise AssertionError(f"{what}: counts differ")
        assert_sums(s, ps, absum, ret.dtype, what)
        return (s - ps).abs().max().item() if s.numel() else 0.0

    # -- 3. kernels against their plain versions --------------------------------
    n_checks = 0
    for dtype in (torch.float64, torch.float32):
        # K1's tiling: clusters of 8 asset slices (A < 8 leaves ranks
        # empty), month tiles of lanes x V, 16-byte loads only where M % V
        # == 0 (M odd or = 2 mod 4 takes scalar loads), up to 16 bins a
        # block, more in bin groups (B = 20, 33)
        for a, m, nb in [(16, 24, 10), (256, 128, 10), (300, 130, 10),
                         (37, 7, 10), (50, 40, 3), (511, 257, 10),
                         (300, 130, 20), (64, 30, 1), (3000, 696, 10),
                         (40, 33, 10), (50, 30, 10), (20, 5, 10), (30, 1, 10),
                         (5, 40, 10), (1, 64, 10), (1, 1, 1), (100, 60, 5),
                         (120, 48, 3), (90, 36, 33), (3001, 697, 10)]:
            check_k1(*k1_case(a, m, nb, dtype), nb, f"K1 {a}x{m} B={nb} {dtype}")
            n_checks += 1
        check_k1(*k1_case(20, 16, 5, dtype, all_invalid=True), 5,
                 f"K1 all-invalid {dtype}")
        for a, m, nb in [(300, 130, 10), (64, 40, 5), (33, 24, 3), (50, 44, 20)]:
            check_k1(*k1_case(a, m, nb, dtype, wild=True), nb,
                     f"K1 labels >= B and < -1 {a}x{m} B={nb} {dtype}")
        # storage one element off 16-byte alignment: scalar loads at M = 696
        ret, labels = k1_case(64, 696, 10, dtype)
        ret_off = torch.empty(ret.numel() + 1, dtype=dtype, device=dev)[1:].view(64, 696)
        lab_off = torch.empty(labels.numel() + 1, dtype=torch.int32, device=dev)[1:].view(64, 696)
        ret_off.copy_(ret)
        lab_off.copy_(labels)
        check_k1(ret_off, lab_off, 10, f"K1 misaligned storage {dtype}")
        # K2's tiling: 32-month tiles, clusters of 8 asset slices (A < 8
        # leaves ranks empty), J groups, chunks of 16 horizons (H=128 is
        # the shared-memory worst case), ragged months and assets
        for nj, a, m, h, nb in [(1, 37, 50, 6, 5), (1, 130, 300, 12, 5),
                                (1, 64, 20, 12, 5), (1, 24, 5, 8, 5),
                                (3, 40, 200, 128, 10), (2, 33, 60, 7, 1),
                                (4, 3000, 696, 12, 10), (1, 1, 1, 1, 10),
                                (1, 5, 33, 12, 10), (5, 7, 31, 12, 10),
                                (4, 3001, 697, 12, 10), (2, 40, 200, 128, 10),
                                (3, 50, 45, 17, 10)]:
            check_k2(*k2_case(nj, a, m, nb, dtype), nb, h,
                     f"K2 {nj}x{a}x{m} H={h} B={nb} {dtype}")
            n_checks += 1
        check_k2(*k2_case(2, 300, 130, 10, dtype, extremes=True), 10, 12,
                 f"K2 every label 0 or B-1 {dtype}")
        # valid +-inf returns go through nan_to_num (largest finite value)
        ret, valid, labels = k2_case(1, 16, 12, 4, dtype)
        ret[0, 5], ret[1, 7] = float("inf"), float("-inf")
        valid[0, 5] = valid[1, 7] = True
        s, _ = kernels.cohort_partial_sums(ret, valid, labels, 4, 4)
        ps, _ = kernels.cohort_partial_sums_plain(ret, valid, labels, 4, 4)
        torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-6, equal_nan=True)
    try:
        kernels.cohort_partial_sums(*k2_case(1, 8, 16, 10, torch.float32), 10, 129)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 accepted max_hold > 128")
    a_over = kernels.MAX_ASSETS + 1  # more than 16-bit counts of 8 slices hold
    try:
        kernels.cohort_partial_sums(*k2_case(1, a_over, 1, 10, torch.float32), 10, 12)
    except ValueError:
        pass
    else:
        raise AssertionError(f"K2 accepted A = {a_over} assets")
    torch.cuda.synchronize()
    log("kernels", f"K1 and K2 equal their plain versions, and repeat bit for "
                   f"bit, in {n_checks} f64/f32 shape cases (+ all-invalid, "
                   "labels outside [-1, B), misaligned storage, inf, H > 128 "
                   "and A > MAX_ASSETS refusals)")

    # -- 4. golden monthly, f64 --------------------------------------------
    daily = synthetic_daily_panel(40, 1260, seed=123, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device=dev)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    if len(ends) != MONTHLY["n_months"]:
        raise AssertionError(f"golden: {len(ends)} months")
    kernels.reset_launches()
    res = monthly_spread_backtest(pm, mm, lookback=12, skip=1)
    k1_golden = kernels.decile_partial_sums.launches
    if k1_golden < 1:
        raise AssertionError("golden: K1 was not launched")
    sv = res.spread_valid.cpu().numpy()
    got = {
        "n_valid_spreads": int(sv.sum()),
        "mean_spread": float(res.mean_spread),
        "ann_sharpe": float(res.ann_sharpe),
        "nw_t": float(nw_t_stat(res.spread, res.spread_valid)),
        "cum_return": float(np.prod(1 + res.spread.cpu().numpy()[sv])),
    }
    if got["n_valid_spreads"] != MONTHLY["n_valid_spreads"]:
        raise AssertionError(f"golden: {got['n_valid_spreads']} valid spreads")
    for k in ("mean_spread", "ann_sharpe", "nw_t", "cum_return"):
        np.testing.assert_allclose(got[k], MONTHLY[k], rtol=1e-9, err_msg=k)
    # the host entry points on the same month-end panel
    golden_panel = Panel(values=pm.cpu().numpy(), mask=mm.cpu().numpy(),
                        tickers=daily.tickers, times=ends)
    rep = run_monthly(golden_panel, device="cuda")
    np.testing.assert_allclose(rep.mean_spread, MONTHLY["mean_spread"], rtol=1e-9)
    grep = run_grid(golden_panel, device="cuda", mode="rank")
    gplain = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, mode="rank", impl="plain")
    if not np.array_equal(grep.spread_valid, gplain.spread_valid.cpu().numpy()):
        raise AssertionError("golden: run_grid validity differs from plain")
    np.testing.assert_allclose(grep.spreads, gplain.spreads.cpu().numpy(),
                               **F64_TOL, equal_nan=True)
    log("golden", f"f64 MONTHLY fingerprints reproduced ({got}); K1 launches "
                  f"{k1_golden}; run_monthly/run_grid on cuda agree")

    # -- 5. north star, f32 -------------------------------------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    pm, mm, ends = north_star_month_panel(device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    panel_s = time.perf_counter() - t0
    mres = monthly_spread_backtest(pm, mm, lookback=12, skip=1, mode="qcut")
    grids = {mode: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP,
                                    mode=mode)
             for mode in ("rank", "qcut")}
    torch.cuda.synchronize()
    launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"north star: a kernel was not launched: {launches}")
    A, M = pm.shape
    n_stocks, n_days = NORTH_STAR_GRID
    log("north", f"panel {A}x{M} month ends from {n_stocks}x{n_days} daily bars in "
                 f"{panel_s:.2f} s (host generation + device aggregation); "
                 f"main-path launches {launches}")

    # the kernel path against the plain path
    mplain = monthly_spread_backtest(pm, mm, lookback=12, skip=1, mode="qcut",
                                     impl="plain")
    if not torch.equal(mres.spread_valid, mplain.spread_valid) or \
            not torch.equal(mres.decile_counts, mplain.decile_counts):
        raise AssertionError("north star monthly: validity/counts differ")
    torch.testing.assert_close(mres.spread, mplain.spread, rtol=0,
                               atol=SPREAD_ATOL, equal_nan=True)
    summary = {"monthly_valid": int(mres.spread_valid.sum()),
               "monthly_mean_spread": float(mres.mean_spread)}
    for mode, g in grids.items():
        gp = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP,
                              mode=mode, impl="plain")
        if tuple(g.spreads.shape) != (4, 4, M):
            raise AssertionError(f"grid {mode}: shape {tuple(g.spreads.shape)}")
        if not torch.equal(g.spread_valid, gp.spread_valid):
            raise AssertionError(f"grid {mode}: validity differs from plain")
        live = g.spread_valid
        if not bool(torch.isfinite(g.spreads[live]).all()) or int(live.sum()) == 0:
            raise AssertionError(f"grid {mode}: non-finite or empty spreads")
        torch.testing.assert_close(g.spreads, gp.spreads, rtol=0,
                                   atol=SPREAD_ATOL, equal_nan=True)
        summary[f"grid_{mode}_live"] = int(live.sum())
        summary[f"grid_{mode}_mean_J12K3"] = float(g.mean_spread[3, 0])
    log("north", f"kernel path equals plain path (validity exact, spreads "
                 f"within {SPREAD_ATOL}): {summary}")

    # timing: CUDA events and host wall around each rep, median of REPS
    # after warm-up (the helper that csmom_tpu_torch.phases times with)
    e2e = {}
    for label, fn in [
        ("monthly_qcut_J12", lambda: monthly_spread_backtest(pm, mm, 12, 1, mode="qcut")),
        ("grid16_rank", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, mode="rank")),
        ("grid16_qcut", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, mode="qcut")),
        ("grid16_rank_plain", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS,
                                                       mode="rank", impl="plain")),
    ]:
        d_ms, h_ms = time_call(fn)
        e2e[label] = {"device_ms": d_ms, "host_ms": h_ms}
    log("north", "end-to-end f32 medians of %d reps: %s" % (REPS, json.dumps(e2e)))

    # -- 6. research paths (BASELINE configs 3 and 5) -------------------------
    # (a) the JAX package's pinned outputs on the golden panel, f64
    kernels.reset_launches()
    check_research(research_fingerprints(dev))
    torch.cuda.synchronize()
    golden_launches = {"decile_partial_sums": kernels.decile_partial_sums.launches,
                       "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(golden_launches.values()) < 1:
        raise AssertionError(f"research golden: a kernel was not launched: "
                             f"{golden_launches}")
    log("research", f"golden RESEARCH fingerprints reproduced in f64 (sector-"
                    f"neutral spread and NW t, net of 10 bps, grid netting and "
                    f"break-evens, walk-forward choices, bootstrap CIs, threefry "
                    f"draws); launches {golden_launches}")

    # (b) north star, f32, through the entry points and the research layer;
    # launch counts read around this run
    n_sec = 11
    sid = np.random.default_rng(11).integers(-1, n_sec, size=A)   # -1: unclassified
    ns_panel = Panel(values=pm.cpu().numpy(), mask=mm.cpu().numpy(),
                     tickers=tuple(f"S{i}" for i in range(A)), times=ends)
    sid_t = t(sid)
    key0 = random.PRNGKey(0, device=dev)
    kernels.reset_launches()
    sec_rep = run_monthly(ns_panel, sector_ids=sid, n_sectors=n_sec, device="cuda")
    hist_rep = run_grid(ns_panel, mode="hist", device="cuda")
    g_hist = jk_grid_backtest(pm, mm, GRID_JS, GRID_KS, skip=GRID_SKIP, mode="hist")
    unit = grid_net_of_costs(pm, mm, g_hist, half_spread=1.0)
    be, turn = grid_break_even_bps(pm, mm, g_hist, unit=unit)
    net = grid_net_of_costs(pm, mm, g_hist, half_spread=0.0005)
    wf = walk_forward_select(g_hist.spreads, g_hist.spread_valid)
    boot = block_bootstrap_grid(g_hist.spreads, g_hist.spread_valid, key0,
                                n_samples=200, block_len=6)
    torch.cuda.synchronize()
    research_launches = {
        "decile_partial_sums": kernels.decile_partial_sums.launches,
        "cohort_partial_sums": kernels.cohort_partial_sums.launches}
    if min(research_launches.values()) < 1:
        raise AssertionError(f"research paths: a kernel was not launched: "
                             f"{research_launches}")

    # hist labels are rank labels, and the hist grid is the rank grid
    jt = t(GRID_JS)
    mom_r, momv_r = momentum_dynamic(pm, mm, jt, GRID_SKIP)
    momv_r = momv_r & formation_listed_mask(mm, GRID_SKIP)
    mom_r = torch.where(momv_r, mom_r, torch.nan)
    lab_hist, n_hist = decile_assign_panel(mom_r, momv_r, n_bins=10, mode="hist")
    lab_rank, n_rank = decile_assign_panel(mom_r, momv_r, n_bins=10, mode="rank")
    if not (torch.equal(lab_hist, lab_rank) and torch.equal(n_hist, n_rank)):
        raise AssertionError("research: hist labels differ from rank labels")
    rank_rep = run_grid(ns_panel, mode="rank", device="cuda")
    np.testing.assert_array_equal(hist_rep.spread_valid, rank_rep.spread_valid)
    np.testing.assert_array_equal(hist_rep.spreads, rank_rep.spreads)
    if not (torch.equal(g_hist.spreads.nan_to_num(), grids["rank"].spreads.nan_to_num())
            and torch.equal(g_hist.spread_valid, grids["rank"].spread_valid)):
        raise AssertionError("research: the hist grid differs from the rank grid")

    # the cross-table cohort sums against K2 on the grid's own labels
    ret, ret_valid = monthly_returns(pm, mm)
    H = max(GRID_KS)
    ks_, kc_ = _cohort_partial_sums(lab_rank, ret, ret_valid, 10, H, impl="kernel")
    absum_c, _ = _cohort_partial_sums(lab_rank, torch.where(
        ret_valid, torch.nan_to_num(ret), 0.0).abs(), ret_valid, 10, H, impl="plain")
    mm_err = {}
    for impl in ("matmul", "matmul_bf16"):
        ms_, mc_ = _cohort_partial_sums(lab_rank, ret, ret_valid, 10, H, impl=impl)
        if mc_.dtype != torch.float32 or ms_.dtype != torch.float32:
            raise AssertionError(f"research {impl}: not float32 outputs")
        if not torch.equal(mc_, kc_):
            raise AssertionError(f"research {impl}: counts differ from K2's")
        if impl == "matmul":
            assert_sums(ms_, ks_, absum_c, torch.float32, "research matmul sums")
        else:
            # bf16 keeps 8 significant bits: each return moves by at most
            # 2**-8 of itself before the float32 sums
            lim = F32_ATOL + (2.0 ** -8 + F32_RTOL) * absum_c
            if not bool(((ms_ - ks_).abs() <= lim).all()):
                raise AssertionError("research matmul_bf16 sums over their bf16 limit")
        mm_err[impl] = (ms_ - ks_).abs().max().item()

    # the sector-neutral engine (K1) against its plain run
    sec = sector_neutral_backtest(pm, mm, sid_t, n_sec, lookback=12, skip=1)
    sec_plain = sector_neutral_backtest(pm, mm, sid_t, n_sec, lookback=12, skip=1,
                                        impl="plain")
    if not (torch.equal(sec.decile_counts, sec_plain.decile_counts)
            and torch.equal(sec.spread_valid, sec_plain.spread_valid)
            and torch.equal(sec.labels, sec_plain.labels)):
        raise AssertionError("research: sector-neutral counts/validity differ from plain")
    torch.testing.assert_close(sec.spread, sec_plain.spread, rtol=0,
                               atol=SPREAD_ATOL, equal_nan=True)
    np.testing.assert_array_equal(sec_rep.labels, sec.labels.cpu().numpy())
    if not bool((sec.labels[sid_t < 0] == -1).all()):
        raise AssertionError("research: an unclassified asset was ranked")

    # one unit-cost run re-prices the grid at any level; f32: the unit cost
    # (about 1 a month) carries ~1e-7 of rounding, scaled by hs <= 1
    torch.testing.assert_close(grid_net_from_unit(g_hist, unit, 0.0005).spreads,
                               net.spreads, rtol=0, atol=1e-6, equal_nan=True)
    live = g_hist.spread_valid
    if not bool(torch.isfinite(net.spreads[live]).all()) or \
            not bool((net.spreads[live] <= g_hist.spreads[live]).all()):
        raise AssertionError("research: net spreads not finite or above gross")
    if not bool((turn > 0).all()) or not bool(torch.isfinite(be).all()):
        raise AssertionError("research: turnover or break-even not positive/finite")
    if int((wf.choice >= 0).sum()) == 0 or int(wf.choice.max()) > 15:
        raise AssertionError("research: walk-forward chose nothing or out of range")
    ci = boot.mean_ci
    if tuple(ci.shape) != (2, 4, 4) or not bool(torch.isfinite(ci).all()) \
            or not bool((ci[0] <= ci[1]).all()):
        raise AssertionError("research: bootstrap CIs not finite and ordered")
    log("research", f"north star f32: hist == rank labels and grids; matmul / "
                    f"matmul_bf16 counts equal K2's (max |sum err| {mm_err}); "
                    f"sector-neutral ({n_sec} sectors) equals plain; net from "
                    f"unit equals direct netting; launches {research_launches}")
    log("research", json.dumps({
        "sector_mean_spread": float(sec.mean_spread),
        "sector_valid": int(sec.spread_valid.sum()),
        "grid_net_mean_J12K3_5bps": float(net.mean_spread[3, 0]),
        "break_even_bps": be.flatten().tolist(),
        "mean_turnover": turn.flatten().tolist(),
        "wf_oos_mean": float(wf.mean_spread),
        "wf_cells_chosen": sorted(set(wf.choice[wf.choice >= 0].tolist())),
        "ci_J12K3": ci[:, 3, 0].tolist()}))

    # each new path's CUDA-event median at the north star, f32
    for label, fn in [
        ("grid_net_of_costs", lambda: grid_net_of_costs(pm, mm, grids["rank"], 0.0005)),
        ("grid_net_of_costs_hist", lambda: grid_net_of_costs(pm, mm, g_hist, 0.0005)),
        ("grid_break_even_bps", lambda: grid_break_even_bps(pm, mm, grids["rank"])),
        ("block_bootstrap_grid_200", lambda: block_bootstrap_grid(
            g_hist.spreads, g_hist.spread_valid, key0, n_samples=200)),
        ("walk_forward_select", lambda: walk_forward_select(
            g_hist.spreads, g_hist.spread_valid)),
        ("sector_neutral_monthly_qcut_J12", lambda: sector_neutral_backtest(
            pm, mm, sid_t, n_sec, lookback=12, skip=1)),
        ("ranking_grid_hist", lambda: decile_assign_panel(mom_r, momv_r, 10, "hist")),
        ("ranking_grid_rank", lambda: decile_assign_panel(mom_r, momv_r, 10, "rank")),
        ("grid16_rank_kernel", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS,
                                                        mode="rank")),
        ("grid16_rank_matmul", lambda: jk_grid_backtest(pm, mm, GRID_JS, GRID_KS,
                                                        mode="rank", impl="matmul")),
        ("grid16_rank_matmul_bf16", lambda: jk_grid_backtest(
            pm, mm, GRID_JS, GRID_KS, mode="rank", impl="matmul_bf16")),
    ]:
        d_ms, h_ms = time_call(fn)
        log("research", f"time {label}: {d_ms:.4f} ms CUDA events, host "
                        f"{h_ms:.4f} ms (median of {REPS}) | {smi}")

    with tempfile.TemporaryDirectory(prefix="csmom_smoke_") as tmp:
        # -- 7. data-in: CSV caches and packs -> month-end panels on the card
        pack_dir = os.path.join(tmp, "north_star")
        data_in_launches = data_in(dev, smi, pm, mm, ends, mres, grids, pack_dir)

        # -- 8. cli: the port's CLI on phase 7(b)'s pack -------------------
        cli_launches = cli_phase(dev, smi, pack_dir, os.path.join(tmp, "results"),
                                 mres, grids, assert_sums, bound)

    # -- 9. kernels line at the main-path shapes ---------------------------
    ret, ret_valid = monthly_returns(pm, mm)
    # K1's inputs as the monthly engine forms them (backtest/monthly.py)
    next_ret = torch.roll(ret, -1, dims=1)
    next_valid = torch.roll(ret_valid, -1, dims=1)
    next_valid[:, -1] = False
    next_valid &= mres.labels >= 0
    lab1 = torch.where(next_valid, mres.labels, -1)
    r1 = torch.where(lab1 >= 0, torch.nan_to_num(next_ret), 0.0)
    # K2's inputs as the grid engine forms them (backtest/grid.py), rank mode
    mom, mom_valid = momentum_dynamic(pm, mm, t(GRID_JS), GRID_SKIP)
    mom_valid = mom_valid & formation_listed_mask(mm, GRID_SKIP)
    lab2, _ = decile_assign_panel(torch.where(mom_valid, mom, torch.nan),
                                  mom_valid, n_bins=10, mode="rank")
    H, B = max(GRID_KS), 10

    s1, c1 = kernels.decile_partial_sums(r1, lab1, B)
    p1, pc1 = kernels.decile_partial_sums_plain(r1, lab1, B)
    s2, c2 = kernels.cohort_partial_sums(ret, ret_valid, lab2, B, H)
    p2, pc2 = kernels.cohort_partial_sums_plain(ret, ret_valid, lab2, B, H)
    if not (torch.equal(c1, pc1) and torch.equal(c2, pc2)):
        raise AssertionError("main-path shape: counts differ")
    absum1, _ = kernels.decile_partial_sums_plain(r1.abs(), lab1, B)
    absum2, _ = kernels.cohort_partial_sums_plain(
        torch.where(ret_valid, torch.nan_to_num(ret), 0.0).abs(), ret_valid, lab2, B, H)
    assert_sums(s1, p1, absum1, r1.dtype, "main-path shape: K1 sums")
    assert_sums(s2, p2, absum2, ret.dtype, "main-path shape: K2 sums")

    # yardsticks: one library computation of the same function each
    onehot = (lab1.T[:, None, :] == torch.arange(B, device=dev)[None, :, None]
              ).to(torch.float32)                                # [M, B, A]
    rhs = torch.stack([r1.T, torch.ones_like(r1.T)], dim=-1)    # [M, A, 2]

    def k1_library():
        return torch.bmm(onehot, rhs)                            # [M, B, 2]

    lib1 = k1_library()
    torch.testing.assert_close(lib1[..., 0].T, p1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lib1[..., 1].T, pc1)

    rf = torch.where(ret_valid, torch.nan_to_num(ret), 0.0)
    vf = ret_valid.to(torch.float32)
    mem = torch.stack([lab2 == 0, lab2 == B - 1], dim=1).to(torch.float32)
    mem_t = mem.transpose(-1, -2).contiguous()                   # [nJ, 2, M, A]
    col = torch.arange(M, device=dev)[:, None] + torch.arange(1, H + 1, device=dev)[None, :]
    keep = col < M
    colc = col.clamp(0, M - 1).expand(*mem_t.shape[:2], M, H)

    def k2_library():  # the reference's impl='matmul': cross table + band gather
        fs = torch.matmul(mem_t, rf)                             # [nJ, 2, M, M]
        fc = torch.matmul(mem_t, vf)
        return (torch.where(keep, torch.gather(fs, 3, colc), 0.0),
                torch.where(keep, torch.gather(fc, 3, colc), 0.0))

    lib2 = k2_library()
    torch.testing.assert_close(lib2[0], p2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lib2[1], pc2)

    k1_bytes = lab1.nbytes + r1.nbytes + s1.nbytes + c1.nbytes
    k1_ops = 2 * int(((lab1 >= 0) & (lab1 < B)).sum())
    k2_bytes, k2_ops = k2_bound_inputs(lab2, ret, ret_valid, B, H)

    rows = []
    for name, wrapper, fn, plain, library, err, nbytes, ops, src, rep in [
        ("decile_partial_sums", kernels.decile_partial_sums,
         lambda: kernels.decile_partial_sums(r1, lab1, B),
         lambda: kernels.decile_partial_sums_plain(r1, lab1, B), k1_library,
         (s1 - p1).abs().max().item(), k1_bytes, k1_ops,
         "csmom_tpu_torch/csrc/decile_partial_sums.cu",
         "csmom_tpu/ops/pallas_kernels.py:153"),
        ("cohort_partial_sums", kernels.cohort_partial_sums,
         lambda: kernels.cohort_partial_sums(ret, ret_valid, lab2, B, H),
         lambda: kernels.cohort_partial_sums_plain(ret, ret_valid, lab2, B, H),
         k2_library, (s2 - p2).abs().max().item(), k2_bytes, k2_ops,
         "csmom_tpu_torch/csrc/cohort_partial_sums.cu",
         "csmom_tpu/ops/pallas_kernels.py:66"),
    ]:
        b_ms, b_by = bound(nbytes, ops)
        # ms: the call (host work of the wrapper included); device_ms: the
        # kernels' own durations in a profiler trace of the same calls
        ms = time_call(fn, cold=True)[0]
        device_ms, per_call, by_kernel = time_kernels(fn, wrapper.device_kernels,
                                                      split=True)
        log("kernels", f"{name} device ms by kernel (medians): {by_kernel}")
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "device_ms": device_ms, "kernels_per_call": per_call,
            "wrapper_ms": ms - device_ms,
            "plain_ms": time_call(plain, cold=True)[0],
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / device_ms,
            "library_ms": time_call(library, cold=True)[0],
            "bytes": nbytes, "ops": ops,
            "research_launches": research_launches[name],
            "data_in_launches": data_in_launches[name],
            "cli_launches": cli_launches[name],
        })
    if min(r["cli_launches"] for r in rows) < 1:
        raise AssertionError(f"cli: a kernel was not launched: {cli_launches}")
    per_call = {r["name"]: r["kernels_per_call"] for r in rows}
    for name, per in per_call.items():
        if per != 1:
            raise AssertionError(f"{name} launched {per} kernels per call, not 1")
    log("kernels", f"main-path shapes: K1 labels/ret {tuple(lab1.shape)} f32, "
                   f"K2 labels {tuple(lab2.shape)} H={H} f32; times are medians "
                   f"of {REPS} reps with L2 flushed before each; kernels per "
                   f"call {per_call}")
    for row, first in ((rows[0], K1_FIRST_VERSION_DEVICE_MS),
                       (rows[1], K2_FIRST_VERSION_DEVICE_MS)):
        log("kernels", f"{row['name']} device time {row['device_ms']:.6f} ms in "
                       f"this run; its first version's, recorded (not measured "
                       f"here): {first} ms on an NVIDIA H100 80GB HBM3 at 700 W "
                       f"(PERF.md, section 6)")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
