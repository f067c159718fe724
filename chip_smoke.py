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
6. a ``{"kernels": [...]}`` line: per kernel its launches, error, times
   and bound at the main-path shape;
then the card's name line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

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

# (name fragment, HBM bytes/s, f32 FLOP/s outside the tensor cores): the
# vendor data sheets' figures; the first fragment found in the device
# name wins
CARDS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),
)

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

    from csmom_tpu_torch.analytics.stats import nw_t_stat
    from csmom_tpu_torch.backends.dispatch import run_grid, run_monthly
    from csmom_tpu_torch.backtest.grid import jk_grid_backtest
    from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
    from csmom_tpu_torch.ops import build, kernels
    from csmom_tpu_torch.ops.ranking import decile_assign_panel
    from csmom_tpu_torch.phases import REPS, time_call
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
            if "registers" in line or "spill" in line:
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

    def k1_case(a, m, n_bins, dtype, all_invalid=False):
        labels = rng.integers(-1, n_bins, size=(a, m)).astype(np.int32)
        valid = (rng.random((a, m)) > 0.2) & (not all_invalid)
        labels = np.where(valid, labels, -1).astype(np.int32)
        ret = np.where(labels >= 0, rng.normal(0.0, 0.1, size=(a, m)), 0.0)
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

    def k2_case(nj, a, m, n_bins, dtype):
        labels = rng.integers(-1, n_bins, size=(nj, a, m)).astype(np.int32)
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
        for a, m, nb in [(16, 24, 10), (256, 128, 10), (300, 130, 10),
                         (37, 7, 10), (50, 40, 3), (511, 257, 10),
                         (300, 130, 20), (64, 30, 1), (3000, 696, 10)]:
            check_k1(*k1_case(a, m, nb, dtype), nb, f"K1 {a}x{m} B={nb} {dtype}")
            n_checks += 1
        check_k1(*k1_case(20, 16, 5, dtype, all_invalid=True), 5,
                 f"K1 all-invalid {dtype}")
        for nj, a, m, h, nb in [(1, 37, 50, 6, 5), (1, 130, 300, 12, 5),
                                (1, 64, 20, 12, 5), (1, 24, 5, 8, 5),
                                (3, 40, 200, 128, 10), (2, 33, 60, 7, 1),
                                (4, 3000, 696, 12, 10)]:
            check_k2(*k2_case(nj, a, m, nb, dtype), nb, h,
                     f"K2 {nj}x{a}x{m} H={h} B={nb} {dtype}")
            n_checks += 1
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
    torch.cuda.synchronize()
    log("kernels", f"K1 and K2 equal their plain versions, and repeat bit for "
                   f"bit, in {n_checks} f64/f32 shape cases (+ all-invalid, "
                   "inf, H>128 refusal)")

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

    # -- 6. kernels line at the main-path shapes ---------------------------
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

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / bw * 1e3, ops / f32_peak * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    k1_bytes = lab1.nbytes + r1.nbytes + s1.nbytes + c1.nbytes
    k1_ops = 2 * int(((lab1 >= 0) & (lab1 < B)).sum())
    members = ((lab2 == 0).to(torch.int64) + (lab2 == B - 1).to(torch.int64)
               ).sum(dim=(0, 1))                                 # [M]
    horizons = (M - 1 - torch.arange(M, device=dev)).clamp(0, H)
    k2_bytes = lab2.nbytes + ret.nbytes + ret_valid.nbytes + s2.nbytes + c2.nbytes
    k2_ops = 2 * int((members * horizons).sum())

    rows = []
    for name, fn, plain, library, err, nbytes, ops, src, rep in [
        ("decile_partial_sums", lambda: kernels.decile_partial_sums(r1, lab1, B),
         lambda: kernels.decile_partial_sums_plain(r1, lab1, B), k1_library,
         (s1 - p1).abs().max().item(), k1_bytes, k1_ops,
         "csmom_tpu_torch/csrc/decile_partial_sums.cu",
         "csmom_tpu/ops/pallas_kernels.py:153"),
        ("cohort_partial_sums",
         lambda: kernels.cohort_partial_sums(ret, ret_valid, lab2, B, H),
         lambda: kernels.cohort_partial_sums_plain(ret, ret_valid, lab2, B, H),
         k2_library, (s2 - p2).abs().max().item(), k2_bytes, k2_ops,
         "csmom_tpu_torch/csrc/cohort_partial_sums.cu",
         "csmom_tpu/ops/pallas_kernels.py:66"),
    ]:
        b_ms, b_by = bound(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": err,
            "ms": time_call(fn, cold=True)[0],
            "plain_ms": time_call(plain, cold=True)[0],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_call(library, cold=True)[0],
            "bytes": nbytes, "ops": ops,
        })
    log("kernels", f"main-path shapes: K1 labels/ret {tuple(lab1.shape)} f32, "
                   f"K2 labels {tuple(lab2.shape)} H={H} f32; times are medians "
                   f"of {REPS} reps with L2 flushed before each")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
