"""Paper-style result tables (host-side pandas display objects).

Counterpart of :mod:`csmom_tpu.analytics.tables`: the decile table, the
J x K grid tables (Lee & Swaminathan 2000, Table I shape), the volume
double sort (Table II) and the event-time horizon tables (Tables VI–VIII):
the engines' outputs rendered as small DataFrames.  Each row's statistics come
from :mod:`csmom_tpu_torch.analytics.stats`, the functions the engines
report with, so a table can never disagree with its engine.  Inputs are
host arrays or tensors; a tensor's statistics run on its device, and the
grid CIs bootstrap there.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from csmom_tpu_torch import random
from csmom_tpu_torch.analytics.bootstrap import block_bootstrap_grid
from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat

__all__ = ["decile_table", "jk_grid_table", "jk_grid_ci_table", "tercile_labels",
           "horizon_table", "volume_horizon_table", "double_sort_table"]


def _masked_rows(x, valid):
    """``(x f64, valid & finite)`` as float64 tensors (a tensor keeps its
    device, an array goes to the CPU)."""
    x = torch.as_tensor(x).to(torch.float64)
    v = torch.as_tensor(valid, device=x.device).to(torch.bool) & torch.isfinite(x)
    return x, v


def _row_stats(series, valid, freq: int, nw_lags=None):
    """mean / annualized Sharpe / Newey–West and iid t / live months of one
    series (``nw_lags=None``: the automatic bandwidth; a K cell passes K)."""
    return {
        "mean_ret": float(masked_mean(series, valid)),
        "ann_sharpe": float(sharpe(series, valid, freq_per_year=freq)),
        "t_stat_nw": float(nw_t_stat(series, valid, lags=nw_lags)),
        "t_stat": float(t_stat(series, valid)),
        "months": int(valid.sum()),
    }


def decile_table(decile_means, decile_counts, spread, freq: int = 12) -> pd.DataFrame:
    """Per-decile performance table, R1 (losers) .. R{B} (winners) plus the
    ``R{B}-R1`` spread row: mean monthly return, annualized Sharpe, t-stats,
    live months and average membership.

    Args:
      decile_means: f[B, M] (``MonthlyReport.decile_means``).
      decile_counts: i[B, M] members per (decile, month).
      spread: f[M] top-minus-bottom series (NaN = invalid month).
    """
    means = torch.as_tensor(decile_means).to(torch.float64)
    counts = torch.as_tensor(decile_counts).cpu().numpy()
    B = means.shape[0]
    rows = {}
    for b in range(B):
        x, v = _masked_rows(means[b], torch.as_tensor(counts[b] > 0))
        r = _row_stats(x, v, freq)
        r["avg_members"] = counts[b][counts[b] > 0].mean() if (counts[b] > 0).any() else 0.0
        rows[f"R{b + 1}"] = r
    spread = torch.as_tensor(spread).to(torch.float64)
    x, v = _masked_rows(spread, torch.isfinite(spread))
    r = _row_stats(x, v, freq)
    r["avg_members"] = np.nan
    rows[f"R{B}-R1"] = r
    return pd.DataFrame(rows).T


def _jk_index(Js, Ks):
    Js = [int(j) for j in torch.as_tensor(Js).tolist()]
    Ks = [int(k) for k in torch.as_tensor(Ks).tolist()]
    return Js, Ks, pd.Index(Js, name="J"), pd.Index(Ks, name="K")


def jk_grid_table(spreads, live, Js, Ks, freq: int = 12):
    """J x K grid summary: ``(mean_df, tstat_df, sharpe_df)`` indexed by J
    with K columns; ``tstat_df`` holds Newey–West t-stats with lag = K
    (K-month overlapping books make the spreads serially correlated)."""
    spreads = torch.as_tensor(spreads).to(torch.float64)
    live = torch.as_tensor(live, device=spreads.device)
    Js, Ks, idx, cols = _jk_index(Js, Ks)
    mean = np.full((len(Js), len(Ks)), np.nan)
    tstat = np.full_like(mean, np.nan)
    shp = np.full_like(mean, np.nan)
    for i in range(len(Js)):
        for j in range(len(Ks)):
            r = _row_stats(*_masked_rows(spreads[i, j], live[i, j]), freq,
                           nw_lags=Ks[j])
            mean[i, j], tstat[i, j], shp[i, j] = (
                r["mean_ret"], r["t_stat_nw"], r["ann_sharpe"])
    return (pd.DataFrame(mean, index=idx, columns=cols),
            pd.DataFrame(tstat, index=idx, columns=cols),
            pd.DataFrame(shp, index=idx, columns=cols))


def jk_grid_ci_table(spreads, live, Js, Ks, key=None, n_samples: int = 200,
                     block_len: int = 6, freq: int = 12, ci_level: float = 0.95,
                     index_dtype=torch.int32):
    """Block-bootstrap CIs of every cell's mean monthly spread:
    ``(lo_df, hi_df)``, indexed by J with K columns, the resamples shared
    across cells.  ``key`` defaults to ``PRNGKey(0)`` (reproducible
    tables); ``index_dtype`` as in
    :func:`~csmom_tpu_torch.analytics.bootstrap.circular_block_indices`.
    """
    if key is None:
        key = random.PRNGKey(0)
    spreads = torch.nan_to_num(torch.as_tensor(spreads).to(torch.float64))
    live = torch.as_tensor(live, device=spreads.device).to(torch.bool)
    res = block_bootstrap_grid(spreads, live, key, n_samples=n_samples,
                               block_len=block_len, freq=freq,
                               ci_level=ci_level, index_dtype=index_dtype)
    ci = res.mean_ci.cpu().numpy()  # [2, nJ, nK]
    _, _, idx, cols = _jk_index(Js, Ks)
    return (pd.DataFrame(ci[0], index=idx, columns=cols),
            pd.DataFrame(ci[1], index=idx, columns=cols))


def tercile_labels(V: int) -> list[str]:
    """Display names for volume groups, shared by tables and plots so the
    legend and columns can't drift: V1 (low) .. V{V} (high)."""
    if V == 1:
        return ["V1"]
    return (["V1 (low)"] + [f"V{v + 1}" for v in range(1, V - 1)]
            + [f"V{V} (high)"])


def _host(x, dtype=float):
    """A tensor or array as a host numpy array."""
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _horizon_buckets(H: int, group: int):
    """``(label, lo, hi)`` of each bucket of ``group`` horizons."""
    for lo in range(0, H, group):
        hi = min(lo + group, H)
        yield (f"m{lo + 1}" if hi == lo + 1 else f"m{lo + 1}-{hi}"), lo, hi


def _finite_mean(seg):
    ok = np.isfinite(seg)
    return float(np.mean(seg[ok])) if ok.any() else np.nan


def horizon_table(hp, group: int = 6) -> pd.DataFrame:
    """Event-time profile table (Lee–Swaminathan Tables VI–VIII shape):
    per bucket of ``group`` horizons of a
    :class:`~csmom_tpu_torch.backtest.horizon.HorizonProfile`, the mean
    monthly spread, the range of its NW t-stats, the cohort count and the
    cumulative event-time spread at the bucket's end."""
    mean_h = _host(hp.mean_spread)
    t_h = _host(hp.tstat_nw)
    n_h = _host(hp.n_cohorts, dtype=None)
    cum = _host(hp.cum_spread)
    rows = {}
    for label, lo, hi in _horizon_buckets(len(mean_h), group):
        t_ok = np.isfinite(t_h[lo:hi]).any()  # t is NaN where n <= 1
        rows[label] = {
            "mean_spread": _finite_mean(mean_h[lo:hi]),
            "t_nw_min": float(np.nanmin(t_h[lo:hi])) if t_ok else np.nan,
            "t_nw_max": float(np.nanmax(t_h[lo:hi])) if t_ok else np.nan,
            "cohorts": int(n_h[lo:hi].max()),
            "cum_spread": float(cum[hi - 1]),
        }
    return pd.DataFrame(rows).T


def volume_horizon_table(vhp, group: int = 6) -> pd.DataFrame:
    """Momentum life-cycle table (LeSw00 Table VIII shape): per bucket of
    horizons of a :class:`~csmom_tpu_torch.backtest.horizon.VolumeHorizonProfile`,
    each tercile's mean spread, the high-minus-low mean, and the signed
    NW t of that difference at its largest magnitude (a late-stage
    reversal shows as a significantly negative value)."""
    mean_vh = _host(vhp.mean_spread)   # [V, H]
    diff = _host(vhp.diff_mean)        # [H]
    dt = _host(vhp.diff_tstat_nw)
    V, H = mean_vh.shape
    names = tercile_labels(V)
    rows = {}
    for label, lo, hi in _horizon_buckets(H, group):
        row = {names[v]: _finite_mean(mean_vh[v, lo:hi]) for v in range(V)}
        row["Vhigh-Vlow"] = _finite_mean(diff[lo:hi])
        t_seg = dt[lo:hi]
        row["diff_t_nw"] = (float(t_seg[np.nanargmax(np.abs(t_seg))])
                            if np.isfinite(t_seg).any() else np.nan)
        rows[label] = row
    return pd.DataFrame(rows).T


def double_sort_table(ds, freq: int = 12,
                      half_spread_bps: float | None = None) -> pd.DataFrame:
    """Momentum spread by volume tercile (paper Table II shape) from a
    :class:`~csmom_tpu_torch.backtest.double_sort.DoubleSortResult`: rows
    V1 (low volume) .. V{n} (high volume) and the high-minus-low row, with
    mean spread, Sharpe, t-stats and months.

    With ``half_spread_bps``, each tercile row also carries its book's
    mean |dw| turnover over the months with book activity (valid months,
    plus the month a book unwinds), the mean net of linear costs at that
    half-spread, and the break-even half-spread in bps.
    """
    spreads = _host(ds.spreads)
    valid = _host(ds.spread_valid, dtype=bool)
    V = spreads.shape[0]
    names = tercile_labels(V)
    rows = {}
    for v in range(V):
        r = _row_stats(*_masked_rows(spreads[v], valid[v]), freq)
        if half_spread_bps is not None:
            turn = _host(ds.book_turnover)[v]
            active = valid[v] | (np.nan_to_num(turn) > 0)
            mt = float(np.mean(turn[active])) if active.any() else np.nan
            r["mean_turnover"] = mt
            r["net_mean"] = r["mean_ret"] - half_spread_bps / 1e4 * mt
            r["be_bps"] = (r["mean_ret"] / mt * 1e4) if mt > 0 else np.nan
        rows[names[v]] = r
    both = valid[V - 1] & valid[0]
    diff = np.where(both, spreads[V - 1] - spreads[0], np.nan)
    drow = _row_stats(*_masked_rows(diff, both), freq)
    if half_spread_bps is not None:
        # the difference row is a comparison, not a tradable book
        drow["mean_turnover"] = drow["net_mean"] = drow["be_bps"] = np.nan
    rows[f"V{V}-V1"] = drow
    return pd.DataFrame(rows).T
