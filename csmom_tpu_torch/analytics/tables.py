"""Paper-style result tables (host-side pandas display objects).

Counterpart of :mod:`csmom_tpu.analytics.tables` for the decile table and
the J x K grid tables (Lee & Swaminathan 2000, Table I shape): the
engines' outputs rendered as small DataFrames.  Each row's statistics come
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

__all__ = ["decile_table", "jk_grid_table", "jk_grid_ci_table", "tercile_labels"]


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
