"""Pandas engine: reference-semantics monthly backtest on the CPU.

A copy of :mod:`csmom_tpu.backends.pandas_engine` (it uses only pandas and
numpy): the same monthly momentum replication as the card engine, in
pandas over the panel's wide-DataFrame view — the engine a user runs
where no accelerator exists.

Semantics follow the reference pipeline: per-ticker ``pct_change``
monthly returns over *surviving* months, momentum as the compounded
J-month return ending ``skip`` months before formation with NaN warmup
propagation (the first signal lands at month J+skip+1), per-date
``qcut(duplicates='drop')`` deciles with the ordinal-rank fallback, and
the equal-weighted top-minus-bottom next-month spread.

As in the card engine, ``next_ret`` is the *calendar* next month's return
(valid only when both consecutive month-ends exist), not the
next-surviving-row return; on gap-free panels the two are identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd


@dataclasses.dataclass(frozen=True)
class PandasMonthlyResult:
    """Mirror of :class:`csmom_tpu_torch.backtest.monthly.MonthlyResult` in host types."""

    spread: pd.Series           # indexed by month-end timestamp (NaN = invalid)
    decile_means: pd.DataFrame  # [n_bins x M]
    decile_counts: pd.DataFrame
    labels: pd.DataFrame        # [A x M], -1 invalid
    mean_spread: float
    ann_sharpe: float
    tstat: float
    tstat_nw: float


def _nw_tstat_1d(sv: np.ndarray, lags: int | None = None) -> float:
    """Newey–West (Bartlett) t-stat of the mean of a dense 1-d series.

    Independent numpy implementation of the convention documented in
    :func:`csmom_tpu_torch.analytics.stats.nw_t_stat` (gammas normalized by n, no
    small-sample correction, automatic bandwidth floor(4*(n/100)^(2/9)) when
    ``lags`` is None) — serving as the host-side oracle the backend-parity
    tests compare the kernel against.
    """
    sv = np.asarray(sv, dtype=float)
    n = len(sv)
    if n < 2:
        return float("nan")
    u = sv - sv.mean()
    L = int(np.floor(4.0 * (n / 100.0) ** (2.0 / 9.0))) if lags is None else int(lags)
    L = min(L, n - 1)
    lrv = float(u @ u) / n
    for lag in range(1, L + 1):
        w = 1.0 - lag / (L + 1.0)
        lrv += 2.0 * w * float(u[lag:] @ u[:-lag]) / n
    if lrv <= 0:
        return float("nan")
    return float(sv.mean() / np.sqrt(lrv / n))


def _qcut_labels_1d(vals: pd.Series, n_bins: int) -> pd.Series:
    """Reference decile assignment on one cross-section
    (``run_demo.py:18-29``): qcut with duplicates dropped, rank fallback."""
    out = pd.Series(-1, index=vals.index, dtype=int)
    sv = vals.dropna()
    if sv.empty:
        return out
    try:
        labels = pd.qcut(sv, q=n_bins, labels=False, duplicates="drop")
    except ValueError:
        ranks = sv.rank(method="first", pct=True)
        labels = np.minimum(np.floor(ranks * n_bins), n_bins - 1)
    labels = pd.Series(labels, index=sv.index)
    good = labels.notna()
    out.loc[labels.index[good]] = labels[good].astype(int)
    return out


def _momentum_frame(prices: pd.DataFrame, lookback: int, skip: int) -> pd.DataFrame:
    """Compounded J-month momentum ended ``skip`` months back, per row.

    ``prices`` is wide [A x M].  Computed per ticker over surviving columns
    via log1p prefix sums with a NaN-poisoning guard, which is arithmetically
    identical to ``shift(skip).rolling(J, min_periods=1).apply(prod-1)`` on
    gapless monthly returns (the leading pct_change NaN makes every partial
    window NaN, so min_periods=1 never bites at the head — SURVEY §2.1.2).
    """
    mom = pd.DataFrame(np.nan, index=prices.index, columns=prices.columns)
    for ticker, row in prices.iterrows():
        s = row.dropna()
        if len(s) < 2:
            continue
        ret = s.pct_change()
        log_g = np.log1p(ret.fillna(0.0))
        csum = log_g.cumsum()
        nan_c = ret.isna().astype(int).cumsum()
        m = np.exp(csum.shift(skip) - csum.shift(skip + lookback)) - 1.0
        # windows containing any NaN return (i.e. the first row) are invalid
        poisoned = (nan_c.shift(skip) - nan_c.shift(skip + lookback)) != 0
        m[poisoned | m.isna()] = np.nan
        mom.loc[ticker, s.index] = m.values
    return mom


def monthly_spread_backtest_pandas(
    prices: pd.DataFrame,
    lookback: int = 12,
    skip: int = 1,
    n_bins: int = 10,
    freq: int = 12,
) -> PandasMonthlyResult:
    """Monthly decile backtest with reference semantics, pure pandas.

    Args:
      prices: wide [A x M] month-end price frame (NaN = no observation),
        e.g. ``Panel.to_dataframe()``.
    """
    mom = _momentum_frame(prices, lookback, skip)
    return spread_from_scores_pandas(prices, mom, n_bins=n_bins, freq=freq)


def spread_from_scores_pandas(
    prices: pd.DataFrame,
    scores: pd.DataFrame,
    n_bins: int = 10,
    freq: int = 12,
) -> PandasMonthlyResult:
    """Ranking/portfolio tail shared by every strategy on this engine:
    per-date qcut deciles of ``scores`` -> equal-weighted next-month decile
    means -> top-minus-bottom spread (``run_demo.py:46-73`` semantics).

    ``scores`` is wide [A x M], NaN = not rankable that date (the Strategy
    plugin boundary's contract; see :mod:`csmom_tpu_torch.strategy`).
    """
    ret = prices.pct_change(axis=1)
    # calendar-aligned validity: both consecutive month-ends present
    both = prices.notna() & prices.shift(1, axis=1).notna()
    ret = ret.where(both)

    labels = scores.apply(lambda col: _qcut_labels_1d(col, n_bins), axis=0)

    next_ret = ret.shift(-1, axis=1)
    bins = range(n_bins)
    sums, counts = [], []
    for b in bins:
        member = (labels == b) & next_ret.notna()
        sums.append(next_ret.where(member).sum(axis=0))
        counts.append(member.sum(axis=0))
    decile_means = pd.DataFrame(
        [s / c.where(c > 0) for s, c in zip(sums, counts)], index=list(bins)
    )
    decile_counts = pd.DataFrame(counts, index=list(bins))

    spread = decile_means.loc[n_bins - 1] - decile_means.loc[0]
    live = (decile_counts.loc[n_bins - 1] > 0) & (decile_counts.loc[0] > 0)
    spread = spread.where(live)

    sv = spread.dropna()
    mean_spread = float(sv.mean()) if len(sv) else float("nan")
    sd = float(sv.std(ddof=1)) if len(sv) > 1 else float("nan")
    ann_sharpe = (
        mean_spread * freq / (sd * np.sqrt(freq))
        if np.isfinite(sd) and sd > 0
        else float("nan")
    )
    tstat = (
        mean_spread / (sd / np.sqrt(len(sv)))
        if np.isfinite(sd) and sd > 0 and len(sv)
        else float("nan")
    )
    return PandasMonthlyResult(
        spread=spread,
        decile_means=decile_means,
        decile_counts=decile_counts,
        labels=labels.astype(int),
        mean_spread=mean_spread,
        ann_sharpe=ann_sharpe,
        tstat=tstat,
        tstat_nw=_nw_tstat_1d(sv.to_numpy()),
    )
