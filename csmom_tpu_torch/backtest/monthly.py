"""Monthly cross-sectional decile backtest.

Counterpart of :mod:`csmom_tpu.backtest.monthly`: momentum signal ->
per-month decile labels -> equal-weighted decile means of next-month
returns -> top-minus-bottom spread -> Sharpe and t-statistics.  The
per-(decile, month) aggregation is kernel K1
(:func:`csmom_tpu_torch.ops.kernels.decile_partial_sums`).

``impl="kernel"`` (the default) launches the CUDA kernel for CUDA tensors
and runs its plain version for CPU tensors; ``impl="plain"`` forces the
plain version (the reference's ``impl="xla"``), for tests and comparisons.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum,
    monthly_returns,
)


@dataclasses.dataclass(frozen=True)
class MonthlyResult:
    """Outputs of one monthly decile backtest (tensors, time-indexed)."""

    spread: torch.Tensor         # f[M] top-minus-bottom next-month return
    spread_valid: torch.Tensor   # bool[M]
    decile_means: torch.Tensor   # f[n_bins, M]
    decile_counts: torch.Tensor  # i32[n_bins, M]
    labels: torch.Tensor         # i32[A, M] decile at formation, -1 invalid
    mean_spread: torch.Tensor    # scalar
    ann_sharpe: torch.Tensor     # scalar
    tstat: torch.Tensor          # scalar iid t-stat
    tstat_nw: torch.Tensor       # scalar Newey–West t-stat (auto bandwidth)


def decile_partial_sums(next_ret, next_valid, labels, n_bins: int,
                        impl: str = "kernel"):
    """Per-(decile, month) sums and counts over the asset axis:
    ``(sums f[B, M], counts i32[B, M])``."""
    lab = torch.where(next_valid, labels, -1)
    r = torch.where(lab >= 0, torch.nan_to_num(next_ret), 0.0)
    if impl == "kernel":
        sums, counts = kernels.decile_partial_sums(r, lab, n_bins)
    elif impl == "plain":
        sums, counts = kernels.decile_partial_sums_plain(r, lab, n_bins)
    else:
        raise ValueError(f"unknown impl {impl!r}: use 'kernel' or 'plain'")
    return sums, counts.to(torch.int32)


def decile_means(sums, counts):
    """Equal-weighted decile means from partial sums (NaN for empty bins)."""
    return torch.where(counts > 0, sums / counts.clamp(min=1), torch.nan)


def _assemble_result(ret, ret_valid, labels, n_bins: int, freq: int,
                     impl: str = "kernel") -> MonthlyResult:
    """Align next-month returns to the formation month, pool decile means,
    and wrap the spread statistics."""
    next_ret = torch.roll(ret, -1, dims=1)
    next_valid = torch.roll(ret_valid, -1, dims=1)
    next_valid[:, -1] = False
    next_valid &= labels >= 0

    sums, counts = decile_partial_sums(next_ret, next_valid, labels, n_bins,
                                       impl=impl)
    means = decile_means(sums, counts)
    spread_valid = (counts[n_bins - 1] > 0) & (counts[0] > 0)
    spread = torch.where(spread_valid, means[n_bins - 1] - means[0], torch.nan)
    return MonthlyResult(
        spread=spread,
        spread_valid=spread_valid,
        decile_means=means,
        decile_counts=counts,
        labels=labels,
        mean_spread=masked_mean(spread, spread_valid),
        ann_sharpe=sharpe(spread, spread_valid, freq_per_year=freq),
        tstat=t_stat(spread, spread_valid),
        tstat_nw=nw_t_stat(spread, spread_valid),
    )


def monthly_spread_backtest(
    prices,
    mask,
    lookback: int = 12,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    freq: int = 12,
    impl: str = "kernel",
) -> MonthlyResult:
    """Full monthly momentum replication on a month-end price panel.

    Args:
      prices: f[A, M] month-end prices, NaN at masked slots (a tensor; the
        backtest runs on its device).
      mask: bool[A, M] observation mask.
      lookback: J months compounded into the formation signal.
      skip: months between window end and formation.
      n_bins: cross-sectional quantile bins (10 = deciles).
      mode: 'qcut' for pandas parity, 'rank' for ordinal binning.
      freq: periods per year for annualization.
      impl: 'kernel' (CUDA kernel K1 on the card) or 'plain'.
    """
    ret, ret_valid = monthly_returns(prices, mask)
    mom, mom_valid = momentum(prices, mask, lookback=lookback, skip=skip)
    # the reference's backtest scripts drop an asset from ranking once it
    # is delisted at the window-end month
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    return _assemble_result(ret, ret_valid, labels, n_bins, freq, impl=impl)
