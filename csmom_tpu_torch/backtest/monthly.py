"""Monthly cross-sectional decile backtest.

Counterpart of :mod:`csmom_tpu.backtest.monthly`: momentum signal ->
per-month decile labels -> equal-weighted decile means of next-month
returns -> top-minus-bottom spread -> Sharpe and t-statistics, with the
sector-neutral variant and the net-of-costs spread (BASELINE config 3).
The per-(decile, month) aggregation is kernel K1
(:func:`csmom_tpu_torch.ops.kernels.decile_partial_sums`).

``impl="kernel"`` (the default) launches the CUDA kernel for CUDA tensors
and runs its plain version for CPU tensors; ``impl="plain"`` forces the
plain version (the reference's ``impl="xla"``), for tests and comparisons.

:func:`monthly_spread_backtest` also takes a batch of panels ``[B, A,
M]`` (the serving tier's micro-batch), where the reference vmaps
over them: time-axis steps act on each asset row, ranking on each
(panel, month) column, and the aggregation folds the batch into the
month axis, ``[A, B*M]``, so K1 runs once for the whole batch.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.costs.impact import long_short_weights, turnover_cost
from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.ops.ranking import decile_assign_panel, sector_decile_assign_panel
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
    ``(sums f[..., n_bins, M], counts i32[..., n_bins, M])`` of panels
    ``[..., A, M]``.  Leading axes fold into the month axis (every column
    of ``[A, L*M]`` is one panel's cross-section at one month), so one
    kernel launch covers them all."""
    lab = torch.where(next_valid, labels, -1)
    r = torch.where(lab >= 0, torch.nan_to_num(next_ret), 0.0)
    lead, (A, M) = lab.shape[:-2], lab.shape[-2:]
    if lead:  # [..., A, M] -> contiguous [A, L*M]
        lab = lab.movedim(-2, 0).reshape(A, -1)
        r = r.movedim(-2, 0).reshape(A, -1)
    if impl == "kernel":
        sums, counts = kernels.decile_partial_sums(r, lab, n_bins)
    elif impl == "plain":
        sums, counts = kernels.decile_partial_sums_plain(r, lab, n_bins)
    else:
        raise ValueError(f"unknown impl {impl!r}: use 'kernel' or 'plain'")
    if lead:
        sums = sums.reshape(n_bins, *lead, M).movedim(0, -2)
        counts = counts.reshape(n_bins, *lead, M).movedim(0, -2)
    return sums, counts.to(torch.int32)


def decile_means(sums, counts):
    """Equal-weighted decile means from partial sums (NaN for empty bins)."""
    return torch.where(counts > 0, sums / counts.clamp(min=1), torch.nan)


def decile_portfolio_returns(next_ret, next_valid, labels, n_bins: int,
                             impl: str = "kernel"):
    """Equal-weighted mean next-period return per (decile, date):
    ``(means f[B, M], counts i32[B, M])``, through K1 on a CUDA tensor
    (``impl="kernel"``) or its plain version (``impl="plain"``)."""
    sums, counts = decile_partial_sums(next_ret, next_valid, labels, n_bins, impl=impl)
    return decile_means(sums, counts), counts


def next_month_spread(ret, ret_valid, labels, n_bins: int,
                      impl: str = "kernel"):
    """Align next-month returns to the formation month and pool decile
    means: ``(spread f[..., M], spread_valid bool[..., M], means f[...,
    n_bins, M], counts i32[..., n_bins, M])`` of panels ``[..., A, M]``.
    Each panel's months roll on their own, before any folding, so no
    panel reads another's first month."""
    next_ret = torch.roll(ret, -1, dims=-1)
    next_valid = torch.roll(ret_valid, -1, dims=-1)
    next_valid[..., -1] = False
    next_valid &= labels >= 0

    means, counts = decile_portfolio_returns(next_ret, next_valid, labels, n_bins,
                                             impl=impl)
    spread_valid = (counts[..., n_bins - 1, :] > 0) & (counts[..., 0, :] > 0)
    spread = torch.where(spread_valid,
                         means[..., n_bins - 1, :] - means[..., 0, :], torch.nan)
    return spread, spread_valid, means, counts


def _assemble_result(ret, ret_valid, labels, n_bins: int, freq: int,
                     impl: str = "kernel") -> MonthlyResult:
    """Pool decile means of next-month returns and wrap the spread
    statistics."""
    spread, spread_valid, means, counts = next_month_spread(
        ret, ret_valid, labels, n_bins, impl=impl)
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
        backtest runs on its device), or a batch of panels f[B, A, M]
        (every result field then gains the leading B axis).
      mask: bool[A, M] (or [B, A, M]) observation mask.
      lookback: J months compounded into the formation signal.
      skip: months between window end and formation.
      n_bins: cross-sectional quantile bins (10 = deciles).
      mode: 'qcut' for pandas parity, 'rank' for ordinal binning.
      freq: periods per year for annualization.
      impl: 'kernel' (CUDA kernel K1 on the card) or 'plain'.
    """
    ret, ret_valid, labels = formation_labels(prices, mask, lookback, skip,
                                              n_bins, mode)
    return _assemble_result(ret, ret_valid, labels, n_bins, freq, impl=impl)


def formation_labels(prices, mask, lookback: int, skip: int, n_bins: int,
                     mode: str):
    """The backtest's inputs to aggregation: ``(ret, ret_valid, labels
    i32)``, all ``[..., A, M]``, the labels the momentum deciles at each
    formation month."""
    ret, ret_valid = monthly_returns(prices, mask)
    mom, mom_valid = momentum(prices, mask, lookback=lookback, skip=skip)
    # the reference's backtest scripts drop an asset from ranking once it
    # is delisted at the window-end month
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    return ret, ret_valid, labels


def sector_neutral_backtest(
    prices,
    mask,
    sector_ids,
    n_sectors: int,
    lookback: int = 12,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    freq: int = 12,
    impl: str = "kernel",
) -> MonthlyResult:
    """Monthly decile backtest with sector-neutral ranking (BASELINE config 3).

    :func:`monthly_spread_backtest` with the formation bins of
    :func:`~csmom_tpu_torch.ops.ranking.sector_decile_assign_panel`: each
    asset is ranked within its sector and the pooled extreme bins form the
    legs, so the spread carries no net sector tilt.  ``sector_ids`` is
    ``int[A]`` in ``[0, n_sectors)``; negative ids are unclassified and
    unranked.  ``impl`` as in :func:`monthly_spread_backtest` (K1 on the card).
    """
    ret, ret_valid = monthly_returns(prices, mask)
    mom, mom_valid = momentum(prices, mask, lookback=lookback, skip=skip)
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = sector_decile_assign_panel(mom, mom_valid, sector_ids, n_sectors,
                                           n_bins=n_bins, mode=mode)
    return _assemble_result(ret, ret_valid, labels, n_bins, freq, impl=impl)


def net_of_costs_arrays(labels, decile_counts, spread, spread_valid,
                        half_spread: float = 0.0005, n_bins: int = 10,
                        freq: int = 12):
    """The cost adjustment on the four panel outputs it reads:
    ``(net_spread f[M], net_mean, net_sharpe)``."""
    w = long_short_weights(labels, decile_counts, n_bins, dtype=spread.dtype)
    cost = turnover_cost(w, half_spread)
    net = torch.where(spread_valid, spread - cost, torch.nan)
    return (net, masked_mean(net, spread_valid),
            sharpe(net, spread_valid, freq_per_year=freq))


def net_of_costs(result: MonthlyResult, half_spread: float = 0.0005,
                 n_bins: int = 10, freq: int = 12):
    """Spread net of linear transaction costs (BASELINE config 3): each
    month pays ``half_spread`` per unit of weight turnover of the
    equal-weight long-short book the labels imply.  Returns ``(net_spread
    f[M], net_mean, net_sharpe)``; validity is unchanged."""
    return net_of_costs_arrays(result.labels, result.decile_counts,
                               result.spread, result.spread_valid,
                               half_spread=half_spread, n_bins=n_bins, freq=freq)
