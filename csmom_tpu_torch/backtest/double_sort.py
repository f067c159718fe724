"""Momentum x volume double sort (Lee–Swaminathan 2000, Table II).

Counterpart of :mod:`csmom_tpu.backtest.double_sort`: sort stocks
independently into J-month momentum deciles (R1..R10) and average-turnover
terciles (V1..V3) at each formation date; the intersection cells
(momentum extreme x volume tercile) are equal-weighted over the next
month.  Every tercile is a batch row of the same ops, so one call gives
every tercile's spread, cell counts and book turnover.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.costs.impact import long_short_weights, turnover_cost
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum_dynamic,
    monthly_returns,
)
from csmom_tpu_torch.signals.turnover import volume_tercile_labels


@dataclasses.dataclass(frozen=True)
class DoubleSortResult:
    spreads: torch.Tensor       # f[V, M] R-top minus R-bottom within tercile v
    spread_valid: torch.Tensor  # bool[V, M]
    mean_spread: torch.Tensor   # f[V]
    ann_sharpe: torch.Tensor    # f[V]
    tstat: torch.Tensor         # f[V] plain iid t-stat
    tstat_nw: torch.Tensor      # f[V] Newey–West t-stat (paper Table II form)
    cell_counts: torch.Tensor   # i32[V, 2, M] members in (bottom, top) cells
    book_turnover: torch.Tensor  # f[V, M] sum |dw| of the tercile's long-short
                                 # book (equal-weight legs; dead months hold
                                 # no book)


def volume_double_sort(
    prices,
    mask,
    turnover,
    turnover_valid,
    lookback: int = 6,
    skip: int = 1,
    n_bins: int = 10,
    n_vol_bins: int = 3,
    mode: str = "qcut",
    freq: int = 12,
) -> DoubleSortResult:
    """Momentum spread within each volume tercile, on the panel's device.

    Args:
      prices: f[A, M] month-end price tensor; mask: bool[A, M].
      turnover: f[A, M] volume signal (e.g. ``turn_avg``).
      turnover_valid: bool[A, M].
      lookback: J.
      n_vol_bins: volume groups (3 = LeSw terciles).
    """
    ret, ret_valid = monthly_returns(prices, mask)
    mom, mom_valid = momentum_dynamic(prices, mask, lookback, skip)
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    mom_labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    # independent sort: the momentum edges use every mom-valid asset; the
    # volume sort only assets with both signals live
    both = mom_valid & turnover_valid
    vol_labels, _ = volume_tercile_labels(
        torch.where(both, turnover, torch.nan), both, n_vol_bins=n_vol_bins,
        mode=mode)

    next_ret = torch.roll(ret, -1, dims=1)
    next_valid = torch.roll(ret_valid, -1, dims=1)
    next_valid[:, -1] = False
    live = next_valid & (mom_labels >= 0) & (vol_labels >= 0)
    rf = torch.where(live, torch.nan_to_num(next_ret), 0.0)

    terciles = torch.arange(n_vol_bins, device=prices.device)
    in_v = live[None] & (vol_labels[None] == terciles[:, None, None])   # [V, A, M]

    def cell(mom_bin):
        mem = in_v & (mom_labels == mom_bin)[None]
        cnt = mem.sum(dim=1)
        s = torch.where(mem, rf[None], 0.0).sum(dim=1)
        return s / cnt.clamp(min=1), cnt

    top_r, top_n = cell(n_bins - 1)
    bot_r, bot_n = cell(0)
    valid = (top_n > 0) & (bot_n > 0)
    spreads = torch.where(valid, top_r - bot_r, torch.nan)

    # each tercile's long-short book through the shared weight and cost
    # functions, so its turnover follows every other cost path's convention
    t_labels = torch.where(in_v, mom_labels[None], -1)
    counts_bm = torch.zeros((n_vol_bins, n_bins, prices.shape[1]),
                            dtype=top_n.dtype, device=prices.device)
    counts_bm[:, 0] = bot_n
    counts_bm[:, n_bins - 1] = top_n
    w = long_short_weights(t_labels, counts_bm, n_bins, dtype=prices.dtype)
    turns = turnover_cost(w, half_spread=1.0)   # unit spread: the raw |dw|
    return DoubleSortResult(
        spreads=spreads,
        spread_valid=valid,
        mean_spread=masked_mean(spreads, valid),
        ann_sharpe=sharpe(spreads, valid, freq_per_year=freq),
        tstat=t_stat(spreads, valid),
        tstat_nw=nw_t_stat(spreads, valid),
        cell_counts=torch.stack([bot_n, top_n], dim=1).to(torch.int32),
        book_turnover=turns,
    )
