"""Hysteresis-banded monthly rebalancing: trade less, keep the signal.

Counterpart of :mod:`csmom_tpu.backtest.banded`.  The plain engine re-forms
the long-short book every month from that month's sort, so names at the
decile edge flap in and out and every flap pays turnover.  Under a no-trade
band a name ENTERS the long book only in the top decile
(``label == n_bins-1``) but STAYS while it is within ``band`` deciles of the
top (``label >= n_bins-1-band``); the short leg is symmetric (enter at 0,
stay while ``label <= band``).  An invalid month forces an exit, and
``band=0`` is exactly the plain engine's top-minus-bottom book.

The membership recursion ``x_t = enter_t | (stay_t & x_{t-1})`` with
``x_{-1} = False`` (the reference's ``lax.associative_scan``) has a closed
form: with ``E_t`` the last month ``<= t`` that enters and ``S_t`` the last
month ``<= t`` that does not stay (each -1 when there is none),
``x_t = (E_t >= 0) & (S_t <= E_t)``.  Both are running maxima of month
indices (``torch.cummax``): no loop over months and no float, so the books
equal the reference's as booleans.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum,
    monthly_returns,
)

__all__ = ["BandedResult", "banded_from_labels", "banded_monthly_backtest",
           "banded_books", "book_partials", "finalize_book_spread",
           "validate_band"]


@dataclasses.dataclass(frozen=True)
class BandedResult:
    """Outputs of one banded monthly backtest (tensors, time-indexed)."""

    spread: torch.Tensor        # f[M] long-book minus short-book next-month return
    spread_valid: torch.Tensor  # bool[M]
    weights: torch.Tensor       # f[A, M] book weights at formation (+1/nL, -1/nS)
    n_long: torch.Tensor        # i32[M] long-book members
    n_short: torch.Tensor       # i32[M] short-book members
    turnover: torch.Tensor      # f[M] L1 weight change vs the previous month
    mean_spread: torch.Tensor   # scalar
    ann_sharpe: torch.Tensor    # scalar
    tstat: torch.Tensor         # scalar iid t
    tstat_nw: torch.Tensor      # scalar Newey–West t


def _book(enter, stay):
    """``x_t = enter_t | (stay_t & x_{t-1})`` along the last axis from
    ``x_{-1} = False``: a member since the last entry iff no month since
    it failed to stay."""
    t = torch.arange(enter.shape[-1], device=enter.device)
    last_enter = torch.cummax(torch.where(enter, t, -1), dim=-1).values
    last_leave = torch.cummax(torch.where(stay, -1, t), dim=-1).values
    return (last_enter >= 0) & (last_leave <= last_enter)


def banded_books(labels, n_bins: int, band: int):
    """Long/short membership books under the hysteresis rule.

    Args:
      labels: i32[A, M] decile ids (-1 invalid), as produced by
        :func:`csmom_tpu_torch.ops.ranking.decile_assign_panel`.
      band: stay-zone width in deciles.  0 = plain extreme-decile book.

    Returns:
      ``(long bool[A, M], short bool[A, M])``.
    """
    labv = labels >= 0
    top = n_bins - 1
    long_b = _book(labv & (labels == top), labv & (labels >= top - band))
    short_b = _book(labv & (labels == 0), labv & (labels <= band))
    return long_b, short_b


def banded_monthly_backtest(
    prices,
    mask,
    lookback: int = 12,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    band: int = 1,
    freq: int = 12,
) -> BandedResult:
    """Monthly momentum with a no-trade hysteresis band.

    The formation of :func:`~csmom_tpu_torch.backtest.monthly.monthly_spread_backtest`
    (signal, per-month decile sort: the same labels), then the books of
    :func:`banded_books` instead of a fresh extreme-decile book.  The
    spread is the equal-weighted mean next-month return of the long book
    minus the short book (members with no next-month return drop from the
    mean, as in the plain engine); ``turnover`` is the L1 change of the
    membership weights, ready for ``cost[t] = half_spread * turnover[t]``.

    ``band`` must satisfy ``2*band < n_bins - 1`` so the two stay-zones
    cannot overlap.  Runs on the tensors' device.
    """
    ret, ret_valid = monthly_returns(prices, mask)
    mom, mom_valid = momentum(prices, mask, lookback=lookback, skip=skip)
    # the plain engine's delisting rule (band=0 must stay identical)
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    return banded_from_labels(labels, ret, ret_valid, n_bins=n_bins,
                              band=band, freq=freq)


def validate_band(band: int, n_bins: int) -> None:
    """The band rule (the engines raise it): stay-zones must not overlap,
    so a name can never qualify for both books."""
    if band < 0 or 2 * band >= n_bins - 1:
        raise ValueError(
            f"band={band} with n_bins={n_bins}: need 0 <= 2*band < n_bins-1 "
            "so the long and short stay-zones cannot overlap"
        )


def book_partials(long_b, short_b, ret, ret_valid):
    """Per-month partials of the book aggregation: f[4, M] of the long
    return sum, the short return sum, and the long and short counts of
    members with a next-month return (the plain engine's convention)."""
    next_ret = torch.roll(ret, -1, dims=1)
    next_valid = torch.roll(ret_valid, -1, dims=1)
    next_valid[:, -1] = False
    lv = long_b & next_valid
    sv = short_b & next_valid
    r0 = torch.where(next_valid, torch.nan_to_num(next_ret), 0.0)
    return torch.stack([
        torch.where(lv, r0, 0.0).sum(dim=0),
        torch.where(sv, r0, 0.0).sum(dim=0),
        lv.sum(dim=0).to(r0.dtype),
        sv.sum(dim=0).to(r0.dtype),
    ])


def finalize_book_spread(partials):
    """Book partials -> ``(spread, valid, nl, ns)``."""
    lsum, ssum, nl, ns = partials
    lmean = lsum / nl.clamp(min=1.0)
    smean = ssum / ns.clamp(min=1.0)
    valid = (nl > 0) & (ns > 0)
    return torch.where(valid, lmean - smean, torch.nan), valid, nl, ns


def banded_from_labels(
    labels,
    ret,
    ret_valid,
    n_bins: int = 10,
    band: int = 1,
    freq: int = 12,
) -> BandedResult:
    """Banded backtest from precomputed decile labels and monthly returns:
    a caller that already ranked (or sweeps ``band`` over one ranking)
    skips the formation."""
    validate_band(band, n_bins)

    long_b, short_b = banded_books(labels, n_bins, band)
    n_long = long_b.sum(dim=0, dtype=torch.int32)
    n_short = short_b.sum(dim=0, dtype=torch.int32)

    partials = book_partials(long_b, short_b, ret, ret_valid)
    spread, spread_valid, nl, ns = finalize_book_spread(partials)

    # the plain cost path's weights (long_short_weights/turnover_cost):
    # denominators and live-gating use next-VALID member counts while
    # every book member carries a weight, so band=0 charges what the
    # plain engine charges, month for month
    dt = ret.dtype
    w = (long_b.to(dt) / nl.clamp(min=1).to(dt)
         - short_b.to(dt) / ns.clamp(min=1).to(dt))
    w = torch.where(spread_valid[None, :], w, 0.0)
    prev = torch.roll(w, 1, dims=1)
    prev[:, 0] = 0.0
    turnover = (w - prev).abs().sum(dim=0)

    return BandedResult(
        spread=spread,
        spread_valid=spread_valid,
        weights=w,
        n_long=n_long,
        n_short=n_short,
        turnover=turnover,
        mean_spread=masked_mean(spread, spread_valid),
        ann_sharpe=sharpe(spread, spread_valid, freq_per_year=freq),
        tstat=t_stat(spread, spread_valid),
        tstat_nw=nw_t_stat(spread, spread_valid),
    )
