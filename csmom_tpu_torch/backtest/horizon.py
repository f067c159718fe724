"""Event-time horizon profile: momentum profit by months since formation.

Counterpart of :mod:`csmom_tpu.backtest.horizon`.  Lee–Swaminathan (2000)
track portfolios for up to five years after formation (their Tables
VI–VIII: momentum persists for a year or two, then reverses, the reversal
concentrated in high-volume winners).  The grid engine's cohort tensor
``R[s, h]`` (the spread of the cohort formed at s, h+1 months after
formation) already holds every (formation, horizon) observation, so the
profile is a masked reduction over formation months at each horizon,
with Newey–West inference (adjacent cohorts overlap).

The cohort sums are kernel K2 on the card
(:func:`csmom_tpu_torch.backtest.grid._cohort_partial_sums`, ``impl=
"kernel"``): one launch with labels ``[1, A, M]`` for the plain profile,
and one with the V tercile-restricted label sets stacked ``[V, A, M]``
for the volume profile.  ``impl="plain"``, ``"matmul"`` (the reference's
form for the volume profile) and ``"matmul_bf16"`` compute the same sums.
K2 takes ``max_h <= 128``; larger values raise.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, t_stat
from csmom_tpu_torch.backtest.grid import _cohort_partial_sums, _finalize_cohorts
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum_dynamic,
    monthly_returns,
)
from csmom_tpu_torch.signals.turnover import volume_tercile_labels


@dataclasses.dataclass(frozen=True)
class HorizonProfile:
    """Per-horizon event-time statistics; every tensor is [H] (h = 1..H
    months after formation)."""

    mean_spread: torch.Tensor   # f[H] mean top-minus-bottom return at horizon h
    tstat_nw: torch.Tensor      # f[H] Newey–West t (rule-of-thumb bandwidth)
    tstat: torch.Tensor         # f[H] iid t
    n_cohorts: torch.Tensor     # i32[H] live cohorts entering each mean
    cum_spread: torch.Tensor    # f[H] cumulative sum of mean_spread


def _momentum_labels(prices, mask, lookback, skip, n_bins, mode):
    mom, mom_valid = momentum_dynamic(prices, mask, lookback, skip)
    # the ranking engines' delisting rule
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    return labels, mom_valid


def horizon_profile(
    prices,
    mask,
    lookback: int = 6,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    max_h: int = 36,
    impl: str = "kernel",
) -> HorizonProfile:
    """Event-time momentum profile over horizons 1..max_h on the panel's
    device.

    Args:
      prices: f[A, M] month-end price tensor; mask: bool[A, M].
      lookback: formation months J; skip: months between formation and
        measurement; n_bins: quantile bins; mode: ranking mode.
      max_h: the horizon bound (the paper's five-year view is 60).
      impl: the cohort sums' form (see module docstring).
    """
    ret, ret_valid = monthly_returns(prices, mask)
    labels, _ = _momentum_labels(prices, mask, lookback, skip, n_bins, mode)
    R, R_valid = _finalize_cohorts(*_cohort_partial_sums(
        labels[None], ret, ret_valid, n_bins, max_h, impl=impl))   # [1, M, H]
    Rs, Vs = R[0].T, R_valid[0].T                                  # [H, M]
    mean_h = masked_mean(Rs, Vs)
    # max_lag bounds the bandwidth loop only: the event-time series runs
    # over formation months, whatever the horizon count
    return HorizonProfile(
        mean_spread=mean_h,
        tstat_nw=nw_t_stat(Rs, Vs, lags=None, max_lag=24),
        tstat=t_stat(Rs, Vs),
        n_cohorts=Vs.sum(dim=-1).to(torch.int32),
        cum_spread=torch.cumsum(torch.nan_to_num(mean_h), dim=-1),
    )


@dataclasses.dataclass(frozen=True)
class VolumeHorizonProfile:
    """Per-(volume tercile, horizon) event-time statistics; tensors are
    [V, H] (tercile-major; V1 = low volume)."""

    mean_spread: torch.Tensor    # f[V, H]
    tstat_nw: torch.Tensor       # f[V, H]
    n_cohorts: torch.Tensor      # i32[V, H]
    cum_spread: torch.Tensor     # f[V, H]
    diff_mean: torch.Tensor      # f[H] V_high - V_low mean spread by horizon
    diff_tstat_nw: torch.Tensor  # f[H] NW t of that difference series


def volume_horizon_profile(
    prices,
    mask,
    turnover,
    turnover_valid,
    lookback: int = 6,
    skip: int = 1,
    n_bins: int = 10,
    n_vol_bins: int = 3,
    mode: str = "qcut",
    max_h: int = 36,
    impl: str = "kernel",
) -> VolumeHorizonProfile:
    """Event-time profile conditioned on trading volume — the paper's
    "momentum life cycle" (LeSw00 Table VIII).  The independent double
    sort of :func:`csmom_tpu_torch.backtest.double_sort.volume_double_sort`
    at formation, then the cohort sums of every tercile's restricted
    labels in one call (K2 once on the card)."""
    ret, ret_valid = monthly_returns(prices, mask)
    mom_labels, mom_valid = _momentum_labels(prices, mask, lookback, skip,
                                             n_bins, mode)
    both = mom_valid & turnover_valid
    vol_labels, _ = volume_tercile_labels(
        torch.where(both, turnover, torch.nan), both, n_vol_bins=n_vol_bins,
        mode=mode)

    terciles = torch.arange(n_vol_bins, device=prices.device)[:, None, None]
    labels_v = torch.where(vol_labels[None] == terciles, mom_labels[None],
                           -1).to(torch.int32)                     # [V, A, M]
    R, R_valid = _finalize_cohorts(*_cohort_partial_sums(
        labels_v, ret, ret_valid, n_bins, max_h, impl=impl))       # [V, M, H]

    Rs = R.transpose(1, 2)                                         # [V, H, M]
    Vs = R_valid.transpose(1, 2)
    mean_vh = masked_mean(Rs, Vs)
    both_v = Vs[-1] & Vs[0]                                        # [H, M]
    diff = torch.where(both_v, Rs[-1] - Rs[0], torch.nan)
    return VolumeHorizonProfile(
        mean_spread=mean_vh,
        tstat_nw=nw_t_stat(Rs, Vs, lags=None, max_lag=24),
        n_cohorts=Vs.sum(dim=-1).to(torch.int32),
        cum_spread=torch.cumsum(torch.nan_to_num(mean_vh), dim=-1),
        diff_mean=masked_mean(diff, both_v),
        diff_tstat_nw=nw_t_stat(diff, both_v, lags=None, max_lag=24),
    )
