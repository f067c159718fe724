"""Jegadeesh–Titman J x K strategy grid.

Counterpart of :mod:`csmom_tpu.backtest.grid`.  Every J is a batch index,
never a loop:

- formation signals for all J: one :func:`momentum_dynamic` call on the
  tensor of Js -> ``[nJ, A, M]``;
- decile labels for all J: one batched ranking over ``[nJ, M, A]`` rows;
- cohort forward returns ``R[j, s, h]`` (cohort formed at s under J_j, its
  spread h months later): kernel K2
  (:func:`csmom_tpu_torch.ops.kernels.cohort_partial_sums`), one launch
  for every J;
- the K axis: a cumulative mean over h gathered at each K, so every
  (J, K) cell shares the cohort tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import (
    formation_listed_mask,
    momentum_dynamic,
    monthly_returns,
)


@dataclasses.dataclass(frozen=True)
class GridResult:
    """Full J x K grid outputs; axes [nJ, nK, ...], time axis = holding month."""

    spreads: torch.Tensor       # f[nJ, nK, M] portfolio spread in month m
    spread_valid: torch.Tensor  # bool[nJ, nK, M] (all K cohorts live)
    mean_spread: torch.Tensor   # f[nJ, nK]
    ann_sharpe: torch.Tensor    # f[nJ, nK]
    tstat: torch.Tensor         # f[nJ, nK] iid t-stat
    tstat_nw: torch.Tensor      # f[nJ, nK] Newey–West t-stat, lag = K
    Js: torch.Tensor | None = None    # i64[nJ] formation lookbacks
    Ks: torch.Tensor | None = None    # i64[nK] holding periods
    skip: torch.Tensor | None = None  # i64[] skip months
    n_bins: int | None = None
    mode: str | None = None


def _cohort_partial_sums(labels, ret, ret_valid, n_bins: int, max_hold: int,
                         impl: str = "kernel"):
    """Sums/counts for each cohort x horizon over the asset axis.

    ``labels`` is ``[..., A, M]``; returns ``(sums f[..., 2, M, H],
    counts f[..., 2, M, H])``, side 0 = bottom decile, side 1 = top.
    ``impl="kernel"`` is K2 (the plain version for CPU tensors);
    ``impl="plain"`` is the rolled-panel form (the reference's ``xla``).
    """
    if impl == "plain":
        return kernels.cohort_partial_sums_plain(ret, ret_valid, labels,
                                                 n_bins, max_hold)
    if impl != "kernel":
        raise ValueError(f"unknown impl {impl!r}: use 'kernel' or 'plain'")
    A, M = labels.shape[-2:]
    lead = labels.shape[:-2]
    sums, counts = kernels.cohort_partial_sums(
        ret, ret_valid, labels.reshape(-1, A, M), n_bins, max_hold)
    H = sums.shape[-1]
    return sums.reshape(*lead, 2, M, H), counts.reshape(*lead, 2, M, H)


def _finalize_cohorts(sums, counts):
    """Partials -> ``(R f[..., M, H], R_valid bool[..., M, H])``."""
    means = sums / counts.clamp(min=1.0)
    ok = counts > 0
    R = means[..., 1, :, :] - means[..., 0, :, :]
    R_valid = ok[..., 1, :, :] & ok[..., 0, :, :]
    return R, R_valid


def _holding_month_spreads(R, R_valid, Ks):
    """Cohort tensor -> per-(J, K) overlap-averaged spreads by holding month.

    Re-indexes cohorts by holding month (``D[j, m, h] = R[j, m-(h+1), h]``),
    prefix-sums over the horizon axis and gathers each K (the JT 1/K
    overlap).  A month is live only when all K cohorts exist.

    Args: R f[nJ, M, H]; R_valid bool[nJ, M, H]; Ks i64[nK].
    Returns (spreads f[nJ, nK, M] NaN-filled, live bool[nJ, nK, M]).
    """
    nJ, M, H = R.shape
    dev = R.device
    src = torch.arange(M, device=dev)[:, None] - (torch.arange(H, device=dev)[None, :] + 1)
    in_range = src >= 0
    src_c = src.clamp(0, M - 1)
    h_idx = torch.arange(H, device=dev)[None, :].expand(M, H)
    D = R[:, src_c, h_idx]
    D_valid = R_valid[:, src_c, h_idx] & in_range[None]

    csum = torch.cumsum(torch.where(D_valid, D, 0.0), dim=2)
    cvalid = torch.cumsum(D_valid.to(torch.int32), dim=2)

    k_idx = (Ks - 1).clamp(0, H - 1)
    spreads = csum[:, :, k_idx] / Ks.clamp(min=1)[None, None, :]
    live = cvalid[:, :, k_idx] == Ks[None, None, :]
    spreads = spreads.permute(0, 2, 1)                     # [nJ, nK, M]
    live = live.permute(0, 2, 1).contiguous()
    return torch.where(live, spreads, torch.nan), live


def validate_grid_args(Ks, max_hold):
    """The horizon bound must cover max(Ks); defaults to max(Ks)."""
    k_max = int(np.max(Ks.cpu().numpy() if torch.is_tensor(Ks) else np.asarray(Ks)))
    if max_hold is None:
        return k_max
    if k_max > max_hold:
        raise ValueError(
            f"max(Ks)={k_max} exceeds max_hold={max_hold}; raise max_hold "
            "(the cohort-horizon bound) to cover every K"
        )
    return max_hold


def jk_grid_backtest(
    prices,
    mask,
    Js,
    Ks,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    max_hold: int | None = None,
    freq: int = 12,
    impl: str = "kernel",
) -> GridResult:
    """Run the full J x K momentum grid on the panel's device.

    Args:
      prices: f[A, M] month-end price tensor; mask: bool[A, M].
      Js: formation lookbacks ``[nJ]``; Ks: holding periods ``[nK]``.
      skip: months skipped between formation window and holding.
      n_bins: quantile bins; mode: 'qcut' (parity) or 'rank'.
      max_hold: horizon bound H (defaults to max(Ks)); K2 takes H <= 128.
      impl: 'kernel' (CUDA kernel K2 on the card) or 'plain'.
    """
    max_hold = validate_grid_args(Ks, max_hold)
    dev = prices.device
    Js = torch.as_tensor(Js, device=dev).to(torch.int64)
    Ks = torch.as_tensor(Ks, device=dev).to(torch.int64)
    ret, ret_valid = monthly_returns(prices, mask)

    mom, mom_valid = momentum_dynamic(prices, mask, Js, skip)   # [nJ, A, M]
    mom_valid = mom_valid & formation_listed_mask(mask, skip)
    mom = torch.where(mom_valid, mom, torch.nan)
    labels, _ = decile_assign_panel(mom, mom_valid, n_bins=n_bins, mode=mode)
    R, R_valid = _finalize_cohorts(
        *_cohort_partial_sums(labels, ret, ret_valid, n_bins, max_hold,
                              impl=impl))
    spreads, spread_valid = _holding_month_spreads(R, R_valid, Ks)

    return GridResult(
        spreads=spreads,
        spread_valid=spread_valid,
        mean_spread=masked_mean(spreads, spread_valid),
        ann_sharpe=sharpe(spreads, spread_valid, freq_per_year=freq),
        tstat=t_stat(spreads, spread_valid),
        tstat_nw=nw_t_stat(spreads, spread_valid, lags=Ks[None, :],
                           max_lag=max_hold),
        Js=Js,
        Ks=Ks,
        skip=torch.tensor(skip, device=dev),
        n_bins=n_bins,
        mode=mode,
    )
