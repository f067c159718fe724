"""Walk-forward (J, K) selection (BASELINE config 5).

Counterpart of :mod:`csmom_tpu.backtest.walkforward`: at every month m,
pick the grid cell with the best annualized Sharpe over all prior months
(an expanding window) and realize that cell's month-m spread, so one
tradable series comes out of a J x K sweep without lookahead.  The
expanding statistics of every cell at every month are prefix sums over
the grid's spread tensor: one grid call, then O(cells x months) work.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.analytics.stats import masked_mean, nw_t_stat, sharpe, t_stat
from csmom_tpu_torch.backtest.grid import jk_grid_backtest, validate_grid_args


@dataclasses.dataclass(frozen=True)
class WalkForwardResult:
    """Out-of-sample selection path and its realized spread series."""

    choice: torch.Tensor           # i32[M] flat cell chosen at month m (-1 = none eligible)
    insample_sharpe: torch.Tensor  # f[G, M] expanding-window Sharpe used to select
    oos_spread: torch.Tensor       # f[M] realized spread of the chosen cell
    oos_valid: torch.Tensor        # bool[M]
    mean_spread: torch.Tensor      # scalar (masked over oos_valid)
    ann_sharpe: torch.Tensor       # scalar
    tstat: torch.Tensor            # scalar iid t-stat
    tstat_nw: torch.Tensor         # scalar Newey–West t-stat (auto bandwidth)


def _expanding_sharpe(x, live, freq: int):
    """``(sharpe f[G, M], n_prior f[G, M])``: each series' annualized Sharpe
    over months ``[0, m)``, strictly before m; NaN with fewer than 2 live
    prior months or zero variance."""
    xf = torch.where(live, torch.nan_to_num(x), 0.0)
    n = torch.cumsum(live, dim=-1).to(xf.dtype)
    s = torch.cumsum(xf, dim=-1)
    ss = torch.cumsum(xf * xf, dim=-1)

    def prior(a):  # shift right: the stats at m cover months 0..m-1
        return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)

    n, s, ss = prior(n), prior(s), prior(ss)
    mean = s / n.clamp(min=1.0)
    var = (ss - n * mean * mean) / (n - 1.0).clamp(min=1.0)
    ok = (n >= 2) & (var > 0)
    sd = torch.sqrt(torch.where(ok, var, 1.0))
    sh = torch.where(ok, mean / sd * torch.sqrt(torch.tensor(float(freq), dtype=xf.dtype,
                                                             device=xf.device)),
                     torch.nan)
    return sh, n


def walk_forward_select(spreads, spread_valid, min_months: int = 24,
                        freq: int = 12) -> WalkForwardResult:
    """Select among precomputed spread series, strictly out of sample.

    Args:
      spreads: f[..., M] grid of spread series (leading axes flattened
        into one cell axis G, row-major: cell ``j * nK + k``).
      spread_valid: bool[..., M].
      min_months: live prior months before a cell is eligible; until one
        is, the OOS series is invalid (warm-up).
      freq: periods per year for annualization.
    """
    M = spreads.shape[-1]
    x = spreads.reshape(-1, M)
    live = spread_valid.reshape(-1, M)

    sh, n_prior = _expanding_sharpe(x, live, freq)
    eligible = (n_prior >= min_months) & torch.isfinite(sh)
    score = torch.where(eligible, sh, -torch.inf)
    any_eligible = eligible.any(dim=0)
    # argmax takes the first maximum, as jnp.argmax does
    choice = torch.where(any_eligible, torch.argmax(score, dim=0), -1).to(torch.int32)

    cols = torch.arange(M, device=x.device)
    chosen = choice.clamp(0, x.shape[0] - 1).to(torch.int64)
    oos_valid = any_eligible & live[chosen, cols]
    oos = torch.where(oos_valid, x[chosen, cols], torch.nan)
    return WalkForwardResult(
        choice=choice,
        insample_sharpe=sh,
        oos_spread=oos,
        oos_valid=oos_valid,
        mean_spread=masked_mean(oos, oos_valid),
        ann_sharpe=sharpe(oos, oos_valid, freq_per_year=freq),
        tstat=t_stat(oos, oos_valid),
        tstat_nw=nw_t_stat(oos, oos_valid),
    )


def walk_forward_grid_backtest(
    prices,
    mask,
    Js,
    Ks,
    skip: int = 1,
    n_bins: int = 10,
    mode: str = "qcut",
    max_hold: int | None = None,
    min_months: int = 24,
    freq: int = 12,
    impl: str = "kernel",
):
    """One grid call, then one selection pass: ``(WalkForwardResult,
    GridResult)``; the chosen flat index is ``(J, K) = (choice // len(Ks),
    choice % len(Ks))``."""
    max_hold = validate_grid_args(Ks, max_hold)
    grid = jk_grid_backtest(prices, mask, Js, Ks, skip=skip, n_bins=n_bins,
                            mode=mode, max_hold=max_hold, freq=freq, impl=impl)
    wf = walk_forward_select(grid.spreads, grid.spread_valid,
                             min_months=min_months, freq=freq)
    return wf, grid
