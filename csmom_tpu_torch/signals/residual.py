"""Residual (idiosyncratic) momentum — Blitz, Huij & Martens (2011).

Counterpart of :mod:`csmom_tpu.signals.residual`.  Each asset's score at
formation month t comes from a market-model regression of its monthly
return r on the equal-weight market return m over the trailing
``est_window`` months, then the mean (and std) of its residuals over the
last ``lookback`` months, both windows ending at t - ``skip``.  Every
moment involved (Σr, Σm, Σrm, Σm², Σr² and the valid-month counts over
both window lengths) is a rolling masked sum: one prefix sum and one
shifted difference over the month axis.  The OLS fit and the residual
moments then follow algebraically::

    beta  = (n·Σrm − Σr·Σm) / (n·Σm² − (Σm)²)
    alpha = (Σr − beta·Σm) / n
    Σe    = Σr − n·alpha − beta·Σm                (formation window)
    Σe²   = Σr² − 2a·Σr − 2b·Σrm + n·a² + 2ab·Σm + b²·Σm²

The moments are formed in the reference's order, so the two packages
round alike.  A masked month drops out of that asset's windows (its
market return still exists for the others); a score is valid only with
every month of both windows present.
"""

from __future__ import annotations

import torch

from csmom_tpu_torch.ops.rolling import _windowed_prefix_diff
from csmom_tpu_torch.signals.momentum import monthly_returns, raw_monthly_returns


def _market_panels(prices, mask):
    """``(rf, v, mv, m_row)``: the filled returns, their validity as floats,
    the market return where the asset has a return, and the market return
    broadcast over assets."""
    A, M = prices.shape
    r, r_valid = raw_monthly_returns(prices, mask)
    rf = torch.where(r_valid, torch.nan_to_num(r), 0.0)
    v = r_valid.to(prices.dtype)
    n_xs = v.sum(dim=0)
    m = rf.sum(dim=0) / n_xs.clamp(min=1.0)
    m_row = m[None, :].expand(A, M)
    return rf, v, m_row * v, m_row


def _moments(panels, window: int):
    rf, v, mv, m_row = panels
    return {
        "n": _windowed_prefix_diff(v, window),
        "r": _windowed_prefix_diff(rf, window),
        "m": _windowed_prefix_diff(mv, window),
        "rm": _windowed_prefix_diff(rf * m_row, window),
        "mm": _windowed_prefix_diff(mv * m_row, window),
        "rr": _windowed_prefix_diff(rf * rf, window),
    }


def _lag(x, skip: int):
    """Shift right by ``skip`` months, zero (False) filled."""
    if not skip:
        return x
    return torch.nn.functional.pad(x, (skip, 0))[:, :x.shape[1]]


def _residual_score(mask, E, F, lookback: int, skip: int, est_window: int,
                    scale_by_vol: bool):
    """One (lookback, est_window) cell from the window moments ``E``
    (estimation window) and ``F`` (formation window).  A cell with
    ``est_window < max(lookback, 3)`` is all invalid."""
    denom = E["n"] * E["mm"] - E["m"] ** 2
    ok_cfg = est_window >= max(lookback, 3)
    ok_reg = (E["n"] >= est_window) & (denom > 0) & ok_cfg
    safe_denom = torch.where(ok_reg, denom, 1.0)
    beta = (E["n"] * E["rm"] - E["r"] * E["m"]) / safe_denom
    alpha = (E["r"] - beta * E["m"]) / E["n"].clamp(min=1.0)

    sum_e = F["r"] - F["n"] * alpha - beta * F["m"]
    sum_ee = (
        F["rr"]
        - 2.0 * alpha * F["r"]
        - 2.0 * beta * F["rm"]
        + F["n"] * alpha**2
        + 2.0 * alpha * beta * F["m"]
        + beta**2 * F["mm"]
    )
    nf = F["n"].clamp(min=1.0)
    mean_e = sum_e / nf
    var_e = (sum_ee / nf - mean_e**2).clamp(min=0.0)

    mean_e, var_e = _lag(mean_e, skip), _lag(var_e, skip)
    ok = _lag(ok_reg & (F["n"] >= lookback), skip) & mask

    if scale_by_vol:
        sd = torch.sqrt(var_e)
        ok = ok & (sd > 0)
        score = mean_e / torch.where(ok, sd, 1.0)
    else:
        score = mean_e
    return torch.where(ok, score, torch.nan), ok


def residual_momentum(prices, mask, lookback: int = 12, skip: int = 1,
                      est_window: int = 36, scale_by_vol: bool = True):
    """Market-model residual momentum score per (asset, month).

    Args:
      prices: f[A, M] month-end price tensor (NaN at masked slots).
      mask: bool[A, M].
      lookback: formation months J whose residuals are averaged.
      skip: most-recent months excluded (both windows end at t - skip).
      est_window: trailing months of the per-asset OLS; must be >=
        lookback and >= 3.
      scale_by_vol: divide the mean residual by its formation-window std
        (the paper's "iMom"); ``False`` ranks on the raw mean.

    Returns ``(score f[A, M], valid bool[A, M])``.
    """
    if est_window < max(lookback, 3):
        raise ValueError(
            f"est_window={est_window} must be >= max(lookback, 3)="
            f"{max(lookback, 3)}"
        )
    panels = _market_panels(prices, mask)
    return _residual_score(mask, _moments(panels, est_window),
                           _moments(panels, lookback), lookback, skip,
                           est_window, scale_by_vol)


def residual_momentum_sweep(prices, mask, lookbacks, est_windows, skip: int = 1,
                            scale_by_vol: bool = True):
    """Every (lookback, est_window) score: ``(scores f[nJ, nW, A, M],
    valid bool[nJ, nW, A, M])``; cells with ``est_window < max(lookback,
    3)`` are all invalid.  Each window length's moments are formed once."""
    Js = [int(j) for j in torch.as_tensor(lookbacks).reshape(-1).tolist()]
    Ws = [int(w) for w in torch.as_tensor(est_windows).reshape(-1).tolist()]
    panels = _market_panels(prices, mask)
    moments = {w: _moments(panels, w) for w in sorted(set(Js) | set(Ws))}
    cells = [[_residual_score(mask, moments[w], moments[j], j, skip, w,
                              scale_by_vol) for w in Ws] for j in Js]
    scores = torch.stack([torch.stack([c[0] for c in row]) for row in cells])
    valid = torch.stack([torch.stack([c[1] for c in row]) for row in cells])
    return scores, valid


def residual_sweep_backtest(prices, mask, lookbacks, est_windows, skip: int = 1,
                            scale_by_vol: bool = True, n_bins: int = 10,
                            mode: str = "rank", freq: int = 12,
                            impl: str = "kernel"):
    """Decile backtest of the whole (lookback, est_window) residual grid.

    One batched ranking of every cell's scores, then the monthly engine's
    tail (:func:`~csmom_tpu_torch.backtest.monthly._assemble_result`, so
    K1 on the card) per cell.  Returns a
    :class:`~csmom_tpu_torch.backtest.grid.GridResult` whose ``nK`` axis is
    the ``est_window`` axis (1-month holding, so ``tstat_nw`` takes the
    automatic bandwidth).
    """
    from csmom_tpu_torch.backtest.grid import GridResult
    from csmom_tpu_torch.backtest.monthly import _assemble_result
    from csmom_tpu_torch.ops.ranking import decile_assign_panel

    scores, valid = residual_momentum_sweep(prices, mask, lookbacks, est_windows,
                                            skip=skip, scale_by_vol=scale_by_vol)
    nJ, nW, A, M = scores.shape
    labels, _ = decile_assign_panel(scores.reshape(-1, A, M),
                                    valid.reshape(-1, A, M), n_bins, mode=mode)
    r, r_valid = monthly_returns(prices, mask)
    cells = [_assemble_result(r, r_valid, lab, n_bins, freq, impl=impl)
             for lab in labels]

    def field(name):
        return torch.stack([getattr(c, name) for c in cells]).reshape(
            nJ, nW, *getattr(cells[0], name).shape)

    return GridResult(
        spreads=field("spread"),
        spread_valid=field("spread_valid"),
        mean_spread=field("mean_spread"),
        ann_sharpe=field("ann_sharpe"),
        tstat=field("tstat"),
        tstat_nw=field("tstat_nw"),
    )
