"""Masked summary statistics over the last axis.

Counterpart of :mod:`csmom_tpu.analytics.stats`: annualized Sharpe
(ddof=1, NaN on empty or zero-std series), the plain t-statistic, and the
Newey–West (Bartlett) t-statistic the replicated paper quotes.  Every
function reduces ``[..., T]`` series, so a ``[nJ, nK, M]`` grid of spreads
reduces in one call.
"""

from __future__ import annotations

import torch


def masked_mean(x, valid, axis: int = -1):
    n = valid.sum(dim=axis)
    s = torch.where(valid, torch.nan_to_num(x), 0.0).sum(dim=axis)
    return torch.where(n > 0, s / n.clamp(min=1), torch.nan)


def masked_std(x, valid, axis: int = -1, ddof: int = 1):
    n = valid.sum(dim=axis)
    xf = torch.where(valid, torch.nan_to_num(x), 0.0)
    mean = torch.where(n > 0, xf.sum(dim=axis) / n.clamp(min=1), 0.0)
    dev = torch.where(valid, xf - mean.unsqueeze(axis), 0.0)
    ss = (dev * dev).sum(dim=axis)
    return torch.where(n > ddof, torch.sqrt(ss / (n - ddof).clamp(min=1)),
                       torch.nan)


def sharpe(returns, valid, freq_per_year: int = 252):
    """Annualized Sharpe ratio (ddof=1; NaN on empty input or zero std)."""
    mean = masked_mean(returns, valid)
    sd = masked_std(returns, valid, ddof=1)
    f = torch.tensor(freq_per_year, dtype=returns.dtype, device=returns.device)
    ann_sd = sd * torch.sqrt(f)
    return torch.where(ann_sd > 0, mean * freq_per_year / ann_sd, torch.nan)


def t_stat(returns, valid):
    """Plain t-statistic of the mean (mean / (std/sqrt(n)))."""
    n = valid.sum(dim=-1)
    mean = masked_mean(returns, valid)
    sd = masked_std(returns, valid, ddof=1)
    se = sd / torch.sqrt(n.clamp(min=1).to(returns.dtype))
    return torch.where((n > 1) & (se > 0), mean / se, torch.nan)


def nw_t_stat(returns, valid, lags=None, max_lag: int = 24):
    """Newey–West (HAC, Bartlett-kernel) t-statistic of the mean.

    ``lrv = g0 + 2 * sum_{l=1..L} (1 - l/(L+1)) * g_l`` with autocovariances
    normalized by n; invalid slots contribute zero.  ``lags=None`` uses
    ``L = floor(4 * (n/100)^(2/9))``; otherwise ``lags`` is a scalar or a
    tensor broadcastable over the leading axes (e.g. per-cell K).  L is
    capped at ``max_lag`` and ``n-1``; the lag loop stops at the series
    length.
    """
    n = valid.sum(dim=-1)
    dt = returns.dtype
    nf = n.clamp(min=1).to(dt)
    mean = masked_mean(returns, valid)
    u = torch.where(valid, torch.nan_to_num(returns)
                    - torch.nan_to_num(mean).unsqueeze(-1), 0.0)
    if lags is None:
        L = torch.floor(4.0 * (nf / 100.0) ** (2.0 / 9.0))
    else:
        L = torch.as_tensor(lags, device=returns.device).to(dt)
    L = torch.minimum(L.clamp(max=float(max_lag)), nf - 1.0)

    lrv = (u * u).sum(dim=-1) / nf
    for lag in range(1, max_lag + 1):
        if lag >= u.shape[-1]:
            break
        w = (1.0 - lag / (L + 1.0)).clamp(min=0.0)
        g = (u[..., lag:] * u[..., :-lag]).sum(dim=-1) / nf
        lrv = lrv + 2.0 * w * g
    se = torch.sqrt(lrv.clamp(min=0.0) / nf)
    return torch.where((n > 1) & (se > 0), mean / se, torch.nan)


def cumulative_growth(returns, valid):
    """Cumulative (1+r) product over valid entries."""
    lr = torch.where(valid, torch.log1p(returns), 0.0)
    return torch.exp(torch.cumsum(lr, dim=-1))
