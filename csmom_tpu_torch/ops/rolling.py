"""Masked rolling-window reductions along the time axis.

Counterpart of :mod:`csmom_tpu.ops.rolling`: pandas' NaN-skipping trailing
windows (``rolling(w, min_periods).sum/mean/std``) from prefix-sum
differences, O(T) for any window.  Every function takes ``x[..., T]`` and
``valid[..., T]`` and returns ``(value[..., T], out_valid[..., T])`` with
NaN outside ``out_valid``; the window at t covers ``[t-window+1, t]``
clipped to the series start.
"""

from __future__ import annotations

import torch


def _windowed_prefix_diff(x, window: int):
    """Sum of ``x`` over the trailing window via padded inclusive prefix sums."""
    c = torch.cumsum(x, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)  # c[t+1] = sum x[:t+1]
    T = x.shape[-1]
    lo = (torch.arange(T, device=x.device) + 1 - window).clamp(min=0)
    return c[..., 1:] - c[..., lo]


def rolling_count(valid, window: int, min_periods: int = 1):
    """Number of valid observations in each trailing window."""
    return _windowed_prefix_diff(valid.to(torch.int32), window)


def _filled_sums(x, valid, window: int):
    filled = torch.where(valid, torch.nan_to_num(x), 0.0)
    return (_windowed_prefix_diff(filled, window),
            _windowed_prefix_diff(valid.to(filled.dtype), window))


def rolling_sum(x, valid, window: int, min_periods: int = 1):
    """NaN-skipping rolling sum (pandas ``rolling(w, min_periods).sum()``)."""
    s, n = _filled_sums(x, valid, window)
    out_valid = n >= min_periods
    return torch.where(out_valid, s, torch.nan), out_valid


def rolling_mean(x, valid, window: int, min_periods: int = 1):
    """NaN-skipping rolling mean."""
    s, n = _filled_sums(x, valid, window)
    out_valid = n >= min_periods
    return torch.where(out_valid, s / n.clamp(min=1), torch.nan), out_valid


def rolling_std(x, valid, window: int, min_periods: int = 1, ddof: int = 1):
    """NaN-skipping rolling standard deviation.

    The prefix sums of squares are taken after centering each series on its
    global valid mean: a no-op for the variance, but it keeps float32 from
    cancelling catastrophically on large raw values (volumes near 1e8).
    """
    filled = torch.where(valid, torch.nan_to_num(x), 0.0)
    n_total = valid.sum(dim=-1, keepdim=True).clamp(min=1)
    center = filled.sum(dim=-1, keepdim=True) / n_total
    xc = torch.where(valid, filled - center, 0.0)

    s1 = _windowed_prefix_diff(xc, window)
    s2 = _windowed_prefix_diff(xc * xc, window)
    n = _windowed_prefix_diff(valid.to(filled.dtype), window)

    out_valid = (n >= min_periods) & (n > ddof)
    var = (s2 - s1 * s1 / n.clamp(min=1)) / (n - ddof).clamp(min=1)
    var = var.clamp(min=0.0)  # tiny negative rounding residue
    return torch.where(out_valid, torch.sqrt(var), torch.nan), out_valid
