"""Portfolio tearsheet: drawdown, Calmar, Sortino, hit rate, tail risk,
higher moments and per-year returns.

Counterpart of :mod:`csmom_tpu.analytics.tearsheet`.  Every statistic is a
mask-aware reduction over the LAST axis, so the same code summarizes one
spread series ``f[T]``, a J x K grid ``f[nJ, nK, T]`` or a bootstrap batch
``f[B, T]`` in one call, on the series' device.  Masked periods are absent:
compounding treats them as flat (log-growth 0), counts use the valid total,
and order statistics sort masked lanes to the type's largest value and
index by the valid count.
"""

from __future__ import annotations

import dataclasses

import torch

from csmom_tpu_torch.analytics.stats import (
    cumulative_growth,
    masked_mean,
    masked_std,
    sharpe,
)


@dataclasses.dataclass(frozen=True)
class Tearsheet:
    """All fields reduce the time axis; leading axes broadcast through."""

    ann_return: torch.Tensor      # geometric, (prod(1+r))**(f/n) - 1
    ann_vol: torch.Tensor         # std(ddof=1) * sqrt(f)
    ann_sharpe: torch.Tensor      # the reference's Sharpe
    sortino: torch.Tensor         # mean*f / (downside std * sqrt(f))
    max_drawdown: torch.Tensor    # positive fraction (0.25 = -25% peak-to-trough)
    calmar: torch.Tensor          # ann_return / max_drawdown
    hit_rate: torch.Tensor        # P(r > 0) over valid periods
    skewness: torch.Tensor        # biased (moment) estimator
    excess_kurtosis: torch.Tensor # biased, Fisher (normal -> 0)
    var_95: torch.Tensor          # 5th-percentile period return (a loss, < 0)
    cvar_95: torch.Tensor         # mean return at or below var_95
    best: torch.Tensor            # best single-period return
    worst: torch.Tensor           # worst single-period return
    n_periods: torch.Tensor       # i32 valid count


def max_drawdown(returns, valid):
    """Largest peak-to-trough loss of the compounded curve, as a positive
    fraction; masked periods compound as flat.  NaN when nothing is valid."""
    growth = cumulative_growth(returns, valid)
    # the running peak starts at the initial capital of 1.0: a curve that
    # declines from inception draws down against 1.0, not its first point
    peak = torch.cummax(growth, dim=-1).values.clamp(min=1.0)
    dd = 1.0 - growth / peak
    mdd = torch.where(valid, dd, 0.0).amax(dim=-1)
    return torch.where(valid.any(dim=-1), mdd, torch.nan)


def _moment_stats(returns, valid):
    """Biased skewness and excess kurtosis (scipy.stats.skew/kurtosis with
    bias=True), masked."""
    n = valid.sum(dim=-1)
    mean = masked_mean(returns, valid)
    dev = torch.where(valid, torch.nan_to_num(returns) - mean.unsqueeze(-1), 0.0)
    nf = n.clamp(min=1).to(returns.dtype)
    m2 = (dev ** 2).sum(dim=-1) / nf
    m3 = (dev ** 3).sum(dim=-1) / nf
    m4 = (dev ** 4).sum(dim=-1) / nf
    ok = (n > 2) & (m2 > 0)
    m2s = torch.where(m2 > 0, m2, 1.0)
    skew = torch.where(ok, m3 / m2s ** 1.5, torch.nan)
    kurt = torch.where(ok, m4 / m2s ** 2 - 3.0, torch.nan)
    return skew, kurt


def _tail_stats(returns, valid, q: float):
    """Historical VaR (the ceil(q*n)-th worst return) and CVaR (the mean of
    the returns at or below it).  Lower-tail convention: both are returns,
    so a 5% VaR of -0.02 reads 'the worst 5% of periods lose at least 2%'."""
    big = torch.finfo(returns.dtype).max
    x = torch.where(valid, torch.nan_to_num(returns), big)
    xs = torch.sort(x, dim=-1).values
    n = valid.sum(dim=-1)
    # snap q*n before the ceil: representation error (0.05*240 =
    # 12.000000000000002 in f64) would otherwise add a period to the tail
    # exactly when q*n is an integer; q*n in float64, as the reference's
    # test suite computes it
    k = torch.ceil(q * n.to(torch.float64) - 1e-6).to(torch.int64).clamp(min=1)
    idx = (k - 1).clamp(max=x.shape[-1] - 1)
    var = torch.gather(xs, -1, idx.unsqueeze(-1)).squeeze(-1)
    in_tail = torch.arange(x.shape[-1], device=x.device) < k.unsqueeze(-1)
    cvar = torch.where(in_tail, xs, 0.0).sum(dim=-1) / k.to(returns.dtype)
    ok = n > 0
    return torch.where(ok, var, torch.nan), torch.where(ok, cvar, torch.nan)


def tearsheet(returns, valid, freq_per_year: int = 12) -> Tearsheet:
    """Full tearsheet of a masked return series (last axis = time)."""
    dt = returns.dtype
    n = valid.sum(dim=-1)
    nf = n.clamp(min=1).to(dt)
    f = torch.tensor(freq_per_year, dtype=dt, device=returns.device)

    log_total = torch.where(valid, torch.log1p(returns), 0.0).sum(dim=-1)
    ann_ret = torch.where(n > 0, torch.expm1(log_total * f / nf), torch.nan)
    ann_vol = masked_std(returns, valid, ddof=1) * torch.sqrt(f)

    mean = masked_mean(returns, valid)
    down = torch.where(valid & (returns < 0), torch.nan_to_num(returns), 0.0)
    dstd = torch.sqrt((down ** 2).sum(dim=-1) / nf)
    sortino = torch.where(dstd > 0, mean * f / (dstd * torch.sqrt(f)), torch.nan)

    mdd = max_drawdown(returns, valid)
    calmar = torch.where(mdd > 0, ann_ret / mdd, torch.nan)
    hit = torch.where(n > 0, (valid & (returns > 0)).sum(dim=-1) / nf, torch.nan)
    skew, kurt = _moment_stats(returns, valid)
    var95, cvar95 = _tail_stats(returns, valid, 0.05)
    r0 = torch.nan_to_num(returns)
    best = torch.where(
        n > 0, torch.where(valid, r0, torch.finfo(dt).min).amax(dim=-1), torch.nan)
    worst = torch.where(
        n > 0, torch.where(valid, r0, torch.finfo(dt).max).amin(dim=-1), torch.nan)

    return Tearsheet(
        ann_return=ann_ret,
        ann_vol=ann_vol,
        ann_sharpe=sharpe(returns, valid, freq_per_year=freq_per_year),
        sortino=sortino,
        max_drawdown=mdd,
        calmar=calmar,
        hit_rate=hit,
        skewness=skew,
        excess_kurtosis=kurt,
        var_95=var95,
        cvar_95=cvar95,
        best=best,
        worst=worst,
        n_periods=n.to(torch.int32),
    )


def annual_returns(returns, valid, years):
    """Compound per-calendar-year returns.

    Args:
      returns: f[..., T] period returns.
      valid: bool[..., T].
      years: int[T] calendar-year label per period (need not be contiguous).

    Returns ``(uniq_years [Y], ann f[..., Y], any_valid bool[..., Y])``
    with Y the number of distinct labels, ascending; years with no valid
    period report NaN.
    """
    years = torch.as_tensor(years, device=returns.device)
    uniq = torch.unique(years)
    onehot = (years[None, :] == uniq[:, None]).to(returns.dtype)   # [Y, T]
    lr = torch.where(valid, torch.log1p(returns), 0.0)
    ann = torch.expm1(torch.einsum("...t,yt->...y", lr, onehot))
    any_valid = torch.einsum("...t,yt->...y", valid.to(returns.dtype), onehot) > 0
    return uniq, torch.where(any_valid, ann, torch.nan), any_valid


def format_tearsheet(ts: Tearsheet, label: str = "portfolio") -> str:
    """Plain-text rendering of a scalar tearsheet (the CLI's)."""
    import math

    def pct(v):
        v = float(v)
        return "n/a" if not math.isfinite(v) else f"{v * 100:+.2f}%"

    def num(v):
        v = float(v)
        return "n/a" if not math.isfinite(v) else f"{v:.2f}"

    rows = [
        ("Ann. return", pct(ts.ann_return)),
        ("Ann. vol", pct(ts.ann_vol)),
        ("Sharpe", num(ts.ann_sharpe)),
        ("Sortino", num(ts.sortino)),
        ("Max drawdown", pct(-float(ts.max_drawdown))),
        ("Calmar", num(ts.calmar)),
        ("Hit rate", pct(ts.hit_rate)),
        ("Skew", num(ts.skewness)),
        ("Excess kurtosis", num(ts.excess_kurtosis)),
        ("VaR 95 (period)", pct(ts.var_95)),
        ("CVaR 95 (period)", pct(ts.cvar_95)),
        ("Best period", pct(ts.best)),
        ("Worst period", pct(ts.worst)),
        ("Periods", str(int(ts.n_periods))),
    ]
    w = max(len(k) for k, _ in rows)
    head = f"-- tearsheet: {label} --"
    return "\n".join([head] + [f"{k:<{w}}  {v}" for k, v in rows])
