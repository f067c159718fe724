"""Plain reference of the per-minute event backtest, in PyTorch on the CPU.

Both engines of the program are worked out again from the minute panels
the benchmark made: order sides (a threshold rule, or a Schmitt trigger
stepped minute by minute), square-root impact fills, share positions, the
cash ledger, the forward-filled mark, portfolio value, the per-bar PnL
over bar timestamps, trade counts and the cost attribution of market
orders at zero latency.

``dtype`` is the precision of every price, cash and cost quantity:
float64 for the reference, bfloat16 for the control.  Scores are compared
with the thresholds at the panel's own precision (the configuration's
float32), or at ``dtype`` where that is lower.  It imports nothing of the
program.
"""

from __future__ import annotations

import torch


def _decision_dtype(score_dtype, dtype):
    return dtype if torch.finfo(dtype).bits < torch.finfo(score_dtype).bits \
        else score_dtype


def threshold_units(valid, score, threshold, dtype):
    """+1 / -1 where the score is strictly above ``threshold`` / below
    ``-threshold`` at a bar, else 0."""
    dd = _decision_dtype(score.dtype, dtype)
    s = score.to(dd)
    thr = torch.tensor(threshold, dtype=dd)
    return (valid & (s > thr)).to(torch.int64) - (valid & (s < -thr)).to(torch.int64)


def hysteresis_units(valid, score, threshold_hi, threshold_lo, dtype):
    """The change of a per-name state stepped minute by minute: at a bar,
    +1 above ``threshold_hi``, -1 below ``-threshold_hi``, 0 inside
    ``threshold_lo``, else the state holds; flat before the first bar."""
    dd = _decision_dtype(score.dtype, dtype)
    s = score.to(dd)
    hi = torch.tensor(threshold_hi, dtype=dd)
    lo = torch.tensor(threshold_lo, dtype=dd)
    A, T = s.shape
    state = torch.zeros(A, dtype=torch.int64)
    units = torch.zeros((A, T), dtype=torch.int64)
    long_, short_ = valid & (s > hi), valid & (s < -hi)
    flat_ = valid & (s.abs() < lo)
    for t in range(T):
        new = torch.where(long_[:, t], 1, torch.where(
            short_[:, t], -1, torch.where(flat_[:, t], 0, state)))
        units[:, t] = new - state
        state = new
    return units


def backtest(price, valid, score, adv, vol, engine: str, params: dict,
             size_shares: int, cash0: float, spread: float,
             dtype=torch.float64):
    """One event backtest of ``engine`` (``"threshold"`` or
    ``"hysteresis"``) on CPU tensors.

    Returns a dict: ``units`` i64[A, T] (signed trade units), ``positions``
    i64[A, T], ``fill`` [A, T] (0 where no trade), ``pnl`` [T],
    ``total_pnl``, ``n_trades``, ``n_buys``, ``n_sells``, ``net_notional``,
    ``total_cost``, ``spread_cost``, ``impact_cost``, ``gross_notional``,
    in ``dtype``, counts as Python ints.
    """
    if engine == "threshold":
        units = threshold_units(valid, score, params["threshold"], dtype)
    elif engine == "hysteresis":
        units = hysteresis_units(valid, score, params["threshold_hi"],
                                 params["threshold_lo"], dtype)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    A, T = price.shape
    p = torch.nan_to_num(price.to(dtype))
    size = torch.tensor(float(size_shares), dtype=dtype)
    adv_d, vol_d = adv.to(dtype), vol.to(dtype)
    impact = torch.where(adv_d > 0, 0.1 * vol_d * torch.sqrt(
        size / torch.where(adv_d > 0, adv_d, 1.0)), 0.0)          # [A]

    traded = units != 0
    direction = torch.sign(units).to(dtype)
    fill = torch.where(traded, p * (1.0 + direction * (spread / 2.0 + impact[:, None])), 0.0)
    shares = units * size_shares
    positions = torch.cumsum(shares, dim=1)
    flow = (fill * shares.to(dtype)).sum(dim=0)                    # [T]
    cash = cash0 - torch.cumsum(flow, dim=0)

    # mark: the last bar's price at or before each minute, 0 before any
    mark = torch.zeros((A, T), dtype=dtype)
    cur = torch.zeros(A, dtype=dtype)
    for t in range(T):
        cur = torch.where(valid[:, t], p[:, t], cur)
        mark[:, t] = cur
    pv = cash + (positions.to(dtype) * mark).sum(dim=0)

    # per-bar PnL: value change since the previous minute with a bar
    bars = valid.any(dim=0)
    pnl = torch.zeros(T, dtype=dtype)
    bar_idx = torch.nonzero(bars).flatten()
    pnl[bar_idx[1:]] = pv[bar_idx[1:]] - pv[bar_idx[:-1]]

    units_abs = units.abs().to(dtype)
    mid = torch.where(traded, p, 0.0)
    return {
        "units": units,
        "positions": positions,
        "fill": fill,
        "pnl": pnl,
        "total_pnl": pnl.sum(),
        "n_trades": int(traded.sum()),
        "n_buys": int((units > 0).sum()),
        "n_sells": int((units < 0).sum()),
        "net_notional": flow.sum(),
        "total_cost": ((fill - mid) * units.to(dtype)).sum() * size,
        "spread_cost": (mid * units_abs).sum() * (spread / 2.0) * size,
        "impact_cost": (mid * impact[:, None] * units_abs).sum() * size,
        "gross_notional": (mid * units_abs).sum() * size,
    }
