"""Strategy-generic monthly decile engine (both backends).

Counterpart of :mod:`csmom_tpu.strategy.engine`.  The ranking, decile
pooling and spread statistics are exactly the monthly engine's
(:func:`csmom_tpu_torch.backtest.monthly._assemble_result`, so kernel K1
on the card); only the signal comes from the plugged-in
:class:`Strategy`.  With ``strategy=Momentum(lookback=J, skip=s)`` the
result equals :func:`csmom_tpu_torch.backtest.monthly.monthly_spread_backtest`
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from csmom_tpu_torch.backtest.monthly import MonthlyResult, _assemble_result
from csmom_tpu_torch.ops.ranking import decile_assign_panel, sector_decile_assign_panel
from csmom_tpu_torch.signals.momentum import monthly_returns
from csmom_tpu_torch.strategy.base import Strategy

__all__ = ["strategy_backtest", "strategy_backtest_pandas"]


def strategy_backtest(
    prices,
    mask,
    strategy: Strategy,
    n_bins: int = 10,
    mode: str = "qcut",
    freq: int = 12,
    impl: str = "kernel",
    sector_ids=None,
    n_sectors: int | None = None,
    **panels,
) -> MonthlyResult:
    """Monthly decile backtest of a plugged-in strategy on the panel's device.

    Args:
      prices: f[A, M] month-end price tensor; mask: bool[A, M].
      strategy: a :class:`Strategy`.
      impl: 'kernel' (K1 on the card) or 'plain'.
      sector_ids / n_sectors: rank the scores within each sector
        (``sector_decile_assign_panel``; negative ids are unranked) —
        sector-neutral ranking of any signal.
      **panels: extra named panels for ``strategy.signal`` (``volumes=``,
        ``volumes_mask=``).
    """
    ret, ret_valid = monthly_returns(prices, mask)
    score, valid = strategy.signal(prices, mask, **panels)
    if sector_ids is not None:
        labels, _ = sector_decile_assign_panel(score, valid, sector_ids, n_sectors,
                                               n_bins=n_bins, mode=mode)
    else:
        labels, _ = decile_assign_panel(score, valid, n_bins=n_bins, mode=mode)
    return _assemble_result(ret, ret_valid, labels, n_bins, freq, impl=impl)


def strategy_backtest_pandas(prices_df, strategy: Strategy, n_bins: int = 10,
                             freq: int = 12, **panels):
    """The pandas engine's run of the same strategy: its scores are
    evaluated on the CPU in float64 (extra panels, arrays or tensors on any
    device, are brought there) and handed to the pandas ranking and
    portfolio tail
    (:func:`csmom_tpu_torch.backends.pandas_engine.spread_from_scores_pandas`),
    so one strategy definition serves both backends."""
    import pandas as pd

    from csmom_tpu_torch.backends.pandas_engine import spread_from_scores_pandas

    values = prices_df.to_numpy(dtype=np.float64, copy=True)
    mask = np.isfinite(values)
    score, valid = strategy.signal(
        torch.as_tensor(values), torch.as_tensor(mask),
        **{k: (torch.as_tensor(v).cpu() if v is not None else None)
           for k, v in panels.items()})
    score = np.where(valid.numpy(), score.numpy(), np.nan)
    score_df = pd.DataFrame(score, index=prices_df.index, columns=prices_df.columns)
    return spread_from_scores_pandas(prices_df, score_df, n_bins=n_bins, freq=freq)
