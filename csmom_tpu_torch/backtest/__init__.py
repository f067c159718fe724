"""Backtest engines: the monthly decile engine, the J x K grid, banded
books, horizons, double sorts, walk-forward selection and the event
engine (the exports of :mod:`csmom_tpu.backtest`).

The names resolve on first use, so importing the package loads neither
torch nor pandas.
"""

from __future__ import annotations

_LAZY = {
    "BandedResult": "csmom_tpu_torch.backtest.banded",
    "banded_books": "csmom_tpu_torch.backtest.banded",
    "banded_monthly_backtest": "csmom_tpu_torch.backtest.banded",
    "monthly_spread_backtest": "csmom_tpu_torch.backtest.monthly",
    "net_of_costs": "csmom_tpu_torch.backtest.monthly",
    "net_of_costs_arrays": "csmom_tpu_torch.backtest.monthly",
    "sector_neutral_backtest": "csmom_tpu_torch.backtest.monthly",
    "MonthlyResult": "csmom_tpu_torch.backtest.monthly",
    "jk_grid_backtest": "csmom_tpu_torch.backtest.grid",
    "grid_break_even_bps": "csmom_tpu_torch.backtest.grid",
    "grid_net_of_costs": "csmom_tpu_torch.backtest.grid",
    "GridResult": "csmom_tpu_torch.backtest.grid",
    "horizon_profile": "csmom_tpu_torch.backtest.horizon",
    "HorizonProfile": "csmom_tpu_torch.backtest.horizon",
    "volume_horizon_profile": "csmom_tpu_torch.backtest.horizon",
    "VolumeHorizonProfile": "csmom_tpu_torch.backtest.horizon",
    "volume_double_sort": "csmom_tpu_torch.backtest.double_sort",
    "DoubleSortResult": "csmom_tpu_torch.backtest.double_sort",
    "walk_forward_select": "csmom_tpu_torch.backtest.walkforward",
    "walk_forward_grid_backtest": "csmom_tpu_torch.backtest.walkforward",
    "WalkForwardResult": "csmom_tpu_torch.backtest.walkforward",
    "CostAttribution": "csmom_tpu_torch.backtest.event",
    "EventResult": "csmom_tpu_torch.backtest.event",
    "cost_attribution": "csmom_tpu_torch.backtest.event",
    "event_backtest": "csmom_tpu_torch.backtest.event",
    "hysteresis_event_backtest": "csmom_tpu_torch.backtest.event",
    "threshold_sweep": "csmom_tpu_torch.backtest.event",
    "trades_dataframe": "csmom_tpu_torch.backtest.event",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.backtest' has no attribute {name!r}")
