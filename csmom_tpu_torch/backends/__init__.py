"""Engine backends behind one API: ``run_monthly`` dispatches to the torch
engine or the pandas engine (the exports of :mod:`csmom_tpu.backends`).

The names resolve on first use, so importing the package loads neither
torch nor pandas.
"""

from __future__ import annotations

_LAZY = {
    "run_monthly": "csmom_tpu_torch.backends.dispatch",
    "MonthlyReport": "csmom_tpu_torch.backends.dispatch",
    "monthly_spread_backtest_pandas": "csmom_tpu_torch.backends.pandas_engine",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.backends' has no attribute {name!r}")
