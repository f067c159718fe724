"""Signal engineering over masked panels: momentum, residual momentum,
turnover (the exports of :mod:`csmom_tpu.signals`).

The names resolve on first use, so importing the package loads neither
torch nor pandas.  Reach the submodule ``momentum`` through
``importlib.import_module``: its package attribute is the function.
"""

from __future__ import annotations

import sys
import types

_LAZY = {
    "formation_listed_mask": "csmom_tpu_torch.signals.momentum",
    "monthly_returns": "csmom_tpu_torch.signals.momentum",
    "momentum": "csmom_tpu_torch.signals.momentum",
    "momentum_dynamic": "csmom_tpu_torch.signals.momentum",
    "padded_prices": "csmom_tpu_torch.signals.momentum",
    "raw_monthly_returns": "csmom_tpu_torch.signals.momentum",
    "residual_momentum": "csmom_tpu_torch.signals.residual",
    "residual_momentum_sweep": "csmom_tpu_torch.signals.residual",
    "residual_sweep_backtest": "csmom_tpu_torch.signals.residual",
    "turnover_features": "csmom_tpu_torch.signals.turnover",
    "shares_outstanding_vector": "csmom_tpu_torch.signals.turnover",
    "volume_tercile_labels": "csmom_tpu_torch.signals.turnover",
}

__all__ = list(_LAZY)


class _Package(types.ModuleType):
    """``momentum`` names a submodule and the function it exports; the
    package's attribute is the function, as in csmom_tpu, whichever is
    imported first.  The import system binds a loaded submodule on its
    package; that binding is refused for an exported name."""

    def __setattr__(self, name, value):
        if name in _LAZY and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.signals' has no attribute {name!r}")
