"""Performance analytics: Sharpe, t-stats, bootstrap CIs, tearsheets (the
exports of :mod:`csmom_tpu.analytics`).

The names resolve on first use, so importing the package loads neither
torch nor pandas.  Reach the submodule ``tearsheet`` through
``importlib.import_module``: its package attribute is the function.
"""

from __future__ import annotations

import sys
import types

_LAZY = {
    "sharpe": "csmom_tpu_torch.analytics.stats",
    "rolling_sharpe": "csmom_tpu_torch.analytics.stats",
    "vol_managed": "csmom_tpu_torch.analytics.stats",
    "masked_mean": "csmom_tpu_torch.analytics.stats",
    "masked_std": "csmom_tpu_torch.analytics.stats",
    "t_stat": "csmom_tpu_torch.analytics.stats",
    "nw_t_stat": "csmom_tpu_torch.analytics.stats",
    "block_bootstrap": "csmom_tpu_torch.analytics.bootstrap",
    "block_bootstrap_grid": "csmom_tpu_torch.analytics.bootstrap",
    "circular_block_indices": "csmom_tpu_torch.analytics.bootstrap",
    "BootstrapResult": "csmom_tpu_torch.analytics.bootstrap",
    "Tearsheet": "csmom_tpu_torch.analytics.tearsheet",
    "annual_returns": "csmom_tpu_torch.analytics.tearsheet",
    "format_tearsheet": "csmom_tpu_torch.analytics.tearsheet",
    "max_drawdown": "csmom_tpu_torch.analytics.tearsheet",
    "tearsheet": "csmom_tpu_torch.analytics.tearsheet",
}

__all__ = list(_LAZY)


class _Package(types.ModuleType):
    """``tearsheet`` names a submodule and the function it exports; the
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
    raise AttributeError(f"module 'csmom_tpu_torch.analytics' has no attribute {name!r}")
