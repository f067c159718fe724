"""Execution cost models: market impact, fills, turnover costs (the
exports of :mod:`csmom_tpu.costs`).

The names resolve on first use, so importing the package loads neither
torch nor pandas.
"""

from __future__ import annotations

_LAZY = {
    "square_root_impact": "csmom_tpu_torch.costs.impact",
    "market_fill": "csmom_tpu_torch.costs.impact",
    "limit_fill": "csmom_tpu_torch.costs.impact",
    "long_short_weights": "csmom_tpu_torch.costs.impact",
    "turnover_cost": "csmom_tpu_torch.costs.impact",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.costs' has no attribute {name!r}")
