"""Core ops over masked panels: rolling windows and cross-sectional
ranking (the exports of :mod:`csmom_tpu.ops`).  The hand kernels and
their build live in :mod:`~csmom_tpu_torch.ops.kernels` and
:mod:`~csmom_tpu_torch.ops.build`.

The names resolve on first use, so importing the package loads neither
torch nor pandas.
"""

from __future__ import annotations

_LAZY = {
    "rolling_sum": "csmom_tpu_torch.ops.rolling",
    "rolling_mean": "csmom_tpu_torch.ops.rolling",
    "rolling_std": "csmom_tpu_torch.ops.rolling",
    "rolling_count": "csmom_tpu_torch.ops.rolling",
    "decile_assign": "csmom_tpu_torch.ops.ranking",
    "decile_assign_panel": "csmom_tpu_torch.ops.ranking",
    "sector_decile_assign": "csmom_tpu_torch.ops.ranking",
    "sector_decile_assign_panel": "csmom_tpu_torch.ops.ranking",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.ops' has no attribute {name!r}")
