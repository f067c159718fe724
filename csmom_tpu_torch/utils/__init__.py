"""Cross-cutting utilities: logging, timing and profiling, numerical
guards, clocks and deadlines.

Counterpart of ``csmom_tpu.utils``.  The names resolve on first use, so
importing the package loads neither torch nor pandas.
"""

from __future__ import annotations

_LAZY = {
    "get_logger": "csmom_tpu_torch.utils.logging",
    "fetch": "csmom_tpu_torch.utils.profiling",
    "measure_rtt": "csmom_tpu_torch.utils.profiling",
    "wall": "csmom_tpu_torch.utils.profiling",
    "trace": "csmom_tpu_torch.utils.profiling",
    "validate_panel": "csmom_tpu_torch.utils.guards",
    "checked": "csmom_tpu_torch.utils.guards",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.utils' has no attribute {name!r}")
