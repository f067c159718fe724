"""csmom_tpu_torch: the monthly momentum replication and its J x K grid in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The module layout mirrors :mod:`csmom_tpu` (the JAX reference), so each
counterpart sits at the same path under the same name.  Importing the
package loads nothing heavy; the entry points below resolve on first use:

- :func:`run_monthly` — month-end ``Panel`` -> ``MonthlyReport``;
- :func:`run_grid` — month-end ``Panel`` -> ``GridReport`` (J x K grid).

Both run on ``device="cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""

from __future__ import annotations

_LAZY = {
    "run_monthly": "csmom_tpu_torch.backends.dispatch",
    "run_grid": "csmom_tpu_torch.backends.dispatch",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch' has no attribute {name!r}")
