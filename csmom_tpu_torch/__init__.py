"""csmom_tpu_torch: the monthly momentum replication, its J x K grid and
their costs and inference (sector-neutral ranking, turnover netting,
walk-forward selection, block-bootstrap CIs, banded rebalancing,
tearsheets), the Strategy plugins, the volume double sort, event-time
horizon profiles and residual momentum in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100, fed from CSV caches or packed panels; the
intraday leg (minute features, five score models and the event engines,
:func:`csmom_tpu_torch.api.intraday_pipeline`); and the ``csmom`` command
line (``python -m csmom_tpu_torch.cli``).

The module layout mirrors :mod:`csmom_tpu` (the JAX reference), so each
counterpart sits at the same path under the same name.  Importing the
package loads nothing heavy; the entry points below resolve on first use:

- :func:`run_monthly` — month-end ``Panel`` -> ``MonthlyReport``
  (``sector_ids=``/``n_sectors=`` for sector-neutral ranking);
- :func:`run_grid` — month-end ``Panel`` -> ``GridReport`` (J x K grid;
  ``mode="hist"``, ``impl="matmul"``/``"matmul_bf16"``);
- :func:`monthly_price_panel` — a CSV cache directory or a pack ->
  month-end ``(prices, volume)`` Panels, aggregated on the device;
- :func:`load_config` — a TOML file -> ``RunConfig``;
- :func:`load_packed` — a packed directory -> memmapped Panels.

The three that compute run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""

from __future__ import annotations

__version__ = "0.1.0"

_LAZY = {
    "run_monthly": "csmom_tpu_torch.backends.dispatch",
    "run_grid": "csmom_tpu_torch.backends.dispatch",
    "monthly_price_panel": "csmom_tpu_torch.api",
    "load_config": "csmom_tpu_torch.config",
    "load_packed": "csmom_tpu_torch.panel.pack",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch' has no attribute {name!r}")
