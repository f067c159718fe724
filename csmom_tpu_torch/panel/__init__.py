"""Masked dense panels: ingest, packs, fetch, calendars, containers and
synthetic generators (the exports of :mod:`csmom_tpu.panel`).

The names resolve on first use, so importing one submodule (the calendar,
say) does not load pandas or the CSV parser.
"""

from __future__ import annotations

_LAZY = {
    "Panel": "csmom_tpu_torch.panel.panel",
    "read_price_csv": "csmom_tpu_torch.panel.ingest",
    "load_daily": "csmom_tpu_torch.panel.ingest",
    "load_intraday": "csmom_tpu_torch.panel.ingest",
    "long_to_panel": "csmom_tpu_torch.panel.ingest",
    "month_end_segments": "csmom_tpu_torch.panel.calendar",
    "month_end_aggregate": "csmom_tpu_torch.panel.calendar",
    "save_packed": "csmom_tpu_torch.panel.pack",
    "load_packed": "csmom_tpu_torch.panel.pack",
    "pack_csv_cache": "csmom_tpu_torch.panel.pack",
    "fetch_daily": "csmom_tpu_torch.panel.fetch",
    "fetch_intraday": "csmom_tpu_torch.panel.fetch",
    "get_shares_info": "csmom_tpu_torch.panel.fetch",
    "cache_path": "csmom_tpu_torch.panel.fetch",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'csmom_tpu_torch.panel' has no attribute {name!r}")
