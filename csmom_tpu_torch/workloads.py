"""The port's canonical workloads: the J x K grid canon and the synthetic
month-end panels it runs on (counterpart of
:mod:`csmom_tpu.compile.workloads`).

- the **reduced grid**: 512 stocks x 3,780 days (174 months);
- the **north-star grid**: 3,000 stocks x 15,120 business days (696
  month ends), a CRSP-sized US equity universe.

Both panels come from :func:`synthetic_daily_panel` with seed 7 and
listing gaps, the reference's pack data, and are aggregated to month
ends on the device.
"""

from __future__ import annotations

import torch

from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
from csmom_tpu_torch.panel.panel import to_tensors
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

# grid parameter canon: 16 cells, J/K in {3, 6, 9, 12}, skip 1
GRID_JS = (3, 6, 9, 12)
GRID_KS = (3, 6, 9, 12)
GRID_SKIP = 1

# panel sizes (assets, business days)
REDUCED_GRID = (512, 3780)
NORTH_STAR_GRID = (3000, 15120)


def month_panel(n_assets: int, n_days: int, device=None, dtype=torch.float32):
    """Synthetic daily panel -> month-end ``(prices f[A, M], mask bool[A, M],
    month_ends datetime64[M])``, aggregated on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``)."""
    daily = synthetic_daily_panel(n_assets, n_days, seed=7, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device=device, dtype=dtype)
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    return pm, mm, ends


def north_star_month_panel(device=None, dtype=torch.float32):
    """The north-star month-end panel (3,000 x 696) on ``device``."""
    return month_panel(*NORTH_STAR_GRID, device=device, dtype=dtype)
