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


def golden_event_inputs(dtype=torch.float64, device=None):
    """Dense minute panels for the event engine at the reference's
    golden event shape (counterpart of
    :func:`csmom_tpu.compile.workloads.golden_event_inputs`): the
    synthesized same-shape stand-in for its 20-ticker minute panel, 20
    tickers x 7 days x 390 minutes from ``synthetic_daily_panel(20, 7,
    seed=0)`` with the default risk maps, run through the ridge pipeline
    on ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``).

    Returns ``(price, valid, score, adv, vol, n_trades)`` — the argument
    set of the headline ``event_backtest`` call and its trade count.
    """
    import numpy as np
    import pandas as pd

    from csmom_tpu_torch.api import daily_risk_maps, intraday_pipeline, synthetic_minute_frame

    daily = synthetic_daily_panel(20, 7, seed=0)
    minute_df = synthetic_minute_frame(pd.DataFrame({
        "date": np.repeat(daily.times, 20),
        "ticker": np.tile(daily.tickers, 7),
        "open": daily.values.T.ravel(),
        "close": daily.values.T.ravel(),
        "volume": 1e6,
    }))
    res, _, compact, dense_score, dense_price, dense_valid = intraday_pipeline(
        minute_df, None, dtype=dtype, device=device)
    adv, vol = daily_risk_maps(None, compact.tickers)
    dev = dense_price.device
    return (dense_price, dense_valid, torch.nan_to_num(dense_score),
            torch.as_tensor(adv, dtype=dtype).to(dev),
            torch.as_tensor(vol, dtype=dtype).to(dev), int(res.n_trades))
