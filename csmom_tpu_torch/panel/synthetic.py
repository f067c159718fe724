"""Seeded synthetic daily panel: a copy of
:func:`csmom_tpu.panel.synthetic.synthetic_daily_panel`, bit-identical
for the same arguments (same numpy stream, same arithmetic), so the port
and the reference run on the same data."""

from __future__ import annotations

import numpy as np

from csmom_tpu_torch.panel.panel import Panel


def synthetic_daily_panel(
    n_assets: int,
    n_days: int,
    seed: int = 0,
    start: str = "1963-07-01",
    annual_vol_range=(0.15, 0.60),
    annual_drift_range=(-0.05, 0.15),
    listing_gaps: bool = False,
) -> Panel:
    """Geometric-Brownian daily close panel with business-day timestamps.

    With ``listing_gaps`` a third of the assets list late and a third
    delist early (masked lanes, NaN values)."""
    rng = np.random.default_rng(seed)
    vol = rng.uniform(*annual_vol_range, size=(n_assets, 1)) / np.sqrt(252.0)
    drift = rng.uniform(*annual_drift_range, size=(n_assets, 1)) / 252.0
    shocks = rng.standard_normal((n_assets, n_days)).astype(np.float64)
    log_prices = np.cumsum(drift + vol * shocks, axis=1)
    prices = 30.0 * np.exp(log_prices - log_prices[:, :1])

    mask = np.ones_like(prices, dtype=bool)
    if listing_gaps:
        third = n_assets // 3
        starts = rng.integers(0, n_days // 2, size=third)
        ends = rng.integers(n_days // 2, n_days, size=third)
        for i, s in enumerate(starts):
            mask[i, :s] = False
        for i, e in enumerate(ends):
            mask[third + i, e:] = False
        prices = np.where(mask, prices, np.nan)

    # business-day-ish calendar: skip Sat/Sun
    start_d = np.datetime64(start, "D")
    all_days = np.arange(start_d, start_d + np.timedelta64(n_days * 2, "D"))
    dow = (all_days.astype("datetime64[D]").view("int64") + 4) % 7
    bdays = all_days[dow < 5][:n_days]
    return Panel(values=prices, mask=mask,
                 tickers=tuple(f"S{i:05d}" for i in range(n_assets)),
                 times=bdays.astype("datetime64[ns]"), name="synthetic_close")
