"""Seeded synthetic market data: copies of
:func:`csmom_tpu.panel.synthetic.synthetic_daily_panel` and
:func:`~csmom_tpu.panel.synthetic.synthetic_minute_bars`, bit-identical
for the same arguments (same numpy stream, same arithmetic), so the port
and the reference run on the same data."""

from __future__ import annotations

import numpy as np

from csmom_tpu_torch.panel.panel import Panel

# bumped with the reference's whenever a generator's output changes for the
# same (shape, seed): disk caches of synthesized panels key on it
SYNTH_VERSION = 1


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


def synthetic_minute_bars(
    open_p: np.ndarray,
    close_p: np.ndarray,
    day_volume: np.ndarray,
    minutes_per_day: int = 390,
    noise: float = 0.0005,
    seed: int = 0,
):
    """Minute price/volume paths for a block of (asset, day) bars, the
    reference demo's synthetic intraday fallback without its loop: price
    path = linspace(open, close) * (1 + N(0, noise)); volume = a sin^2
    U-curve + 0.1, normalized, scaled to the day's volume, floored to int.

    Args:
      open_p, close_p, day_volume: f[A, D] daily panels.

    Returns:
      (prices f[A, D, T], volumes i64[A, D, T]) with T = minutes_per_day.
    """
    rng = np.random.default_rng(seed)
    A, D = open_p.shape
    T = minutes_per_day
    frac = np.linspace(0.0, 1.0, T)
    path = open_p[..., None] + (close_p - open_p)[..., None] * frac
    path = path * (1.0 + rng.normal(0.0, noise, size=(A, D, T)))

    base = np.sin(np.linspace(0.0, np.pi, T)) ** 2 + 0.1
    base = base / base.sum()
    vols = np.maximum(day_volume, 1.0)[..., None] * base
    return path, vols.astype(np.int64)
