"""A seeded synthetic stand-in for the reference's 20-ticker data directory.

The data-dir examples read ``<T>_daily.csv`` and ``<T>_intraday.csv`` for
the reference universe's tickers (``config.DEFAULT_TICKERS``).
:func:`write_data_dir` writes such a directory from the synthetic
generators, in the reference caches' dialects: the daily bars in the
plain one (``date,open,high,low,close,adj_close,volume``) but AAPL's in
the second (a price/ticker/date header block), which the reference's
loader loses, as it loses the real AAPL cache; the minute bars of the
last ``minute_days`` days as ``datetime,open,high,low,close,volume``.
Its numbers are not the reference data's, so an example's assert on a
golden value of that data fails on it, at the same line in both
packages.  Host-only (numpy and pandas); a private helper of the
examples' tests and of ``chip_smoke.py``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["write_data_dir"]


def write_data_dir(out_dir: str, n_days: int = 1764, minute_days: int = 2,
                   seed: int = 0) -> list:
    """Write the 20 tickers' daily and intraday CSVs under ``out_dir``;
    returns the tickers.  ``n_days`` business days of daily bars (7
    years by default) and 390 one-minute bars a day for the last
    ``minute_days`` of them."""
    import pandas as pd

    from csmom_tpu_torch.api import synthetic_minute_frame
    from csmom_tpu_torch.config import DEFAULT_TICKERS
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    tickers = list(DEFAULT_TICKERS)
    os.makedirs(out_dir, exist_ok=True)
    daily = synthetic_daily_panel(len(tickers), n_days, seed=seed)
    stamps = pd.DatetimeIndex(daily.times).strftime("%Y-%m-%d")
    rng = np.random.default_rng(seed + 1)
    for i, t in enumerate(tickers):
        c = daily.values[i]
        vol = rng.integers(200_000, 5_000_000, len(c))
        path = os.path.join(out_dir, f"{t}_daily.csv")
        if t == "AAPL":
            rows = "\n".join(f"{d},{x:.6f},{x * 1.01:.6f},{x * 0.99:.6f},"
                             f"{x * 0.998:.6f},{n}"
                             for d, x, n in zip(stamps, c, vol))
            with open(path, "w") as f:
                f.write(f"Price,Close,High,Low,Open,Volume\n"
                        f"Ticker,{t},{t},{t},{t},{t}\nDate,,,,,\n{rows}\n")
        else:
            pd.DataFrame({"date": stamps, "open": c * 0.998, "high": c * 1.01,
                          "low": c * 0.99, "close": c, "adj_close": c,
                          "volume": vol}).to_csv(path, index=False,
                                                 float_format="%.6f")
    last = slice(n_days - minute_days, n_days)
    frame = pd.DataFrame({
        "date": np.repeat(daily.times[last], len(tickers)),
        "ticker": np.tile(tickers, minute_days),
        "open": daily.values[:, last].T.ravel() * 0.998,
        "close": daily.values[:, last].T.ravel(),
        "volume": 1e6,
    })
    minutes = synthetic_minute_frame(frame, seed=seed + 2)
    for t, g in minutes.groupby("ticker"):
        pd.DataFrame({"datetime": g["datetime"].dt.strftime("%Y-%m-%d %H:%M:%S"),
                      "open": g["price"], "high": g["price"], "low": g["price"],
                      "close": g["price"], "volume": g["volume"]}).to_csv(
            os.path.join(out_dir, f"{t}_intraday.csv"), index=False)
    return tickers
