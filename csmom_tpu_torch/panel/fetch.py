"""Network fetch and write-once CSV cache (the live-data path).

A copy of :mod:`csmom_tpu.panel.fetch`: a per-ticker download with a CSV
cache in ``data_dir``, per-ticker fault isolation (a failing name is
skipped with a warning), ``force_refresh`` to bust the cache, and a
``get_shares_info`` metadata fetch.  Caches are written in the canonical
long schema behind a ``# csmom-cache-v1`` marker line and re-read through
the dialect-tolerant reader, so a cache always round-trips, and a cache
that parses to no rows raises instead of returning none.  The network
backend is injectable: ``yfinance`` is optional (imported only by the
default fetchers, which raise a clear error without it), and callers pass
any ``fetcher(ticker, ...) -> DataFrame`` for tests or other vendors.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Mapping, Sequence

import pandas as pd

from csmom_tpu_torch.panel.ingest import (
    DAILY_SCHEMA,
    INTRADAY_SCHEMA,
    read_price_csv,
)

log = logging.getLogger(__name__)

CACHE_VERSION = "csmom-cache-v1"


def cache_path(data_dir: str, ticker: str, kind: str) -> str:
    """``<data_dir>/<TICKER>_<kind>.csv`` — the reference demo's layout, so
    its shipped ``data/`` directory is a valid cache for this fetcher."""
    return os.path.join(data_dir, f"{ticker}_{kind}.csv")


def _default_daily_fetcher(ticker: str, start: str, end: str) -> pd.DataFrame:
    try:
        import yfinance as yf  # optional; absent in this image
    except ImportError as e:  # pragma: no cover - exercised via injection
        raise RuntimeError(
            f"no cache for {ticker} and yfinance is not installed; pass "
            "fetcher= or pre-populate the cache directory"
        ) from e
    return yf.download(ticker, start=start, end=end, progress=False,
                       auto_adjust=False)  # pragma: no cover


def _default_intraday_fetcher(ticker: str, period: str, interval: str) -> pd.DataFrame:
    try:
        import yfinance as yf
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"no cache for {ticker} and yfinance is not installed; pass "
            "fetcher= or pre-populate the cache directory"
        ) from e
    return yf.download(ticker, period=period, interval=interval,
                       progress=False, auto_adjust=False)  # pragma: no cover


def _normalize_vendor_daily(df: pd.DataFrame, ticker: str) -> pd.DataFrame:
    """Vendor frame (datetime index, title-case columns, possibly MultiIndex)
    -> canonical daily long schema."""
    if df is None or len(df) == 0:
        return pd.DataFrame(columns=DAILY_SCHEMA)
    out = df.copy()
    if isinstance(out.columns, pd.MultiIndex):
        out.columns = [c[0] for c in out.columns]
    out.columns = [str(c).strip().lower().replace(" ", "_") for c in out.columns]
    out = out.reset_index()
    tcol = out.columns[0]
    res = pd.DataFrame({"date": pd.to_datetime(out[tcol], errors="coerce")})
    res["ticker"] = ticker
    for col in ("open", "high", "low", "close", "adj_close", "volume"):
        res[col] = pd.to_numeric(out.get(col), errors="coerce")
    if "adj_close" not in out.columns or res["adj_close"].isna().all():
        res["adj_close"] = res["close"]
    return res.dropna(subset=["date"])[DAILY_SCHEMA]


def _normalize_vendor_intraday(df: pd.DataFrame, ticker: str) -> pd.DataFrame:
    if df is None or len(df) == 0:
        return pd.DataFrame(columns=INTRADAY_SCHEMA)
    out = df.copy()
    if isinstance(out.columns, pd.MultiIndex):
        out.columns = [c[0] for c in out.columns]
    out.columns = [str(c).strip().lower().replace(" ", "_") for c in out.columns]
    out = out.reset_index()
    tcol = out.columns[0]
    res = pd.DataFrame({"datetime": pd.to_datetime(out[tcol], errors="coerce")})
    res["ticker"] = ticker
    price = out.get("close", out.get("price"))
    res["price"] = pd.to_numeric(price, errors="coerce")
    res["volume"] = pd.to_numeric(out.get("volume"), errors="coerce")
    return res.dropna(subset=["datetime"])[INTRADAY_SCHEMA]


def _write_cache(df: pd.DataFrame, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# {CACHE_VERSION}\n")
        df.drop(columns=["ticker"]).to_csv(f, index=False)


def _read_cache(path: str, ticker: str, kind: str) -> pd.DataFrame:
    """Read either our versioned cache or a reference-dialect cache; raise
    (not empty) when a present file yields zero rows — loud beats silent."""
    with open(path) as f:
        first = f.readline()
    skip = 1 if first.startswith(f"# {CACHE_VERSION}") else 0
    if skip:
        df = pd.read_csv(path, skiprows=1)
        time_col = "date" if kind == "daily" else "datetime"
        df[time_col] = pd.to_datetime(df[time_col])
        df["ticker"] = ticker
        schema = DAILY_SCHEMA if kind == "daily" else INTRADAY_SCHEMA
        df = df[schema]
    else:
        df = read_price_csv(path, ticker, kind=kind)
    if len(df) == 0:
        raise ValueError(
            f"cache {path} parsed to 0 rows — corrupt or unknown dialect "
            "(refusing to silently drop the ticker; delete the file or pass "
            "force_refresh=True)"
        )
    return df


def _fetch_universe(
    tickers: Sequence[str],
    kind: str,
    data_dir: str,
    force_refresh: bool,
    fetch_one: Callable[[str], pd.DataFrame],
    normalize: Callable[[pd.DataFrame, str], pd.DataFrame],
    schema: Sequence[str],
    time_col: str,
) -> pd.DataFrame:
    frames = []
    for t in tickers:
        path = cache_path(data_dir, t, kind)
        try:
            if os.path.exists(path) and not force_refresh:
                df = _read_cache(path, t, kind)
            else:
                df = normalize(fetch_one(t), t)
                if len(df):
                    _write_cache(df, path)
                else:
                    log.warning("%s: fetch returned no rows; skipping", t)
                    continue
            frames.append(df)
        except Exception as e:  # per-ticker fault isolation
            log.warning("%s: %s (skipped)", t, e)
    if not frames:
        return pd.DataFrame(columns=schema)
    return pd.concat(frames, ignore_index=True).sort_values(
        [time_col, "ticker"], kind="stable"
    ).reset_index(drop=True)


def fetch_daily(
    tickers: Sequence[str],
    start: str = "2018-01-01",
    end: str = "2024-12-31",
    data_dir: str = "data",
    force_refresh: bool = False,
    fetcher: Callable[..., pd.DataFrame] | None = None,
) -> pd.DataFrame:
    """Daily bars for a universe, cache-first.

    ``fetcher(ticker, start, end)`` returns a vendor frame (yfinance-shaped:
    datetime index, OHLCV columns); default requires yfinance.
    """
    fetch = fetcher or _default_daily_fetcher
    return _fetch_universe(
        tickers, "daily", data_dir, force_refresh,
        lambda t: fetch(t, start, end), _normalize_vendor_daily,
        DAILY_SCHEMA, "date",
    )


def fetch_intraday(
    tickers: Sequence[str],
    period: str = "7d",
    interval: str = "1m",
    data_dir: str = "data",
    force_refresh: bool = False,
    fetcher: Callable[..., pd.DataFrame] | None = None,
) -> pd.DataFrame:
    """Minute bars for a universe, cache-first."""
    fetch = fetcher or _default_intraday_fetcher
    return _fetch_universe(
        tickers, "intraday", data_dir, force_refresh,
        lambda t: fetch(t, period, interval), _normalize_vendor_intraday,
        INTRADAY_SCHEMA, "datetime",
    )


def get_shares_info(
    tickers: Sequence[str],
    info_fn: Callable[[str], Mapping] | None = None,
) -> dict:
    """Per-ticker ``{'shares_outstanding', 'market_cap'}``, None on failure.
    ``info_fn(ticker)`` returns a vendor info
    mapping (yfinance ``Ticker(t).info``-shaped); default requires yfinance.
    """
    def default_info(t):  # pragma: no cover - needs network
        import yfinance as yf

        return yf.Ticker(t).info

    fn = info_fn or default_info
    out = {}
    for t in tickers:
        try:
            info = fn(t)
            out[t] = {
                "shares_outstanding": info.get("sharesOutstanding"),
                "market_cap": info.get("marketCap"),
            }
        except Exception as e:
            log.warning("shares info %s: %s", t, e)
            out[t] = {"shares_outstanding": None, "market_cap": None}
    return out
