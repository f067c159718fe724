"""CSV ingest: cached yfinance dialects -> canonical long frames -> panels.

A copy of :mod:`csmom_tpu.panel.ingest` (its frames are held to the
reference's, exactly, by tests/test_torch_ingest.py).  The reference demo
caches one CSV per (ticker, freq) in two dialects:

- dialect A (most files)::

      Date,Adj Close,Close,High,Low,Open,Volume
      ,AMD,AMD,AMD,AMD,AMD,AMD          <- junk "ticker" row
      2018-01-02,10.97,...

- dialect B (newer yfinance, e.g. ``AAPL_daily.csv``)::

      Price,Close,High,Low,Open,Volume
      Ticker,AAPL,AAPL,AAPL,AAPL,AAPL
      Date,,,,,
      2018-01-02,40.38,...

The demo's own normalizer drops dialect B whole; this ingest reads both.
Output schemas are the demo's canonical ones: daily
``['date','ticker','open','high','low','close','adj_close','volume']``,
intraday ``['datetime','ticker','price','volume']``.  Data rows are parsed
by the native C++ parser (:mod:`csmom_tpu_torch.native`) when it builds,
else by pandas; both give the same frames.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Sequence

import numpy as np
import pandas as pd

from csmom_tpu_torch.panel.panel import Panel, PanelBundle

log = logging.getLogger(__name__)

DAILY_SCHEMA = ["date", "ticker", "open", "high", "low", "close", "adj_close", "volume"]
INTRADAY_SCHEMA = ["datetime", "ticker", "price", "volume"]

_FIELD_ALIASES = {
    "open": "open",
    "high": "high",
    "low": "low",
    "close": "close",
    "adj close": "adj_close",
    "adj_close": "adj_close",
    "volume": "volume",
    "price": "price",
}


def _strip_preamble(raw: pd.DataFrame) -> pd.DataFrame:
    """Drop the junk header rows both yfinance cache dialects carry.

    A data row is one whose first cell parses as a date; preamble rows have
    first cell empty, 'Ticker', or 'Date'.
    """
    first = raw.iloc[:, 0].astype(str).str.strip()
    junk = first.isin(["", "nan", "None", "Ticker", "Date", "Datetime"])
    # only the leading block is preamble; stop at the first real row
    keep_from = int(np.argmax(~junk.values)) if (~junk).any() else len(raw)
    return raw.iloc[keep_from:]


def read_price_csv(path: str, ticker: str, kind: str = "daily",
                   engine: str = "auto") -> pd.DataFrame:
    """Read one cached CSV (either dialect) into the canonical long schema.

    Unlike the reference demo's ``_normalize_daily_columns``, the timestamp is always taken from the *first column* once the preamble is
    stripped — which is what both dialects actually put there — rather than
    from a column literally named ``Date``.

    ``engine``: 'auto' (native C++ parser when available, else pandas),
    'native' (require the C++ parser), or 'pandas'.  Both engines produce
    identical frames (held by tests/test_torch_ingest.py).
    """
    if engine in ("auto", "native"):
        out = _read_native(path, ticker, kind)
        if out is not None:
            return out
        if engine == "native":
            raise RuntimeError("native CSV engine unavailable (no compiler?)")

    # index_col=False: without it, a ragged over-long FIRST data row makes
    # read_csv silently shift the timestamp column into the index (data
    # corruption); with it, a long first row truncates to the header width
    # (matching the native engine) and a long later row raises loudly —
    # caught by the universe-level fault isolation in _load_universe
    raw = pd.read_csv(path, low_memory=False, dtype=str, index_col=False)
    cols = [str(c).strip() for c in raw.columns]
    body = _strip_preamble(raw)

    time_col = "date" if kind == "daily" else "datetime"
    out = pd.DataFrame()
    # format="mixed" parses each element independently; the default infers
    # a format from the first row and NaT-coerces every row that differs,
    # silently dropping valid data when a file mixes timestamp spellings
    out[time_col] = pd.to_datetime(body.iloc[:, 0], errors="coerce",
                                   utc=(kind != "daily"), format="mixed")
    if kind != "daily":
        # store tz-naive UTC timestamps; panels index by absolute instants
        out[time_col] = out[time_col].dt.tz_localize(None)

    for pos, col in enumerate(cols):
        canon = _FIELD_ALIASES.get(col.lower())
        if canon and pos > 0:
            out[canon] = pd.to_numeric(body.iloc[:, pos], errors="coerce")

    return _canonize(out, kind, ticker)


def _canonize(out: pd.DataFrame, kind: str, ticker: str) -> pd.DataFrame:
    """Shared schema tail for both CSV engines."""
    if kind == "daily":
        if "adj_close" not in out:
            # dialect B ships no Adj Close; yfinance's Close there is already
            # the adjusted series (as the reference demo takes it)
            out["adj_close"] = out.get("close", np.nan)
        return _finalize(out, DAILY_SCHEMA, "date", ticker)

    if "price" not in out:
        for fallback in ("adj_close", "close"):
            if fallback in out:
                out["price"] = out[fallback]
                break
        else:
            out["price"] = np.nan
    return _finalize(out, INTRADAY_SCHEMA, "datetime", ticker)


def _sniff_header(path: str):
    """First real header of a price CSV: ``(columns, had_marker)``.

    The one place header sniffing lives (native fast path and parity-
    universe detection both use it): skips the versioned fetch-cache
    marker line, unquotes names the way ``read_csv`` does (``'"Close"'``
    -> ``'Close'``) — price-cache headers never contain embedded commas,
    so a plain split is safe even when names are quoted.  Returns
    ``(None, False)`` on an unreadable file.
    """
    try:
        with open(path, "r") as f:
            header = f.readline()
            had_marker = header.startswith("#")
            if had_marker:
                header = f.readline()
    except OSError:
        return None, False
    cols = [c.strip().strip('"').strip() for c in header.rstrip("\r\n").split(",")]
    return cols, had_marker


def _read_native(path: str, ticker: str, kind: str) -> pd.DataFrame | None:
    """C++ fast path: header sniffed host-side, data rows parsed natively.

    Returns None when the native library can't be built/loaded so the
    caller falls back to pandas.
    """
    from csmom_tpu_torch.native import parse_price_csv_native

    cols, _ = _sniff_header(path)
    if cols is None or len(cols) < 2:
        return None
    try:
        parsed = parse_price_csv_native(path, len(cols) - 1)
    except Exception as e:  # pragma: no cover - defensive
        log.warning("native parse failed for %s (%r); pandas fallback", path, e)
        return None
    if parsed is None:
        return None
    epochs, values = parsed

    time_col = "date" if kind == "daily" else "datetime"
    out = pd.DataFrame({time_col: pd.to_datetime(epochs, unit="ns")})
    for pos, col in enumerate(cols):
        canon = _FIELD_ALIASES.get(col.lower())
        if canon and pos > 0:
            out[canon] = values[:, pos - 1]
    return _canonize(out, kind, ticker)


def _finalize(out: pd.DataFrame, schema, time_col: str, ticker: str) -> pd.DataFrame:
    for c in schema:
        if c not in out:
            out[c] = np.nan
    out["ticker"] = ticker
    out = out.dropna(subset=[time_col])
    # vendor caches occasionally repeat a timestamp (a re-download
    # appended instead of replacing, a provider correction row): keep
    # the LAST occurrence — the correction — and say how many were
    # dropped.  Silently keeping both used to leak duplicate rows into
    # long_to_panel, where pivot_table's aggfunc quietly picked one.
    n_dup = int(out.duplicated(subset=[time_col]).sum())
    if n_dup:
        log.warning(
            "%s: %d duplicate %s row(s) in cache — deduplicated "
            "keep-last (provider corrections win)",
            ticker, n_dup, time_col,
        )
        # .copy() detaches the result from its parent frame so the dtype
        # normalization below writes a real frame, not a flagged slice
        out = out.drop_duplicates(subset=[time_col], keep="last").copy()
    # uniform engine-independent dtypes: ns timestamps, f64 numerics
    out[time_col] = out[time_col].astype("datetime64[ns]")
    for c in schema:
        if c not in (time_col, "ticker"):
            out[c] = out[c].astype(np.float64)
    return out[schema].reset_index(drop=True)


def _load_universe(
    data_dir: str, tickers: Sequence[str], kind: str, suffix: str
) -> pd.DataFrame:
    """Per-ticker load with the reference's fault isolation: a bad ticker is
    skipped with a warning, never fatal."""
    frames = []
    for t in tickers:
        path = os.path.join(data_dir, f"{t}_{suffix}.csv")
        try:
            if not os.path.exists(path):
                log.warning("no cache file for %s (%s) — skipping", t, path)
                continue
            df = read_price_csv(path, t, kind=kind)
            if df.empty:
                log.warning("no valid rows for %s after normalization — skipping", t)
                continue
            frames.append(df)
        except Exception as e:  # noqa: BLE001 — universe-level fault isolation
            log.warning("failed to load %s: %r — skipping", t, e)
    schema = DAILY_SCHEMA if kind == "daily" else INTRADAY_SCHEMA
    if not frames:
        return pd.DataFrame(columns=schema)
    return pd.concat(frames, ignore_index=True)


def load_daily(data_dir: str, tickers: Sequence[str]) -> pd.DataFrame:
    """Load the daily universe from cached CSVs into the canonical schema."""
    return _load_universe(data_dir, tickers, "daily", "daily")


def reference_readable_daily(data_dir: str, tickers: Sequence[str]) -> list:
    """Tickers whose daily cache the REFERENCE's own loader can read.

    The reference demo's normalizer finds no date column in dialect-B files
    (header ``Price,Close,...``) and silently drops every row — on its
    shipped data that loses AAPL and shrinks its effective daily universe
    to 19 names.  Parity mode needs to reproduce that shrunken universe
    for the risk maps, so this detects dialect B the same way the
    reference fails on it: by the first header cell.  Missing files are
    excluded too (the reference would have no rows for them either), and
    so are files carrying our fetch-cache marker line — the reference's
    bare ``pd.read_csv`` takes the marker as a one-field header and then
    finds no date column, losing the file regardless of its dialect.
    """
    out = []
    for t in tickers:
        cols, had_marker = _sniff_header(
            os.path.join(data_dir, f"{t}_daily.csv")
        )
        if cols is None or had_marker:
            continue
        if cols[0].lower() != "price":
            out.append(t)
    return out


def load_intraday(data_dir: str, tickers: Sequence[str]) -> pd.DataFrame:
    """Load the intraday universe from cached CSVs into the canonical schema."""
    return _load_universe(data_dir, tickers, "intraday", "intraday")


def long_to_panel(
    df: pd.DataFrame,
    value_col: str,
    time_col: str = "date",
    tickers: Sequence[str] | None = None,
    times: np.ndarray | None = None,
) -> Panel:
    """Pivot a canonical long frame into a masked dense Panel.

    The time axis is the sorted union of observed timestamps (or an explicit
    calendar); missing (asset, time) cells become masked NaN lanes — the
    dense-panel replacement for pandas' implicit row dropping.
    """
    if tickers is None:
        tickers = sorted(df["ticker"].unique())
    if times is None:
        times = np.sort(df[time_col].unique())
    wide = (
        df.pivot_table(index="ticker", columns=time_col, values=value_col, aggfunc="last")
        .reindex(index=list(tickers), columns=pd.Index(times))
    )
    return Panel.from_dense(wide.values, tickers, np.asarray(times), name=value_col)


def to_bundle(
    df: pd.DataFrame,
    value_cols: Iterable[str],
    time_col: str = "date",
    tickers: Sequence[str] | None = None,
) -> PanelBundle:
    """Pivot several value columns onto one shared (tickers, times) grid."""
    if tickers is None:
        tickers = sorted(df["ticker"].unique())
    times = np.sort(df[time_col].unique())
    panels = {
        c: long_to_panel(df, c, time_col=time_col, tickers=tickers, times=times)
        for c in value_cols
    }
    return PanelBundle(panels=panels, tickers=tuple(tickers), times=np.asarray(times))


def daily_bundle(df: pd.DataFrame, tickers: Sequence[str] | None = None) -> PanelBundle:
    return to_bundle(
        df, ["open", "high", "low", "close", "adj_close", "volume"], "date", tickers
    )


def intraday_bundle(df: pd.DataFrame, tickers: Sequence[str] | None = None) -> PanelBundle:
    return to_bundle(df, ["price", "volume"], "datetime", tickers)
