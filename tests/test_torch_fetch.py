"""The port's fetch layer against csmom_tpu's, with a fake vendor (no
network, no yfinance): the versioned cache, cache hits that never touch
the vendor, force refresh, per-ticker fault isolation, the empty universe,
MultiIndex vendor columns and shares info — the same frames and cache
files on both sides."""

import os

import numpy as np
import pandas as pd
import pytest

from csmom_tpu.panel import fetch as jfetch
from csmom_tpu_torch.panel import fetch
from tests.test_fetch import fake_daily_vendor, fake_intraday_vendor


def _never(*_):
    raise AssertionError("the vendor must not be called on a cache hit")


def _multiindex_vendor(t, s, e):
    df = fake_daily_vendor(t, s, e)
    df.columns = pd.MultiIndex.from_product([df.columns, [t]])
    return df


@pytest.mark.parametrize("vendor", [fake_daily_vendor, _multiindex_vendor])
def test_fetch_daily_writes_the_same_versioned_cache(tmp_path, vendor):
    got = fetch.fetch_daily(["A", "B"], data_dir=str(tmp_path / "p"), fetcher=vendor)
    want = jfetch.fetch_daily(["A", "B"], data_dir=str(tmp_path / "r"), fetcher=vendor)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert len(got) == 80 and got["adj_close"].notna().all()
    assert fetch.CACHE_VERSION == jfetch.CACHE_VERSION
    for t in ("A", "B"):
        p = fetch.cache_path(str(tmp_path / "p"), t, "daily")
        assert p == os.path.join(str(tmp_path / "p"), f"{t}_daily.csv")
        assert open(p).read() == open(jfetch.cache_path(str(tmp_path / "r"), t, "daily")).read()
        assert fetch.CACHE_VERSION in open(p).readline()
    # cache hits: each package reads the other's cache, vendor untouched
    for d in ("p", "r"):
        pd.testing.assert_frame_equal(
            fetch.fetch_daily(["A", "B"], data_dir=str(tmp_path / d), fetcher=_never),
            jfetch.fetch_daily(["A", "B"], data_dir=str(tmp_path / d), fetcher=_never),
            check_exact=True)


def test_force_refresh_and_fault_isolation(tmp_path):
    frames = []
    for f, d in ((fetch, tmp_path / "p"), (jfetch, tmp_path / "r")):
        f.fetch_daily(["A"], data_dir=str(d), fetcher=fake_daily_vendor)
        calls = []

        def flaky(t, s, e):
            calls.append(t)
            if t == "BAD":
                raise ConnectionError("boom")
            return fake_daily_vendor(t, s, e)

        frames.append(f.fetch_daily(["A", "BAD", "B"], data_dir=str(d),
                                    force_refresh=True, fetcher=flaky))
        assert calls == ["A", "BAD", "B"]
        assert set(frames[-1].ticker) == {"A", "B"}
    pd.testing.assert_frame_equal(frames[0], frames[1], check_exact=True)


def test_empty_universe_and_corrupt_cache(tmp_path):
    for f in (fetch, jfetch):
        df = f.fetch_daily([], data_dir=str(tmp_path))
        assert len(df) == 0 and list(df.columns) == list(fetch.DAILY_SCHEMA)
    with open(fetch.cache_path(str(tmp_path), "A", "daily"), "w") as fh:
        fh.write("garbage,header\nonly,junk\n")
    assert len(fetch.fetch_daily(["A"], data_dir=str(tmp_path))) == 0
    with pytest.raises(ValueError, match="0 rows"):
        fetch._read_cache(fetch.cache_path(str(tmp_path), "A", "daily"), "A", "daily")


def test_default_fetcher_without_yfinance_is_a_clear_error(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "yfinance", None)   # import fails
    with pytest.raises(RuntimeError, match="yfinance is not installed"):
        fetch._default_daily_fetcher("A", "2020-01-01", "2020-02-01")
    with pytest.raises(RuntimeError, match="yfinance is not installed"):
        fetch._default_intraday_fetcher("A", "7d", "1m")
    # per-ticker isolation turns it into an empty frame, as the reference does
    assert len(fetch.fetch_daily(["A"], data_dir=str(tmp_path))) == 0


def test_fetch_intraday_roundtrip_equals_the_reference(tmp_path):
    got = fetch.fetch_intraday(["A"], data_dir=str(tmp_path / "p"),
                               fetcher=fake_intraday_vendor)
    want = jfetch.fetch_intraday(["A"], data_dir=str(tmp_path / "r"),
                                 fetcher=fake_intraday_vendor)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.columns) == ["datetime", "ticker", "price", "volume"]
    pd.testing.assert_frame_equal(
        fetch.fetch_intraday(["A"], data_dir=str(tmp_path / "p"), fetcher=_never),
        got, check_exact=True)


def test_get_shares_info_equals_the_reference():
    def info(t):
        if t == "BAD":
            raise KeyError("no info")
        return {"sharesOutstanding": 1000, "marketCap": 5000 + len(t)}

    tickers = ["A", "BAD", "CC"]
    got = fetch.get_shares_info(tickers, info_fn=info)
    assert got == jfetch.get_shares_info(tickers, info_fn=info)
    assert got["BAD"] == {"shares_outstanding": None, "market_cap": None}
    assert np.isclose(got["CC"]["market_cap"], 5002)
