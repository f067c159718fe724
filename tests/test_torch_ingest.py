"""The port's CSV ingest against csmom_tpu's: both cache dialects, the
fetch-cache marker, keep-last dedupe, intraday files, the committed
universe and a CSV fuzzer give exactly equal frames, through the native
parser and through pandas on both sides."""

import logging
import os

import numpy as np
import pandas as pd
import pytest
import torch

from csmom_tpu.panel import ingest as jingest
from csmom_tpu_torch import native
from csmom_tpu_torch.panel import ingest
from tests.test_native import _fuzz_csv

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
UNIVERSE = os.path.join(FIXTURES, "universe")
UNIVERSE_TICKERS = sorted(n.split("_")[0] for n in os.listdir(UNIVERSE))

MARKED_DUPES = """# csmom-cache-v1
Date,Adj Close,Close,High,Low,Open,Volume
2020-01-02,10.0,10.5,11.0,9.5,10.0,1000
2020-01-03,10.2,10.7,11.2,9.7,10.1,1100
2020-01-03,10.9,10.9,11.9,9.9,10.9,1900
2020-01-06,10.4,10.8,11.4,9.8,10.2,1200
"""

INTRADAY = """Datetime,Adj Close,Close,High,Low,Open,Volume
,FAKE,FAKE,FAKE,FAKE,FAKE,FAKE
2025-08-18 13:30:00+00:00,100.0,100.0,100.5,99.5,100.0,500
2025-08-18 09:31:00-04:00,100.2,100.2,100.6,99.9,100.1,400
2025-08-18T13:32:00.5+00:00,100.3,,100.7,99.8,100.2,garbage
"""

CSV_CASES = {
    "SYNA_daily.csv": (os.path.join(FIXTURES, "SYNA_daily.csv"), "daily"),
    "SYNB_daily.csv": (os.path.join(FIXTURES, "SYNB_daily.csv"), "daily"),
    **{f"universe/{t}": (os.path.join(UNIVERSE, f"{t}_daily.csv"), "daily")
       for t in UNIVERSE_TICKERS},
}


@pytest.fixture()
def extra_cases(tmp_path):
    (tmp_path / "M_daily.csv").write_text(MARKED_DUPES)
    (tmp_path / "I_intraday.csv").write_text(INTRADAY)
    return {"marker+dupes": (str(tmp_path / "M_daily.csv"), "daily"),
            "intraday": (str(tmp_path / "I_intraday.csv"), "intraday")}


@pytest.mark.parametrize("engine", ["native", "pandas"])
@pytest.mark.parametrize("case", list(CSV_CASES) + ["marker+dupes", "intraday"])
def test_read_price_csv_frames_equal_the_reference(case, engine, extra_cases):
    path, kind = {**CSV_CASES, **extra_cases}[case]
    before = native.parse_price_csv_native.files
    got = ingest.read_price_csv(path, "T", kind=kind, engine=engine)
    want = jingest.read_price_csv(path, "T", kind=kind, engine=engine)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert len(got) > 0
    # the native engine really parsed the file (no pandas fallback)
    assert native.parse_price_csv_native.files - before == (engine == "native")


@pytest.mark.parametrize("seed", range(24))
def test_fuzzed_csvs_equal_the_reference_in_both_engines(tmp_path, seed):
    """tests/test_native.py's fuzzer: each engine's frame equals the
    reference's same engine exactly, and the two engines agree."""
    rng = np.random.default_rng(24_000 + seed)
    kind = "daily" if seed % 2 == 0 else "intraday"
    text, _ = _fuzz_csv(rng, kind)
    p = tmp_path / f"F{seed}_{kind}.csv"
    p.write_bytes(text.encode())
    frames = {}
    for engine in ("native", "pandas"):
        got = ingest.read_price_csv(str(p), "F", kind=kind, engine=engine)
        want = jingest.read_price_csv(str(p), "F", kind=kind, engine=engine)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        frames[engine] = got
    pd.testing.assert_frame_equal(frames["native"], frames["pandas"], rtol=1e-15, atol=0)


def test_load_daily_universe_and_fixtures_equal_the_reference():
    before = native.parse_price_csv_native.files
    got = ingest.load_daily(UNIVERSE, UNIVERSE_TICKERS + ["MISSING"])
    assert native.parse_price_csv_native.files - before == len(UNIVERSE_TICKERS)
    want = jingest.load_daily(UNIVERSE, UNIVERSE_TICKERS + ["MISSING"])
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    for tk in (["SYNA", "SYNB"], ["SYNB"], []):
        pd.testing.assert_frame_equal(ingest.load_daily(FIXTURES, tk),
                                      jingest.load_daily(FIXTURES, tk),
                                      check_exact=True)


def test_load_intraday_and_fault_isolation_equal_the_reference(tmp_path):
    (tmp_path / "A_intraday.csv").write_text(INTRADAY)
    (tmp_path / "BAD_intraday.csv").write_text("not,a,csv\nat all")
    (tmp_path / "GOOD_daily.csv").write_text(open(os.path.join(FIXTURES, "SYNA_daily.csv")).read())
    (tmp_path / "BAD_daily.csv").write_text("not,a,csv\nat all")
    for fn, jfn, tk in [(ingest.load_intraday, jingest.load_intraday, ["A", "BAD", "NONE"]),
                        (ingest.load_daily, jingest.load_daily, ["GOOD", "BAD", "NONE"])]:
        got, want = fn(str(tmp_path), tk), jfn(str(tmp_path), tk)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        assert len(got) > 0


def test_long_to_panel_and_bundles_equal_the_reference(tmp_path):
    df = ingest.load_daily(UNIVERSE, UNIVERSE_TICKERS)
    jdf = jingest.load_daily(UNIVERSE, UNIVERSE_TICKERS)
    for field in ("adj_close", "volume", "open"):
        p, q = ingest.long_to_panel(df, field), jingest.long_to_panel(jdf, field)
        assert p.values.tobytes() == q.values.tobytes()
        np.testing.assert_array_equal(p.mask, q.mask)
        np.testing.assert_array_equal(p.times, q.times)
        assert p.tickers == q.tickers and p.name == q.name
    sub = UNIVERSE_TICKERS[::-2]
    b, jb = ingest.daily_bundle(df, sub), jingest.daily_bundle(jdf, sub)
    assert b.fields == jb.fields and b.tickers == jb.tickers
    np.testing.assert_array_equal(b.times, jb.times)
    for f in b.fields:
        assert b[f].values.tobytes() == jb[f].values.tobytes()
        np.testing.assert_array_equal(b[f].mask, jb[f].mask)
    (tmp_path / "A_intraday.csv").write_text(INTRADAY)
    idf = ingest.load_intraday(str(tmp_path), ["A"])
    ib, jib = ingest.intraday_bundle(idf), jingest.intraday_bundle(idf)
    assert ib.fields == jib.fields == ("price", "volume")
    for f in ib.fields:
        np.testing.assert_array_equal(ib[f].values, jib[f].values)
        np.testing.assert_array_equal(ib[f].times, jib[f].times)


def test_reference_readable_daily_equal(tmp_path):
    (tmp_path / "QB_daily.csv").write_text(
        '"Price","Close","High","Low","Open","Volume"\n'
        "Ticker,QB,QB,QB,QB,QB\nDate,,,,,\n2020-01-03,1,1,1,1,10\n")
    (tmp_path / "QA_daily.csv").write_text(
        '"Date","Adj Close","Close","High","Low","Open","Volume"\n2020-01-03,1,1,1,1,1,10\n')
    (tmp_path / "MA_daily.csv").write_text(MARKED_DUPES)
    for d, tk in [(FIXTURES, ["SYNA", "SYNB", "NOPE"]),
                  (str(tmp_path), ["QB", "QA", "MA"]), (UNIVERSE, UNIVERSE_TICKERS)]:
        assert ingest.reference_readable_daily(d, tk) == jingest.reference_readable_daily(d, tk)
    assert ingest.reference_readable_daily(str(tmp_path), ["QB", "QA", "MA"]) == ["QA"]


def test_duplicate_dates_dedupe_keep_last_with_a_counted_warning(extra_cases, caplog):
    path, _ = extra_cases["marker+dupes"]
    with caplog.at_level(logging.WARNING, logger="csmom_tpu_torch.panel.ingest"):
        df = ingest.read_price_csv(path, "M", kind="daily")
    assert len(df) == 3 and not df["date"].duplicated().any()
    assert df.loc[df["date"] == pd.Timestamp("2020-01-03"), "adj_close"].tolist() == [10.9]
    msgs = [r.getMessage() for r in caplog.records if "duplicate" in r.getMessage()]
    assert len(msgs) == 1 and "1 duplicate" in msgs[0]


def test_without_a_compiler_auto_parses_with_pandas(monkeypatch):
    """The fallback users get when g++ fails: 'auto' parses with pandas
    (the same frame), 'native' raises, and available() says so."""
    monkeypatch.setattr(native, "_STATE", {"lib": None})
    assert not native.available()
    before = native.parse_price_csv_native.files
    path = CSV_CASES["SYNB_daily.csv"][0]
    got = ingest.read_price_csv(path, "B", kind="daily")
    want = jingest.read_price_csv(path, "B", kind="daily", engine="pandas")
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert native.parse_price_csv_native.files == before
    with pytest.raises(RuntimeError, match="native CSV engine unavailable"):
        ingest.read_price_csv(path, "B", kind="daily", engine="native")
