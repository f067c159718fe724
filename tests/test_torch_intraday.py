"""The port's intraday data layer against csmom_tpu in float64: the
compaction of a long minute frame, the minute features and the next-row
label on seeded frames with missing minutes and unequal row counts, the
synthetic minute frame and the daily risk maps."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from csmom_tpu import api as japi
from csmom_tpu.signals import intraday as jintraday
from csmom_tpu_torch import api
from csmom_tpu_torch.signals import intraday

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)
# the volume z-score divides by a rolling std from prefix sums of squares,
# whose windows of smooth 60-row volume sums cancel: the cumulative sums
# round apart between XLA and torch (max 3.6e-10 relative over seeds 3,
# 8, 11 and 12 at window 60; the other four features are bit-equal)
ZSCORE_TOL = dict(rtol=1e-8, atol=1e-13, equal_nan=True)
ZSCORE = 3


def _minute_frame(seed, n_tickers=5, days=3, drop=0.07):
    """A long minute frame: random walks over ``days`` x 390 minutes with
    ``drop`` of the rows missing at random, one ticker listing a day late
    and one with a single row."""
    rng = np.random.default_rng(seed)
    stamps = (np.datetime64("2024-03-04T09:30")
              + np.arange(days)[:, None] * np.timedelta64(1, "D")
              + np.arange(390)[None, :] * np.timedelta64(1, "m")).ravel()
    frames = []
    for i in range(n_tickers):
        n = len(stamps)
        px = 50 * np.exp(np.cumsum(rng.normal(0, 8e-4, n)))
        vol = rng.integers(1, 20_000, n).astype(float)
        keep = rng.random(n) > drop
        if i == 1:
            keep[:390] = False
        if i == 2:
            keep[:] = False
            keep[17] = True
        frames.append(pd.DataFrame({"datetime": stamps[keep], "ticker": f"T{i}",
                                    "price": px[keep], "volume": vol[keep]}))
    return pd.concat(frames[::-1], ignore_index=True)


@pytest.fixture(scope="module", params=[3, 8])
def compacted(request):
    df = _minute_frame(request.param)
    return jintraday.compact_minutes(df), intraday.compact_minutes(df)


def test_compaction_equals_the_reference(compacted):
    ref, got = compacted
    assert got.tickers == ref.tickers
    np.testing.assert_array_equal(got.times, ref.times)
    for f in ("price", "volume", "time_idx", "row_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    np.testing.assert_array_equal(got.n_rows, ref.n_rows)
    assert len(set(got.n_rows.tolist())) > 2      # unequal row counts


@pytest.mark.parametrize("window", [5, 30, 60])
def test_minute_features_and_label(compacted, window):
    ref, got = compacted
    jf, jv = jintraday.minute_features(jnp.asarray(ref.price), jnp.asarray(ref.volume),
                                       jnp.asarray(ref.row_valid), window=window)
    tf, tv = intraday.minute_features(torch.from_numpy(got.price),
                                      torch.from_numpy(got.volume),
                                      torch.from_numpy(got.row_valid), window=window)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tf.shape[-1] == len(intraday.FEATURE_NAMES) == 5
    other = [k for k in range(5) if k != ZSCORE]
    np.testing.assert_allclose(tf.numpy()[..., other], np.asarray(jf)[..., other], **TOL)
    np.testing.assert_allclose(tf.numpy()[..., ZSCORE], np.asarray(jf)[..., ZSCORE],
                               **ZSCORE_TOL)
    jy, jyv = jintraday.next_row_return(jnp.asarray(ref.price), jv)
    ty, tyv = intraday.next_row_return(torch.from_numpy(got.price), tv)
    np.testing.assert_array_equal(tyv.numpy(), np.asarray(jyv))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def _daily_frame(n_assets, n_days, seed, gaps=False):
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    daily = synthetic_daily_panel(n_assets, n_days, seed=seed, listing_gaps=gaps)
    a, t = len(daily.tickers), len(daily.times)
    vol = np.random.default_rng(seed).integers(0, 3_000_000, size=a * t).astype(float)
    df = pd.DataFrame({
        "date": np.repeat(daily.times, a),
        "ticker": np.tile(daily.tickers, t),
        "open": daily.values.T.ravel() * 0.999,
        "close": daily.values.T.ravel(),
        "adj_close": daily.values.T.ravel(),
        "volume": vol,
    })
    return df[np.isfinite(df["close"])].reset_index(drop=True)


@pytest.mark.parametrize("seed", [5, 9])
def test_synthetic_minute_frame_equals_the_reference(seed):
    df = _daily_frame(6, 8, seed, gaps=True)
    got = api.synthetic_minute_frame(df, seed=seed)
    pd.testing.assert_frame_equal(got, japi.synthetic_minute_frame(df, seed=seed),
                                  check_exact=True)
    assert len(got) > 0
    empty = api.synthetic_minute_frame(df.iloc[:0])
    pd.testing.assert_frame_equal(empty, japi.synthetic_minute_frame(df.iloc[:0]))
    assert list(api.synthetic_minute_frame(None).columns) == [
        "datetime", "ticker", "price", "volume"]


def test_daily_risk_maps_equal_the_reference():
    df = _daily_frame(6, 30, 4, gaps=True)
    # a ticker with zero volume, one with one day, one absent from the frame
    df.loc[df["ticker"] == "S00001", "volume"] = 0.0
    df = df[(df["ticker"] != "S00002") | (df["date"] == df["date"].min())]
    tickers = sorted(df["ticker"].unique()) + ["ABSENT"]
    for daily in (df, None, df.iloc[:0]):
        got = api.daily_risk_maps(daily, tickers)
        want = japi.daily_risk_maps(daily, tickers)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    adv, vol = api.daily_risk_maps(df, tickers)
    assert adv[-1] == 100_000.0 and vol[-1] == 0.02 and adv[1] == 100_000.0
