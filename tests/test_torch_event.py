"""The port's event engines against csmom_tpu in float64: the threshold
engine with market orders at latency 0, 1 and 3 and with limit orders,
the hysteresis engine at latency 0 and 2, cost attribution, the threshold
sweep and the trade log, on the golden minute frame's dense panels and on
small hypothesis-drawn panels."""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from csmom_tpu import api as japi
from csmom_tpu.backtest import event as jevent
from csmom_tpu_torch import random
from csmom_tpu_torch.backtest import event

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)
INTS = ("positions", "trade_side", "n_trades", "n_buys", "n_sells", "bar_mask")
INT_TYPES = {"positions": torch.int32, "trade_side": torch.int8,
             "n_trades": torch.int32, "n_buys": torch.int32, "n_sells": torch.int32}


def assert_same_result(got, want):
    """Integers equal; floats at the f64 tolerance, except the per-bar PnL:
    a first difference of portfolio values near 1e6, it carries their
    rounding (the cash ledger's prefix sum rounds apart by an ulp between
    XLA and torch), so its absolute tolerance is 1e-15 of the largest
    value."""
    pv_scale = float(np.abs(np.asarray(want.portfolio_value)).max(initial=0.0))
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        if f.name in INT_TYPES:
            assert g.dtype == INT_TYPES[f.name], f.name
        if f.name in INTS:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
        elif f.name == "pnl":
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL["rtol"],
                                       atol=max(TOL["atol"], 1e-15 * pv_scale),
                                       err_msg=f.name)
        else:
            np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f.name)


def assert_same_tca(got, want):
    """Every leg at the f64 tolerance; the residual (total - delay -
    spread - impact, rounding noise for market orders) within 1e-15 of
    the legs it is the difference of."""
    legs = sum(abs(float(getattr(want, n))) for n in
               ("total_cost", "delay_cost", "spread_cost", "impact_cost"))
    for f in dataclasses.fields(want):
        tol = dict(TOL, atol=max(TOL["atol"], 1e-15 * legs)) if f.name == "residual" else TOL
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(getattr(want, f.name)), **tol,
                                   err_msg=f.name)


@pytest.fixture(scope="module")
def golden():
    """The golden minute frame's dense panels (the JAX package's ridge
    pipeline), as numpy arrays, with its tickers and minute axis."""
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    daily = synthetic_daily_panel(8, 10, seed=77)
    a, t = len(daily.tickers), len(daily.times)
    df = pd.DataFrame({
        "date": np.repeat(daily.times, a), "ticker": np.tile(daily.tickers, t),
        "open": daily.values.T.ravel(), "close": daily.values.T.ravel(),
        "adj_close": daily.values.T.ravel(), "volume": 1e6})
    minute_df = japi.synthetic_minute_frame(df, seed=5)
    _, _, compact, score, price, valid = japi.intraday_pipeline(minute_df, df)
    adv, vol = japi.daily_risk_maps(df, compact.tickers)
    arrays = [np.asarray(x) for x in (price, valid, np.nan_to_num(score), adv, vol)]
    return arrays, compact


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("latency", [0, 1, 3])
def test_market_orders_equal_the_reference(golden, latency):
    arrays, _ = golden
    want = jevent.event_backtest(*arrays, latency_bars=latency)
    got = event.event_backtest(*_t(arrays), latency_bars=latency)
    assert_same_result(got, want)
    assert int(got.n_trades) == int(got.n_buys) + int(got.n_sells)
    tca = event.cost_attribution(got, _t(arrays)[0], latency_bars=latency,
                                 valid=_t(arrays)[1])
    assert_same_tca(tca, jevent.cost_attribution(want, arrays[0],
                                                 latency_bars=latency, valid=arrays[1]))
    assert (float(tca.delay_cost) == 0.0) == (latency == 0)


@pytest.mark.parametrize("latency", [0, 2])
def test_limit_orders_equal_the_reference(golden, latency):
    arrays, _ = golden
    want = jevent.event_backtest(*arrays, order_type="limit", latency_bars=latency,
                                 fill_key=jax.random.PRNGKey(0))
    got = event.event_backtest(*_t(arrays), order_type="limit", latency_bars=latency,
                               fill_key=random.PRNGKey(0))
    assert_same_result(got, want)
    assert 0 < int(got.n_trades) < int(event.event_backtest(*_t(arrays)).n_trades)


def test_order_type_errors():
    arrays = _t([np.ones((1, 3)), np.ones((1, 3), bool), np.ones((1, 3)),
                 np.ones(1), np.ones(1)])
    with pytest.raises(ValueError, match="requires fill_key"):
        event.event_backtest(*arrays, order_type="limit")
    with pytest.raises(ValueError, match="unknown order_type"):
        event.event_backtest(*arrays, order_type="stop")


@pytest.mark.parametrize("latency", [0, 2])
def test_hysteresis_equals_the_reference(golden, latency):
    arrays, _ = golden
    kw = dict(threshold_hi=1e-4, threshold_lo=2e-5, latency_bars=latency)
    want = jevent.hysteresis_event_backtest(*arrays, **kw)
    got = event.hysteresis_event_backtest(*_t(arrays), **kw)
    assert_same_result(got, want)
    assert int(got.positions.abs().max()) <= 50       # one unit
    assert int(got.trade_side.abs().max()) == 2        # flips are one ±2 fill
    assert_same_tca(
        event.cost_attribution(got, _t(arrays)[0], latency_bars=latency,
                               valid=_t(arrays)[1]),
        jevent.cost_attribution(want, arrays[0], latency_bars=latency,
                                valid=arrays[1]))


def test_hysteresis_refuses_an_exit_above_the_entry(golden):
    arrays, _ = golden
    with pytest.raises(ValueError, match="must not exceed the entry threshold"):
        event.hysteresis_event_backtest(*_t(arrays), threshold_hi=1e-5,
                                        threshold_lo=1e-4)


def test_cost_attribution_needs_valid_with_latency(golden):
    arrays, _ = golden
    res = event.event_backtest(*_t(arrays), latency_bars=2)
    with pytest.raises(ValueError, match="needs the backtest's `valid` mask"):
        event.cost_attribution(res, _t(arrays)[0], latency_bars=2)


@pytest.mark.parametrize("latency", [0, 3])
def test_threshold_sweep_equals_the_reference(golden, latency):
    arrays, _ = golden
    ths = np.array([1e-6, 5e-6, 1e-5, 5e-5, 1e-3])
    want = jevent.threshold_sweep(*arrays, ths, latency_bars=latency)
    got = event.threshold_sweep(*_t(arrays), ths, latency_bars=latency)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # each point is the single-threshold engine's own result
    one = event.event_backtest(*_t(arrays), threshold=5e-5, latency_bars=latency)
    assert int(one.n_trades) == int(got[1][3])


def test_trades_dataframe_equals_the_reference(golden):
    arrays, compact = golden
    for lat in (0, 2):
        want = jevent.event_backtest(*arrays, latency_bars=lat)
        got = event.event_backtest(*_t(arrays), latency_bars=lat)
        pd.testing.assert_frame_equal(
            event.trades_dataframe(got, compact.tickers, compact.times, _t(arrays)[2]),
            jevent.trades_dataframe(want, compact.tickers, compact.times, arrays[2]),
            check_exact=False, rtol=1e-10, atol=1e-13)
    hres = event.hysteresis_event_backtest(*_t(arrays), threshold_hi=1e-4,
                                           threshold_lo=2e-5)
    frame = event.trades_dataframe(hres, compact.tickers, compact.times, _t(arrays)[2])
    assert set(np.abs(frame["size"])) <= {50, 100} and len(frame) == int(hres.n_trades)


@st.composite
def panels(draw):
    """A small dense minute panel: shapes from a few sizes (each a new
    compile on the JAX side), gappy event rows, scores around the
    thresholds, prices with NaN off the event rows."""
    A = draw(st.sampled_from([1, 3]))
    T = draw(st.sampled_from([9, 40]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    valid = rng.random((A, T)) < draw(st.sampled_from([0.3, 0.8, 1.0]))
    price = np.where(valid, 20 * np.exp(np.cumsum(rng.normal(0, 0.01, (A, T)), 1)),
                     np.nan)
    score = rng.choice([-2e-4, -5e-5, -1e-5, 0.0, 1e-5, 3e-5, 2e-4], size=(A, T)) * \
        rng.uniform(0.5, 1.5, (A, T))
    adv = rng.choice([0.0, 50.0, 1e5], size=A)
    vol = rng.uniform(0.01, 0.05, A)
    return [price, valid, score, adv, vol]


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(panels(), st.sampled_from([0, 1, 3]), st.sampled_from(["market", "limit"]))
def test_engines_on_drawn_panels(arrays, latency, order_type):
    kw = dict(latency_bars=latency, order_type=order_type, threshold=3e-5)
    want = jevent.event_backtest(*arrays, fill_key=jax.random.PRNGKey(3), **kw)
    got = event.event_backtest(*_t(arrays), fill_key=random.PRNGKey(3), **kw)
    assert_same_result(got, want)
    hkw = dict(threshold_hi=1e-4, threshold_lo=2e-5, latency_bars=latency)
    assert_same_result(event.hysteresis_event_backtest(*_t(arrays), **hkw),
                       jevent.hysteresis_event_backtest(*arrays, **hkw))
    assert_same_tca(
        event.cost_attribution(got, _t(arrays)[0], latency_bars=latency,
                               valid=_t(arrays)[1]),
        jevent.cost_attribution(want, arrays[0], latency_bars=latency, valid=arrays[1]))
