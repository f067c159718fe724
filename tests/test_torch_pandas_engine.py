"""The port's pandas engine (a copy of csmom_tpu's) through ``run_monthly(
backend="pandas")``, with and without a strategy, against csmom_tpu's
pandas backend on the same panels: equal exactly.  The pandas engine runs
on the host, so it needs no card even with the default device."""

import numpy as np
import pytest
import torch

import csmom_tpu.strategy as JS
import csmom_tpu_torch.strategy as TS
from csmom_tpu.backends import run_monthly as jax_run_monthly
from csmom_tpu.backends.pandas_engine import (
    monthly_spread_backtest_pandas as jax_pandas_backtest,
    spread_from_scores_pandas as jax_from_scores,
)
from csmom_tpu.panel.panel import Panel as JaxPanel
from csmom_tpu_torch.backends.dispatch import run_monthly
from csmom_tpu_torch.backends.pandas_engine import (
    monthly_spread_backtest_pandas,
    spread_from_scores_pandas,
)
from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
from csmom_tpu_torch.panel.panel import Panel, to_tensors
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

torch.set_num_threads(2)


def _panels(n_assets, seed):
    daily = synthetic_daily_panel(n_assets, 1260, seed=seed, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device="cpu")
    pm, _ = month_end_aggregate(v, m, seg, len(ends))
    pm = pm.numpy()
    tickers = [f"T{i:03d}" for i in range(n_assets)]
    return Panel.from_dense(pm, tickers, ends), JaxPanel.from_dense(pm, tickers, ends)


@pytest.fixture(scope="module", params=[(25, 11), (60, 7)], ids=["A25", "A60"])
def panels(request):
    return _panels(*request.param)


def _assert_reports_equal(got, want):
    assert got.backend == want.backend == "pandas"
    np.testing.assert_array_equal(got.times, want.times)
    for f in ("spread", "decile_means", "decile_counts", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        a, b = getattr(got, f), getattr(want, f)
        assert a == b or (np.isnan(a) and np.isnan(b)), f


@pytest.mark.parametrize("lookback,skip,n_bins", [(12, 1, 10), (6, 0, 5), (3, 2, 4)])
def test_pandas_backend_equals_the_reference(panels, lookback, skip, n_bins):
    port, ref = panels
    got = run_monthly(port, lookback=lookback, skip=skip, n_bins=n_bins,
                      backend="pandas")
    want = jax_run_monthly(ref, lookback=lookback, skip=skip, n_bins=n_bins,
                           backend="pandas")
    _assert_reports_equal(got, want)
    assert np.isfinite(got.spread).sum() > 10


@pytest.mark.parametrize("name,params", [
    ("momentum", {}), ("reversal", {}), ("intermediate_momentum", {}),
    ("high_52w", {}), ("low_volatility", {"window": 24, "min_obs": 6}),
    ("residual_momentum", {"lookback": 6, "est_window": 24}),
])
def test_pandas_backend_with_a_strategy_equals_the_reference(panels, name, params):
    port, ref = panels
    got = run_monthly(port, n_bins=5, backend="pandas",
                      strategy=TS.make_strategy(name, **params))
    want = jax_run_monthly(ref, n_bins=5, backend="pandas",
                           strategy=JS.make_strategy(name, **params))
    _assert_reports_equal(got, want)


def test_pandas_backend_forwards_volume_panels(panels):
    port, ref = panels
    rng = np.random.default_rng(2)
    vol = np.where(np.isfinite(port.values), rng.uniform(1e5, 1e7, port.shape), 0.0)
    got = run_monthly(port, n_bins=5, backend="pandas",
                      strategy=TS.VolumeZMomentum(), volumes=vol)
    want = jax_run_monthly(ref, n_bins=5, backend="pandas",
                           strategy=JS.VolumeZMomentum(), volumes=vol)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.spread, want.spread, rtol=1e-10, atol=1e-13,
                               equal_nan=True)


def test_engine_functions_equal_the_reference_on_frames(panels):
    port, ref = panels
    df = port.to_dataframe()
    got = monthly_spread_backtest_pandas(df, lookback=9, skip=1, n_bins=6)
    want = jax_pandas_backtest(ref.to_dataframe(), lookback=9, skip=1, n_bins=6)
    for f in ("spread", "decile_means", "decile_counts", "labels"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.equals(b), f
    scores = df.diff(axis=1)
    a = spread_from_scores_pandas(df, scores, n_bins=4)
    b = jax_from_scores(ref.to_dataframe(), scores, n_bins=4)
    assert a.labels.equals(b.labels) and a.spread.equals(b.spread)
    assert a.mean_spread == b.mean_spread


def test_pandas_backend_needs_no_card(panels):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port, _ = panels
    rep = run_monthly(port, backend="pandas")      # device defaults to cuda
    assert rep.backend == "pandas"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_monthly(port)
