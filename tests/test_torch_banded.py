"""The port's banded rebalancing against csmom_tpu's: the closed-form books
equal the reference's associative scan as booleans (hypothesis over
labels, bands and masks), and the banded engine and its labels-level entry
point equal the reference in qcut and rank, f64 and f32, bands 0-3; band 0
is the port's plain engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from csmom_tpu.backtest.banded import banded_books as jax_books
from csmom_tpu.backtest.banded import banded_from_labels as jax_from_labels
from csmom_tpu.backtest.banded import banded_monthly_backtest as jax_banded
from csmom_tpu_torch.backtest.banded import (
    banded_books,
    banded_from_labels,
    banded_monthly_backtest,
    validate_band,
)
from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
from csmom_tpu_torch.costs.impact import long_short_weights, turnover_cost
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.signals.momentum import momentum, monthly_returns

torch.set_num_threads(2)

TOL = {torch.float64: dict(rtol=1e-10, atol=1e-13), torch.float32: dict(rtol=1e-4, atol=1e-6)}
FIELDS = ("spread", "weights", "turnover", "mean_spread", "ann_sharpe", "tstat", "tstat_nw")


def _panel(seed, A=40, M=90):
    rng = np.random.default_rng(seed)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.004, 0.06, size=(A, M)), axis=1))
    mask = np.ones((A, M), bool)
    mask[: A // 8, : M // 4] = False       # late entrants
    mask[-3:, 2 * M // 3:] = False         # delistings
    mask &= rng.random((A, M)) > 0.03      # holes
    return np.where(mask, prices, np.nan), mask


@settings(max_examples=60, deadline=None)
@given(data=st.data(), n_bins=st.integers(2, 12), a=st.integers(1, 12),
       m=st.integers(1, 40))
def test_books_equal_the_associative_scan(data, n_bins, a, m):
    band = data.draw(st.integers(0, max(0, (n_bins - 2) // 2)))
    labels = np.asarray(data.draw(st.lists(st.integers(-1, n_bins - 1),
                                           min_size=a * m, max_size=a * m)),
                        np.int32).reshape(a, m)
    holes = np.asarray(data.draw(st.lists(st.booleans(), min_size=a * m,
                                          max_size=a * m))).reshape(a, m)
    labels = np.where(holes, -1, labels).astype(np.int32)
    lb, sb = banded_books(torch.as_tensor(labels), n_bins, band)
    jlb, jsb = jax_books(jnp.asarray(labels), n_bins, band)
    assert lb.dtype == torch.bool
    np.testing.assert_array_equal(lb.numpy(), np.asarray(jlb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))


def _assert_result_equal(res, jres, dtype):
    for k in ("spread_valid", "n_long", "n_short"):
        np.testing.assert_array_equal(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                      err_msg=k)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                   equal_nan=True, err_msg=k, **TOL[dtype])
    assert res.spread.dtype == dtype and res.n_long.dtype == torch.int32


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("band", [0, 1, 2, 3])
def test_banded_engine_equals_the_reference(band, mode, dtype):
    prices, mask = _panel(3 + band)
    p = torch.as_tensor(prices, dtype=dtype)
    m = torch.as_tensor(mask)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    res = banded_monthly_backtest(p, m, lookback=6, skip=1, n_bins=10, mode=mode, band=band)
    jres = jax_banded(jnp.asarray(prices, jdt), jnp.asarray(mask), lookback=6, skip=1,
                      n_bins=10, mode=mode, band=band)
    _assert_result_equal(res, jres, dtype)
    # the labels-level entry point on the port's own labels
    mom, momv = momentum(p, m, lookback=6, skip=1)
    labels, _ = decile_assign_panel(mom, momv, n_bins=10, mode=mode)
    ret, ret_valid = monthly_returns(p, m)
    got = banded_from_labels(labels, ret, ret_valid, n_bins=10, band=band)
    want = jax_from_labels(jnp.asarray(labels.numpy()), jnp.asarray(ret.numpy()),
                           jnp.asarray(ret_valid.numpy()), n_bins=10, band=band)
    _assert_result_equal(got, want, dtype)


@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_band_zero_is_the_plain_engine(mode, dtype):
    prices, mask = _panel(11)
    p, m = torch.as_tensor(prices, dtype=dtype), torch.as_tensor(mask)
    plain = monthly_spread_backtest(p, m, lookback=6, skip=1, n_bins=5, mode=mode,
                                    impl="plain")
    banded = banded_monthly_backtest(p, m, lookback=6, skip=1, n_bins=5, mode=mode, band=0)
    assert torch.equal(banded.spread_valid, plain.spread_valid)
    torch.testing.assert_close(banded.spread, plain.spread, equal_nan=True, **TOL[dtype])
    for k in ("mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        torch.testing.assert_close(getattr(banded, k), getattr(plain, k), **TOL[dtype])
    w = long_short_weights(plain.labels, plain.decile_counts, 5, dtype=dtype)
    torch.testing.assert_close(banded.turnover, turnover_cost(w, half_spread=1.0),
                               **TOL[dtype])
    wider = banded_monthly_backtest(p, m, lookback=6, skip=1, n_bins=5, mode=mode, band=1)
    assert float(wider.turnover.mean()) < float(banded.turnover.mean())


def test_band_bounds_validated():
    p = torch.full((4, 10), 50.0, dtype=torch.float64)
    m = torch.ones((4, 10), dtype=torch.bool)
    for band, n_bins in [(2, 5), (-1, 5), (5, 10), (1, 2)]:
        with pytest.raises(ValueError, match="stay-zones"):
            banded_monthly_backtest(p, m, n_bins=n_bins, band=band)
        with pytest.raises(ValueError, match="stay-zones"):
            validate_band(band, n_bins)
    validate_band(4, 10)
    validate_band(0, 2)
