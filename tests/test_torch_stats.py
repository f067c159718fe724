"""The port's masked statistics against csmom_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.analytics import stats as jstats
from csmom_tpu_torch.analytics import stats

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)


def _series(seed, shape=(3, 4, 50)):
    """Spread-like series with ragged validity and the degenerate rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.01, 0.05, size=shape)
    valid = rng.random(shape) > 0.2
    valid[0, 0] = False                  # empty series
    valid[0, 1] = False
    valid[0, 1, 7] = True                # single observation
    x[0, 2] = 0.25                       # zero std (0.25 sums exactly in any order)
    valid[0, 2] = True
    valid[1, 0, :10] = False             # warm-up prefix
    valid[1, 0, -5:] = False             # horizon tail
    return np.where(valid, x, np.nan), valid


def _both(x, valid):
    return torch.as_tensor(x), torch.as_tensor(valid), jnp.asarray(x), jnp.asarray(valid)


@pytest.mark.parametrize("fn,kw", [
    ("masked_mean", {}),
    ("masked_std", {}),
    ("masked_std", {"ddof": 0}),
    ("sharpe", {"freq_per_year": 12}),
    ("t_stat", {}),
    ("cumulative_growth", {}),
])
def test_stat_matches_jax(fn, kw):
    tx, tv, jx, jv = _both(*_series(1))
    got = getattr(stats, fn)(tx, tv, **kw)
    want = getattr(jstats, fn)(jx, jv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lags,max_lag", [
    (None, 24),                              # Newey–West rule of thumb
    (np.array([[1, 3, 6, 12]]), 12),         # per-cell lags, grid style
    (3, 5),                                  # scalar lag
    (np.array([[2, 9, 30, 4]]), 6),          # lags above max_lag are capped
])
def test_nw_t_stat_matches_jax(lags, max_lag):
    tx, tv, jx, jv = _both(*_series(2))
    got = stats.nw_t_stat(tx, tv, lags=None if lags is None else torch.as_tensor(lags),
                          max_lag=max_lag)
    want = jstats.nw_t_stat(jx, jv, lags=None if lags is None else jnp.asarray(lags),
                            max_lag=max_lag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_nw_t_stat_lag_loop_stops_at_series_length():
    x, valid = _series(3)
    tx, tv, jx, jv = _both(x[..., :5], valid[..., :5])
    np.testing.assert_allclose(stats.nw_t_stat(tx, tv, max_lag=24).numpy(),
                               np.asarray(jstats.nw_t_stat(jx, jv, max_lag=24)),
                               **TOL)


@pytest.mark.parametrize("fn,kw", [
    ("rolling_sum", {"window": 6}),
    ("rolling_mean", {"window": 6, "min_periods": 3}),
    ("rolling_std", {"window": 12, "min_periods": 4}),
    ("rolling_std", {"window": 5, "ddof": 0}),
])
def test_rolling_matches_jax(fn, kw):
    from csmom_tpu.ops import rolling as jrolling
    from csmom_tpu_torch.ops import rolling

    x, valid = _series(21)
    x = x * 1e4 + 3e6                      # large raw values: the centering matters
    tx, tv, jx, jv = _both(x, valid)
    got, gv = getattr(rolling, fn)(tx, tv, **kw)
    want, wv = getattr(jrolling, fn)(jx, jv, **kw)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # a std is the square root of a difference of prefix sums of squares
    # (centred values ~500 here, window sums ~1e7): where the variance
    # cancels to ~0 (one point, ddof=0) it is sqrt of their rounding,
    # sqrt(1e-16 * 1e7) ~ 3e-5, in either library's summation order
    atol = 1e-4 if fn == "rolling_std" else 1e-7
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=atol,
                               equal_nan=True)
    np.testing.assert_array_equal(rolling.rolling_count(tv, 4).numpy(),
                                  np.asarray(jrolling.rolling_count(jv, 4)))


@pytest.mark.parametrize("window,mp", [(12, None), (6, 3)])
def test_rolling_sharpe_and_vol_managed_match_jax(window, mp):
    x, valid = _series(22)
    tx, tv, jx, jv = _both(x, valid)
    got = stats.rolling_sharpe(tx, tv, window, min_periods=mp)
    want = jstats.rolling_sharpe(jx, jv, window, min_periods=mp)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    got = stats.vol_managed(tx, tv, window=window, target_ann_vol=0.1)
    want = jstats.vol_managed(jx, jv, window=window, target_ann_vol=0.1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[::2], want[::2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert got[1].any() and (got[2][got[1]] <= 2.0).all()
