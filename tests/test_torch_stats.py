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
