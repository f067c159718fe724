"""The port's two engines end to end against csmom_tpu: the monthly decile
backtest, the J x K grid, the committed synthetic golden, and the host
entry points on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.backtest import monthly_spread_backtest as jax_monthly
from csmom_tpu.backtest.grid import jk_grid_backtest as jax_grid
from csmom_tpu_torch.analytics.stats import nw_t_stat
from csmom_tpu_torch.backends.dispatch import run_grid, run_monthly
from csmom_tpu_torch.backtest.grid import jk_grid_backtest
from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
from csmom_tpu_torch.panel.panel import Panel, to_tensors
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
from csmom_tpu_torch.workloads import month_panel

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)

# tests/test_synthetic_golden.py's pinned monthly fingerprints
MONTHLY = {
    "n_months": 58,
    "n_valid_spreads": 44,
    "mean_spread": -0.024151046163,
    "ann_sharpe": -0.838545964552,
    "nw_t": -2.001284759867,
    "cum_return": 0.271094424165,
}


def _monthly_panel(seed, m, a, gaps):
    """The panels of tests/test_monthly_backtest.py, assets-major."""
    rng = np.random.default_rng(seed)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.005 if not gaps else 0.0,
                                              0.08 if not gaps else 0.06,
                                              size=(m, a)), axis=0))
    if gaps:
        prices[:20, :5] = np.nan    # late entrants
        prices[40:, 25:] = np.nan   # delistings
    vals = prices.T.copy()
    return vals, np.isfinite(vals)


def _assert_monthly_equal(res, jres):
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(jres.labels))
    np.testing.assert_array_equal(res.spread_valid.numpy(), np.asarray(jres.spread_valid))
    np.testing.assert_array_equal(res.decile_counts.numpy(), np.asarray(jres.decile_counts))
    np.testing.assert_allclose(res.decile_means.numpy(), np.asarray(jres.decile_means), **TOL)
    np.testing.assert_allclose(res.spread.numpy(), np.asarray(jres.spread), **TOL)
    for k in ("mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        np.testing.assert_allclose(float(getattr(res, k)), float(getattr(jres, k)),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("seed,m,a,gaps", [(1, 72, 25, False), (2, 60, 30, True)])
def test_monthly_backtest_matches_jax(mode, seed, m, a, gaps):
    vals, mask = _monthly_panel(seed, m, a, gaps)
    res = monthly_spread_backtest(torch.as_tensor(vals), torch.as_tensor(mask), mode=mode)
    jres = jax_monthly(jnp.asarray(vals), jnp.asarray(mask), mode=mode)
    assert res.spread_valid.any()
    _assert_monthly_equal(res, jres)
    plain = monthly_spread_backtest(torch.as_tensor(vals), torch.as_tensor(mask),
                                    mode=mode, impl="plain")
    assert torch.equal(plain.decile_counts, res.decile_counts)


def _grid_panel():
    """tests/test_pallas.py's late-listing grid panel."""
    rng = np.random.default_rng(151)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.004, 0.06, size=(40, 120)), axis=1))
    mask = np.ones((40, 120), bool)
    mask[:5, :30] = False
    return prices, mask


@pytest.mark.parametrize("mode", ["rank", "qcut"])
def test_grid_backtest_matches_jax(mode):
    prices, mask = _grid_panel()
    Js, Ks = np.array([3, 6]), np.array([1, 6])
    res = jk_grid_backtest(torch.as_tensor(prices), torch.as_tensor(mask), Js, Ks,
                           skip=1, n_bins=5, mode=mode)
    jres = jax_grid(jnp.asarray(prices), jnp.asarray(mask), Js, Ks, skip=1,
                    n_bins=5, mode=mode)
    assert res.spreads.shape == (2, 2, 120)
    np.testing.assert_array_equal(res.spread_valid.numpy(), np.asarray(jres.spread_valid))
    for k in ("spreads", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                   err_msg=k, **TOL)
    plain = jk_grid_backtest(torch.as_tensor(prices), torch.as_tensor(mask), Js, Ks,
                             skip=1, n_bins=5, mode=mode, impl="plain")
    np.testing.assert_allclose(plain.spreads.numpy(), res.spreads.numpy(), **TOL)


def test_grid_max_hold_guard():
    prices, mask = _grid_panel()
    with pytest.raises(ValueError, match="max_hold"):
        jk_grid_backtest(torch.as_tensor(prices), torch.as_tensor(mask), [3], [6],
                         max_hold=4)


def test_synthetic_golden_monthly():
    """tests/test_synthetic_golden.py's MONTHLY fingerprints, reproduced."""
    daily = synthetic_daily_panel(40, 1260, seed=123, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    assert len(ends) == MONTHLY["n_months"]
    v, m = to_tensors(daily.values, daily.mask, device="cpu")
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    res = monthly_spread_backtest(pm, mm, lookback=12, skip=1)
    sv = res.spread_valid.numpy()
    assert int(sv.sum()) == MONTHLY["n_valid_spreads"]
    np.testing.assert_allclose(float(res.mean_spread), MONTHLY["mean_spread"], rtol=1e-9)
    np.testing.assert_allclose(float(res.ann_sharpe), MONTHLY["ann_sharpe"], rtol=1e-9)
    np.testing.assert_allclose(float(nw_t_stat(res.spread, res.spread_valid)),
                               MONTHLY["nw_t"], rtol=1e-9)
    cum = float(np.prod(1 + res.spread.numpy()[sv]))
    np.testing.assert_allclose(cum, MONTHLY["cum_return"], rtol=1e-9)


def test_host_entry_points_on_cpu():
    pm, mm, ends = month_panel(60, 800, device="cpu", dtype=torch.float64)
    panel = Panel(values=pm.numpy(), mask=mm.numpy(),
                  tickers=tuple(f"S{i}" for i in range(60)), times=ends)
    rep = run_monthly(panel, device="cpu")
    res = monthly_spread_backtest(pm, mm)
    np.testing.assert_array_equal(rep.labels, res.labels.numpy())
    np.testing.assert_allclose(rep.spread, np.where(res.spread_valid, res.spread, np.nan),
                               **TOL)
    assert rep.backend == "torch:cpu" and rep.mean_spread == float(res.mean_spread)

    grep = run_grid(panel, Js=(3, 6), Ks=(1, 3), mode="rank", device="cpu")
    gres = jk_grid_backtest(pm, mm, [3, 6], [1, 3], mode="rank")
    np.testing.assert_array_equal(grep.spread_valid, gres.spread_valid.numpy())
    np.testing.assert_allclose(grep.spreads, gres.spreads.numpy(), **TOL)
    np.testing.assert_array_equal(grep.Ks, [1, 3])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_decile_portfolio_returns_matches_jax(impl, dtype):
    """K1 behind the public function: the CPU path of ``impl="kernel"`` and
    ``impl="plain"`` against the reference's default path."""
    from csmom_tpu.backtest.monthly import decile_portfolio_returns as jax_dpr
    from csmom_tpu_torch.backtest.monthly import decile_portfolio_returns

    rng = np.random.default_rng(17)
    a, m, n_bins = 37, 29, 6
    ret = np.where(rng.random((a, m)) > 0.1, rng.normal(0, 0.1, (a, m)), np.nan)
    valid = np.isfinite(ret) & (rng.random((a, m)) > 0.2)
    labels = rng.integers(-1, n_bins, size=(a, m)).astype(np.int32)
    labels[:, 3] = -1                                  # an empty month
    means, counts = decile_portfolio_returns(
        torch.as_tensor(ret.astype(dtype)), torch.as_tensor(valid),
        torch.as_tensor(labels), n_bins, impl=impl)
    jmeans, jcounts = jax_dpr(jnp.asarray(ret.astype(dtype)), jnp.asarray(valid),
                              jnp.asarray(labels), n_bins)
    assert counts.dtype == torch.int32 and means.shape == (n_bins, m)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    tol = TOL if dtype == np.float64 else dict(rtol=1e-4, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), **tol)
    assert torch.isnan(means[:, 3]).all()
    with pytest.raises(ValueError, match="unknown impl"):
        decile_portfolio_returns(torch.as_tensor(ret), torch.as_tensor(valid),
                                 torch.as_tensor(labels), n_bins, impl="xla")
