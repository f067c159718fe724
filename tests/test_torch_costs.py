"""The port's cost layer against csmom_tpu in float64: execution cost
models, the long-short book and its turnover cost, the sector-neutral
monthly engine net of costs (BASELINE config 3), the grid's exact
overlapping-book netting and break-evens, and the cross-table (matmul)
forms of the grid's cohort sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.backtest import monthly as jmonthly
from csmom_tpu.backtest import grid as jgrid
from csmom_tpu.costs import impact as jimpact
from csmom_tpu_torch import random
from csmom_tpu_torch.backtest import grid, monthly
from csmom_tpu_torch.costs import impact

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)


def _t(x):
    return torch.as_tensor(np.array(x))


def _monthly_panel(seed=2, m=60, a=30):
    """tests/test_torch_engines.py's gappy monthly panel, assets-major."""
    rng = np.random.default_rng(seed)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.0, 0.06, size=(m, a)), axis=0))
    prices[:20, :5] = np.nan
    prices[40:, 25:] = np.nan
    vals = prices.T.copy()
    return vals, np.isfinite(vals)


def _grid_panel():
    """tests/test_pallas.py's late-listing grid panel."""
    rng = np.random.default_rng(151)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.004, 0.06, size=(40, 120)), axis=1))
    mask = np.ones((40, 120), bool)
    mask[:5, :30] = False
    return prices, mask


def test_impact_and_fills():
    rng = np.random.default_rng(4)
    size = rng.normal(0, 5e4, 64)
    adv = np.where(rng.random(64) > 0.1, rng.uniform(1e4, 1e6, 64), 0.0)
    vol = rng.uniform(0.01, 0.05, 64)
    price = rng.uniform(5, 500, 64)
    side = np.sign(rng.normal(size=64))
    np.testing.assert_allclose(
        impact.square_root_impact(_t(size), _t(adv), _t(vol)).numpy(),
        np.asarray(jimpact.square_root_impact(size, adv, vol)), **TOL)
    for got, want in zip(impact.market_fill(_t(price), _t(size), _t(adv), _t(vol), _t(side)),
                         jimpact.market_fill(price, size, adv, vol, side)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the limit fill's draw: the same key fills the same orders
    for seed in (0, 9):
        got = impact.limit_fill(random.PRNGKey(seed), _t(price), _t(size), _t(adv),
                                _t(vol), aggressiveness=0.7)
        want = jimpact.limit_fill(jax.random.PRNGKey(seed), jnp.asarray(price),
                                  jnp.asarray(size), jnp.asarray(adv),
                                  jnp.asarray(vol), aggressiveness=0.7)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert 0 < int(got[0].sum()) < 64
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_long_short_weights_and_turnover():
    rng = np.random.default_rng(5)
    labels = rng.integers(-1, 5, size=(30, 12)).astype(np.int32)
    labels[:, 4] = np.where(labels[:, 4] == 4, 3, labels[:, 4])   # empty top bin
    counts = np.stack([(labels == b).sum(axis=0) for b in range(5)]).astype(np.int32)
    w = impact.long_short_weights(_t(labels), _t(counts), 5, dtype=torch.float64)
    jw = jimpact.long_short_weights(jnp.asarray(labels), jnp.asarray(counts), 5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    assert (w[:, 4] == 0).all()
    np.testing.assert_allclose(impact.turnover_cost(w, 0.001).numpy(),
                               np.asarray(jimpact.turnover_cost(jw, 0.001)), **TOL)


@pytest.mark.parametrize("mode", ["qcut", "rank"])
def test_sector_neutral_net_of_costs_matches_jax(mode):
    vals, mask = _monthly_panel()
    sid = np.random.default_rng(8).integers(-1, 3, size=vals.shape[0])
    # about 9 ranked names a sector: 5 bins keep both extremes filled
    res = monthly.sector_neutral_backtest(_t(vals), _t(mask), _t(sid), 3, n_bins=5,
                                          mode=mode)
    jres = jmonthly.sector_neutral_backtest(jnp.asarray(vals), jnp.asarray(mask),
                                            jnp.asarray(sid, dtype=jnp.int32), 3,
                                            n_bins=5, mode=mode)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(jres.labels))
    np.testing.assert_array_equal(res.decile_counts.numpy(), np.asarray(jres.decile_counts))
    assert res.spread_valid.any()
    for k in ("spread", "decile_means", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                   err_msg=k, **TOL)
    plain = monthly.sector_neutral_backtest(_t(vals), _t(mask), _t(sid), 3, n_bins=5,
                                            mode=mode, impl="plain")
    assert torch.equal(plain.decile_counts, res.decile_counts)
    for hs in (0.0005, 0.01):
        got = monthly.net_of_costs(res, half_spread=hs, n_bins=5)
        want = jmonthly.net_of_costs(jres, half_spread=hs, n_bins=5)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        arrays = monthly.net_of_costs_arrays(res.labels, res.decile_counts, res.spread,
                                             res.spread_valid, half_spread=hs,
                                             n_bins=5)
        np.testing.assert_allclose(arrays[0].numpy(), got[0].numpy(), **TOL)
    # costs only lower live months
    net = got[0].numpy()
    sv = res.spread_valid.numpy()
    assert (net[sv] <= res.spread.numpy()[sv]).all() and np.isnan(net[~sv]).all()


@pytest.fixture(scope="module")
def grids():
    prices, mask = _grid_panel()
    Js, Ks = np.array([3, 6, 12]), np.array([1, 3, 6])
    res = grid.jk_grid_backtest(_t(prices), _t(mask), Js, Ks, n_bins=5, mode="rank")
    jres = jgrid.jk_grid_backtest(jnp.asarray(prices), jnp.asarray(mask), Js, Ks,
                                  n_bins=5, mode="rank")
    return prices, mask, res, jres


def _assert_grid_close(got, want):
    np.testing.assert_array_equal(got.spread_valid.numpy(), np.asarray(want.spread_valid))
    for k in ("spreads", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   err_msg=k, **TOL)


def test_grid_net_of_costs_matches_jax(grids):
    """Exact overlapping-book turnover per (J, K) cell; break-evens and the
    re-priced levels from one unit-cost run."""
    prices, mask, res, jres = grids
    unit = grid.grid_net_of_costs(_t(prices), _t(mask), res, half_spread=1.0)
    junit = jgrid.grid_net_of_costs(prices, mask, jres, half_spread=1.0)
    _assert_grid_close(unit, junit)
    np.testing.assert_array_equal(unit.Ks.numpy(), [1, 3, 6])
    assert unit.mode == "rank" and unit.n_bins == 5

    net = grid.grid_net_of_costs(_t(prices), _t(mask), res, half_spread=0.002)
    _assert_grid_close(net, jgrid.grid_net_of_costs(prices, mask, jres,
                                                    half_spread=0.002))
    # re-pricing from the unit run equals a direct netting at that level
    _assert_grid_close(grid.grid_net_from_unit(res, unit, 0.002), net)
    _assert_grid_close(grid.grid_net_from_unit(res, unit, 0.002),
                       jgrid.grid_net_from_unit(jres, junit, 0.002))

    be, turn = grid.grid_break_even_bps(_t(prices), _t(mask), res, unit=unit)
    jbe, jturn = jgrid.grid_break_even_bps(prices, mask, jres, unit=junit)
    np.testing.assert_allclose(be.numpy(), np.asarray(jbe), **TOL)
    np.testing.assert_allclose(turn.numpy(), np.asarray(jturn), **TOL)
    be2, _ = grid.grid_break_even_bps(_t(prices), _t(mask), res)
    np.testing.assert_allclose(be2.numpy(), be.numpy(), **TOL)
    # a K-month book replaces about 1/K of itself a month
    t = turn.numpy()
    assert (t[:, 0] > t[:, 1]).all() and (t[:, 1] > t[:, 2]).all()


def test_grid_costs_need_build_parameters(grids):
    prices, mask, res, _ = grids
    bare = grid.GridResult(spreads=res.spreads, spread_valid=res.spread_valid,
                           mean_spread=res.mean_spread, ann_sharpe=res.ann_sharpe,
                           tstat=res.tstat, tstat_nw=res.tstat_nw)
    with pytest.raises(ValueError, match="build parameters"):
        grid.grid_net_of_costs(_t(prices), _t(mask), bare)
    with pytest.raises(ValueError, match="build parameters"):
        grid.grid_net_from_unit(bare, res, 0.001)


@pytest.mark.parametrize("impl", ["matmul", "matmul_bf16"])
def test_matmul_cohort_sums(impl, grids):
    """The cross-table forms: counts exact and equal to the kernel's (on the
    CPU, its plain version), sums equal to the reference's same form."""
    prices, mask, _, _ = grids
    rng = np.random.default_rng(12)
    labels = rng.integers(-1, 5, size=(3, 40, 120)).astype(np.int32)
    from csmom_tpu.signals.momentum import monthly_returns as jreturns

    ret, rv = (np.asarray(a) for a in jreturns(jnp.asarray(prices), jnp.asarray(mask)))
    s, c = grid._cohort_partial_sums(_t(labels), _t(ret), _t(rv), 5, 6, impl=impl)
    ks, kc = grid._cohort_partial_sums(_t(labels), _t(ret), _t(rv), 5, 6)
    assert torch.equal(c, kc)
    for j in range(3):
        js, jc = jgrid._cohort_partial_sums(jnp.asarray(labels[j]), jnp.asarray(ret),
                                            jnp.asarray(rv), 5, 6, impl=impl)
        np.testing.assert_array_equal(c[j].numpy(), np.asarray(jc))
        np.testing.assert_allclose(s[j].numpy(), np.asarray(js), **TOL)
    if impl == "matmul":
        np.testing.assert_allclose(s.numpy(), ks.numpy(), **TOL)
    else:
        # bf16 keeps 8 significant bits, so rounding to nearest moves a
        # return by at most 2**-8 of itself (the float32 sums of exact
        # bf16 products add ~n * 2**-24 on top): a sum is off by at most
        # 2**-8 * sum|r|
        absum, _ = grid._cohort_partial_sums(
            _t(labels), _t(np.abs(np.nan_to_num(ret))), _t(rv), 5, 6)
        assert (torch.abs(s - ks) <= 2.0**-8 * absum + 1e-12).all()


def test_bf16_counts_exact_past_256():
    """bf16 holds integers exactly only to 256: the counts must still be
    exact at 300+ members a side (they accumulate in float32)."""
    a, m = 700, 8
    labels = np.zeros((1, a, m), np.int32)
    labels[0, 400:] = 4
    valid = np.ones((a, m), bool)
    ret = np.full((a, m), 0.01)
    s, c = grid._cohort_partial_sums(_t(labels), _t(ret), _t(valid), 5, 3,
                                     impl="matmul_bf16")
    _, kc = grid._cohort_partial_sums(_t(labels), _t(ret), _t(valid), 5, 3,
                                      impl="plain")
    assert torch.equal(c, kc) and int(c[0, 0, 0, 0]) == 400 and int(c[0, 1, 0, 0]) == 300


def test_grid_backtest_matmul_impls(grids):
    prices, mask, res, jres = grids
    for impl in ("matmul", "matmul_bf16"):
        got = grid.jk_grid_backtest(_t(prices), _t(mask), [3, 6, 12], [1, 3, 6],
                                    n_bins=5, mode="rank", impl=impl)
        assert torch.equal(got.spread_valid, res.spread_valid)
        if impl == "matmul":
            _assert_grid_close(got, jres)
    with pytest.raises(ValueError, match="unknown impl"):
        grid.jk_grid_backtest(_t(prices), _t(mask), [3], [1], impl="pallas")

