"""The port's sharded monthly, banded and grid engines, its collective
``rank_hist`` and its sharded bootstrap, at 1, 2, 4 and 8 logical CPU
shards (and 2 x 4 for the grid), against the port's single-device
engines and csmom_tpu's, in f64: labels, counts and validity equal, floats
within ``rtol=1e-10, atol=1e-13``.  The monthly engine, the grid (rank and
qcut) and ``rank_hist`` are also held against csmom_tpu's sharded engines
on the eight host devices the suite configures, at the reference's own
tiny shapes (``tests/test_sharding.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.analytics import bootstrap as jboot
from csmom_tpu.backtest import banded as jbanded
from csmom_tpu.backtest import grid as jgrid
from csmom_tpu.backtest import monthly as jmonthly
from csmom_tpu_torch import random
from csmom_tpu_torch.analytics.bootstrap import block_bootstrap
from csmom_tpu_torch.backtest.banded import banded_monthly_backtest
from csmom_tpu_torch.backtest.grid import jk_grid_backtest
from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
from csmom_tpu_torch.ops.ranking import decile_assign_panel
from csmom_tpu_torch.parallel.bootstrap import sharded_block_bootstrap
from csmom_tpu_torch.parallel.collectives import (
    sharded_banded_backtest,
    sharded_jk_grid_backtest,
    sharded_monthly_spread_backtest,
)
from csmom_tpu_torch.parallel.compat import P, shard_map
from csmom_tpu_torch.parallel.histrank import histogram_rank_labels
from csmom_tpu_torch.parallel.mesh import make_mesh, pad_assets

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13)
SHARDS = (1, 2, 4, 8)
JS, KS = [3, 6, 9, 12], [1, 3, 6]


def _panel(seed=0, A=37, M=72):
    rng = np.random.default_rng(seed)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.003, 0.07, size=(A, M)), axis=1))
    prices[:5, :12] = np.nan          # late entrants
    prices[-3:, 50:] = np.nan         # delistings
    prices[rng.random((A, M)) < 0.02] = np.nan
    return prices, np.isfinite(prices)


@pytest.fixture(scope="module")
def panel():
    return _panel()


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               equal_nan=True, err_msg=what)


def _sharded_inputs(prices, mask, n):
    pv, mv, _ = pad_assets(prices, mask, n)
    return torch.as_tensor(pv), torch.as_tensor(mv)


@pytest.mark.parametrize("mode", ["qcut", "rank", "rank_hist"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_monthly_equals_both_single_device_engines(panel, n, mode):
    prices, mask = panel
    single_mode = "rank" if mode == "rank_hist" else mode
    ours = monthly_spread_backtest(torch.as_tensor(prices), torch.as_tensor(mask),
                                   mode=single_mode)
    ref = jmonthly.monthly_spread_backtest(jnp.asarray(prices), jnp.asarray(mask),
                                           mode=single_mode)
    spread, valid, mean, sh, ts = sharded_monthly_spread_backtest(
        *_sharded_inputs(prices, mask, n), make_mesh(["cpu"] * n), mode=mode)
    for want_valid, want in ((ours.spread_valid.numpy(), ours),
                             (np.asarray(ref.spread_valid), ref)):
        np.testing.assert_array_equal(valid.numpy(), want_valid)
        _close(spread, np.asarray(want.spread), "spread")
        for got, field in ((mean, "mean_spread"), (sh, "ann_sharpe"), (ts, "tstat")):
            _close(got, np.asarray(getattr(want, field)), field)


@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("layout", [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4), (4, 2)])
def test_sharded_grid_equals_both_single_device_engines(panel, layout, mode):
    g, a = layout
    prices, mask = panel
    ours = jk_grid_backtest(torch.as_tensor(prices), torch.as_tensor(mask), JS, KS,
                            mode=mode)
    ref = jgrid.jk_grid_backtest(jnp.asarray(prices), jnp.asarray(mask),
                                 jnp.asarray(JS), jnp.asarray(KS), mode=mode)
    res = sharded_jk_grid_backtest(*_sharded_inputs(prices, mask, a), JS, KS,
                                   make_mesh(["cpu"] * (g * a), grid_axis=g),
                                   mode=mode)
    for want in (ours, ref):
        np.testing.assert_array_equal(res.spread_valid.numpy(),
                                      np.asarray(want.spread_valid))
        for f in ("spreads", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
            _close(getattr(res, f), np.asarray(getattr(want, f)), f)
    assert res.Js.tolist() == JS and res.Ks.tolist() == KS
    assert (res.n_bins, res.mode, int(res.skip)) == (10, mode, 1)


@pytest.mark.parametrize("impl", ["plain", "matmul"])
def test_sharded_grid_takes_every_impl(panel, impl):
    prices, mask = panel
    ours = jk_grid_backtest(torch.as_tensor(prices), torch.as_tensor(mask), JS, KS,
                            mode="rank", impl=impl)
    res = sharded_jk_grid_backtest(*_sharded_inputs(prices, mask, 4), JS, KS,
                                   make_mesh(["cpu"] * 8, grid_axis=2),
                                   mode="rank", impl=impl)
    np.testing.assert_array_equal(res.spread_valid.numpy(), ours.spread_valid.numpy())
    _close(res.spreads, ours.spreads.numpy())


@pytest.mark.parametrize("band", [0, 2])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_banded_equals_both_single_device_engines(panel, n, band):
    prices, mask = panel
    ours = banded_monthly_backtest(torch.as_tensor(prices), torch.as_tensor(mask),
                                   band=band)
    ref = jbanded.banded_monthly_backtest(jnp.asarray(prices), jnp.asarray(mask),
                                          band=band)
    spread, valid, mean, sh, ts_nw = sharded_banded_backtest(
        *_sharded_inputs(prices, mask, n), make_mesh(["cpu"] * n), band=band)
    for want in (ours, ref):
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want.spread_valid))
        _close(spread, np.asarray(want.spread), "spread")
        for got, field in ((mean, "mean_spread"), (sh, "ann_sharpe"),
                           (ts_nw, "tstat_nw")):
            _close(got, np.asarray(getattr(want, field)), field)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_bootstrap_equals_both_single_device_bootstraps(n):
    rng = np.random.default_rng(3)
    r = rng.normal(0.01, 0.05, size=96)
    v = rng.random(96) > 0.1
    ours = block_bootstrap(torch.as_tensor(r), torch.as_tensor(v), random.PRNGKey(5),
                           n_samples=160, index_dtype=torch.int64)
    ref = jboot.block_bootstrap(jnp.asarray(r), jnp.asarray(v), jax.random.PRNGKey(5),
                                n_samples=160)
    got = sharded_block_bootstrap(torch.as_tensor(r), torch.as_tensor(v),
                                  random.PRNGKey(5), make_mesh(["cpu"] * n),
                                  n_samples=160, index_dtype=torch.int64)
    for want in (ours, ref):
        for f in ("mean_samples", "sharpe_samples", "mean_point", "sharpe_point",
                  "mean_ci", "sharpe_ci"):
            _close(getattr(got, f), np.asarray(getattr(want, f)), f)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_block_bootstrap(torch.as_tensor(r), torch.as_tensor(v),
                                random.PRNGKey(5), make_mesh(["cpu"] * 3),
                                n_samples=160)


def _hard_panel(A=40, M=9):
    """Ties, signed zeros, infinities, empty and one-lane months."""
    rng = np.random.default_rng(11)
    x = rng.integers(-4, 5, size=(A, M)).astype(np.float64) / 4
    x[::7, 1] = -0.0
    x[3, 2], x[4, 2] = np.inf, -np.inf
    valid = rng.random((A, M)) > 0.2
    valid[:, 3] = False
    valid[:, 4] = False
    valid[7, 4] = True
    x[:, 5] = 1.0                                   # one tie across the month
    return torch.as_tensor(x), torch.as_tensor(valid)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", SHARDS)
def test_rank_hist_labels_equal_rank_labels(n, dtype):
    x, valid = _hard_panel()
    x = x.to(dtype)
    rank, _ = decile_assign_panel(x, valid, n_bins=10, mode="rank")
    spec = P("assets", None)
    for bits in (1, 4):
        got = shard_map(lambda a, b: histogram_rank_labels(a, b, 10, "assets",
                                                           bits_per_round=bits),
                        mesh=make_mesh(["cpu"] * n), in_specs=(spec, spec),
                        out_specs=spec)(x, valid)
        assert got.dtype == torch.int32
        assert torch.equal(got, rank), (n, bits)


# -- against csmom_tpu's own sharded engines on 8 host devices ------------


@pytest.fixture(scope="module")
def eight():
    if len(jax.devices()) < 8:
        pytest.skip("8 host devices not configured")
    return jax.devices()[:8]


def test_monthly_equals_the_reference_sharded_engine(eight):
    from csmom_tpu.parallel import make_mesh as jmake_mesh
    from csmom_tpu.parallel import sharded_monthly_spread_backtest as jsharded

    prices, mask = _panel(1, A=37, M=60)
    pv, mv, _ = pad_assets(prices, mask, 8)
    want = jsharded(pv, mv, jmake_mesh(eight, grid_axis=1))
    got = sharded_monthly_spread_backtest(torch.as_tensor(pv), torch.as_tensor(mv),
                                          make_mesh(["cpu"] * 8))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


@pytest.mark.parametrize("mode", ["rank", "qcut", "rank_hist"])
def test_grid_equals_the_reference_sharded_engine(eight, mode):
    from csmom_tpu.parallel import make_mesh as jmake_mesh
    from csmom_tpu.parallel import sharded_jk_grid_backtest as jsharded

    prices, mask = _panel(2, A=29, M=72)
    pv, mv, _ = pad_assets(prices, mask, 4)
    Js, Ks = [6, 12], [1, 3, 6]
    want = jsharded(pv, mv, np.array(Js), np.array(Ks),
                    jmake_mesh(eight, grid_axis=2), mode=mode)
    got = sharded_jk_grid_backtest(torch.as_tensor(pv), torch.as_tensor(mv), Js, Ks,
                                   make_mesh(["cpu"] * 8, grid_axis=2), mode=mode)
    np.testing.assert_array_equal(got.spread_valid.numpy(),
                                  np.asarray(want.spread_valid))
    for f in ("spreads", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        _close(getattr(got, f), np.asarray(getattr(want, f)), f)
