"""The port's asset-sharded and time-sharded event engines and its
time-sharded online ridge, at 1, 2, 4 and 8 logical CPU shards, against
the port's single-device engines and csmom_tpu's, in f64, within the
reference's own limits (``tests/test_sequence_parallel.py``,
``tests/test_online_ridge_sharded.py``): integer state (positions, sides,
counts, bars) equal, floats close."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.backtest import event as jevent
from csmom_tpu.models.online_ridge import online_ridge_scores as jax_online
from csmom_tpu_torch import random
from csmom_tpu_torch.backtest.event import event_backtest, hysteresis_event_backtest
from csmom_tpu_torch.models.online_ridge import online_ridge_scores
from csmom_tpu_torch.parallel.event import (
    sharded_event_backtest,
    sharded_hysteresis_backtest,
)
from csmom_tpu_torch.parallel.event_time import (
    pad_time,
    time_sharded_event_backtest,
    time_sharded_hysteresis_backtest,
)
from csmom_tpu_torch.parallel.mesh import make_mesh
from csmom_tpu_torch.parallel.online_ridge import time_sharded_online_ridge_scores

torch.set_num_threads(2)


def _scenario(seed=0, A=8, T=80):
    rng = np.random.default_rng(seed)
    price = 100 * np.exp(np.cumsum(rng.normal(0, 1e-3, size=(A, T)), axis=1))
    valid = rng.random((A, T)) > 0.2
    score = rng.normal(0, 1e-4, size=(A, T))
    score[np.abs(score) < 2e-5] = 0.0
    valid[:, :20] &= np.arange(A)[:, None] < 2   # sparse early blocks
    valid[A - 1, :] = False
    valid[A - 1, 25:30] = True                   # one asset in one block only
    score[A - 1, 25:30] = 5e-4
    adv = np.linspace(5e4, 2e6, A)
    vol = np.linspace(0.01, 0.4, A)
    price[~valid] = np.nan
    return price, valid, score, adv, vol


@pytest.fixture(scope="module")
def scenario():
    return _scenario()


def _t(args):
    return tuple(torch.as_tensor(a) for a in args)


def _assert_equal(got, want):
    np.testing.assert_allclose(got.pnl.numpy(), np.asarray(want.pnl), rtol=1e-9, atol=1e-7)
    np.testing.assert_array_equal(got.bar_mask.numpy(), np.asarray(want.bar_mask))
    for f in ("portfolio_value", "cash", "exec_price"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-12, err_msg=f)
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_array_equal(got.trade_side.numpy(), np.asarray(want.trade_side))
    np.testing.assert_allclose(got.impact.numpy(), np.asarray(want.impact), rtol=1e-12)
    for f in ("total_pnl", "net_notional"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) < 1e-6, f
    for f in ("n_trades", "n_buys", "n_sells"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert got.positions.dtype == torch.int32 and got.trade_side.dtype == torch.int8


def _references(scenario, **kw):
    price, valid, score, adv, vol = scenario
    ours = event_backtest(*_t(scenario), **kw)
    jkw = dict(kw)
    if "fill_key" in jkw:
        jkw["fill_key"] = jax.random.PRNGKey(0)
    ref = jevent.event_backtest(jnp.asarray(price), jnp.asarray(valid),
                                jnp.asarray(score), jnp.asarray(adv),
                                jnp.asarray(vol), **jkw)
    return ours, ref


ORDERS = {"market": {}, "limit": {"order_type": "limit"}}


@pytest.mark.parametrize("latency", [0, 3])
@pytest.mark.parametrize("order", ["market", "limit"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_asset_sharded_event_equals_both_engines(scenario, n, order, latency):
    kw = dict(ORDERS[order], latency_bars=latency)
    if order == "limit":
        kw["fill_key"] = random.PRNGKey(0)
    got = sharded_event_backtest(*_t(scenario), make_mesh(["cpu"] * n), **kw)
    for want in _references(scenario, **kw):
        _assert_equal(got, want)


@pytest.mark.parametrize("latency", [0, 3, 10])
@pytest.mark.parametrize("order", ["market", "limit"])
@pytest.mark.parametrize("layout", [(1, 1), (1, 2), (1, 4), (2, 2), (1, 8), (2, 4)])
def test_time_sharded_event_equals_both_engines(scenario, layout, order, latency):
    a, t = layout  # latency 10: the block length at 8 time shards
    kw = dict(ORDERS[order], latency_bars=latency)
    if order == "limit":
        kw["fill_key"] = random.PRNGKey(0)
    mesh = make_mesh(["cpu"] * (a * t), grid_axis=a, axis_names=("assets", "time"))
    got = time_sharded_event_backtest(*_t(scenario), mesh,
                                      asset_axis="assets" if a > 1 else None, **kw)
    for want in _references(scenario, **kw):
        _assert_equal(got, want)


@pytest.mark.parametrize("layout", [(1, 4), (2, 2), (1, 8)])
def test_time_sharded_hysteresis_equals_both_engines(scenario, layout):
    a, t = layout
    price, valid, score, adv, vol = scenario
    mesh = make_mesh(["cpu"] * (a * t), grid_axis=a, axis_names=("assets", "time"))
    got = time_sharded_hysteresis_backtest(*_t(scenario), mesh,
                                           asset_axis="assets" if a > 1 else None,
                                           threshold_hi=1e-4, threshold_lo=2e-5)
    ours = hysteresis_event_backtest(*_t(scenario), 1e-4, 2e-5)
    ref = jevent.hysteresis_event_backtest(
        jnp.asarray(price), jnp.asarray(valid), jnp.asarray(score),
        jnp.asarray(adv), jnp.asarray(vol), 1e-4, 2e-5)
    for want in (ours, ref):
        _assert_equal(got, want)
    assert int(got.n_trades) > 0 and int((got.trade_side.abs() == 2).sum()) > 0


@pytest.mark.parametrize("latency", [0, 3])
def test_asset_sharded_hysteresis_equals_the_engine(scenario, latency):
    got = sharded_hysteresis_backtest(*_t(scenario), make_mesh(["cpu"] * 4),
                                      threshold_hi=1e-4, threshold_lo=2e-5,
                                      latency_bars=latency)
    _assert_equal(got, hysteresis_event_backtest(*_t(scenario), 1e-4, 2e-5,
                                                 latency_bars=latency))


def test_pad_time_and_refusals(scenario):
    price, valid, score, adv, vol = _scenario(1, A=4, T=75)
    pp, vp, sp, T0 = pad_time(price, valid, score, 8)
    assert pp.shape[1] == 80 and T0 == 75
    mesh = make_mesh(["cpu"] * 8, grid_axis=1, axis_names=("assets", "time"))
    got = time_sharded_event_backtest(*_t((pp, vp, sp, adv, vol)), mesh)
    want = event_backtest(*_t((price, valid, score, adv, vol)))
    np.testing.assert_allclose(got.pnl.numpy()[:T0], want.pnl.numpy(), rtol=1e-9, atol=1e-7)
    np.testing.assert_array_equal(got.positions.numpy()[:, :T0], want.positions.numpy())
    assert not got.bar_mask.numpy()[T0:].any()
    assert int(got.n_trades) == int(want.n_trades)
    args = _t(scenario)
    with pytest.raises(ValueError, match="latency_bars"):
        time_sharded_event_backtest(*args, mesh, latency_bars=11)
    with pytest.raises(ValueError, match="fill_key"):
        time_sharded_event_backtest(*args, mesh, order_type="limit")
    with pytest.raises(ValueError, match="order_type"):
        time_sharded_event_backtest(*args, mesh, order_type="iceberg")
    with pytest.raises(ValueError, match="pad_time"):
        time_sharded_event_backtest(*(a[:, :77] for a in args[:3]), *args[3:], mesh)
    with pytest.raises(ValueError, match="no 'time'"):
        time_sharded_event_backtest(*args, make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="pad_assets"):
        sharded_event_backtest(*args, make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="threshold_lo"):
        time_sharded_hysteresis_backtest(*args, mesh, threshold_hi=1e-5,
                                         threshold_lo=1e-4)


def _ridge_panel(A=4, R=90, F=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(A, R, F)), rng.normal(scale=1e-2, size=(A, R)),
            rng.random((A, R)) > 0.15)


def _assert_fit_equal(got, want):
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-8, atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(got.cv_mse.numpy(), np.asarray(want.cv_mse), rtol=1e-8)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(float(got.intercept), float(want.intercept),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.scale_mean.numpy(), np.asarray(want.scale_mean),
                               rtol=1e-8)
    np.testing.assert_allclose(got.scale_std.numpy(), np.asarray(want.scale_std),
                               rtol=1e-8)
    assert int(got.n_train) == int(want.n_train)


@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_time_sharded_online_ridge_equals_both_walks(n, standardize):
    feats, y, valid = _ridge_panel(R=85)   # padded rows above one shard
    kw = dict(alpha=0.7, burn_in=12, standardize=standardize)
    ours = online_ridge_scores(*_t((feats, y, valid)), **kw)
    ref = jax_online(jnp.asarray(feats), jnp.asarray(y), jnp.asarray(valid), **kw)
    # a ("grid", "time") mesh; at 2 time shards two grid copies compute
    # the same blocks
    g = 2 if n == 2 else 1
    mesh = make_mesh(["cpu"] * (g * n), grid_axis=g, axis_names=("grid", "time"))
    got = time_sharded_online_ridge_scores(*_t((feats, y, valid)), mesh, **kw)
    assert got.scores.shape == ours.scores.shape
    for want in (ours, ref):
        _assert_fit_equal(got, want)


def test_time_sharded_online_ridge_is_strictly_causal():
    """Moving a late row's label moves no score at or before it."""
    feats, y, valid = _ridge_panel(seed=2)
    mesh = make_mesh(["cpu"] * 4, axis_names=("grid", "time"))
    base = time_sharded_online_ridge_scores(*_t((feats, y, valid)), mesh, burn_in=10)
    y2 = y.copy()
    y2[:, 70] += 1.0
    moved = time_sharded_online_ridge_scores(*_t((feats, y2, valid)), mesh, burn_in=10)
    np.testing.assert_array_equal(base.scores.numpy()[:, :71],
                                  moved.scores.numpy()[:, :71])
    assert not np.allclose(base.scores.numpy()[:, 72:], moved.scores.numpy()[:, 72:],
                           equal_nan=True)
