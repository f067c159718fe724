"""The port's turnover features and residual momentum against csmom_tpu's,
on the CPU in f64: ``shares_outstanding_vector``, ``turnover_features``,
``volume_tercile_labels``, ``residual_momentum`` (every valid window pair and
its refusal), ``residual_momentum_sweep`` and ``residual_sweep_backtest``,
whose structurally invalid cells are all NaN on both sides.

Tolerances: f64 ``rtol=1e-10, atol=1e-13``, integers exactly.  One cell
kind is held otherwise: where ``est_window == lookback`` the residuals'
mean is zero by construction (an OLS with intercept over the same
window), so the score is rounding noise below 1e-12 on both sides, and so
are its ranks and, in qcut mode, which bins stay populated; there both
sides' scores are held to be that noise, and the backtest is not compared
(ROADMAP.md, known differences).  ``lookback=1`` is scaled by nothing: the
std of one residual is zero by definition.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.signals import residual as jres
from csmom_tpu.signals import turnover as jturn
from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
from csmom_tpu_torch.panel.panel import to_tensors
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
from csmom_tpu_torch.signals import residual as tres
from csmom_tpu_torch.signals import turnover as tturn

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13)


@pytest.fixture(scope="module")
def panel():
    daily = synthetic_daily_panel(50, 1260, seed=21, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device="cpu")
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    rng = np.random.default_rng(22)
    vol = np.where(mm.numpy(), rng.uniform(1e5, 5e7, size=pm.shape), 0.0)
    vmask = mm.numpy() & (rng.random(pm.shape) > 0.03)
    return pm.numpy(), mm.numpy(), vol, vmask


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), equal_nan=True, **TOL)


def test_shares_outstanding_vector_equals_the_reference():
    tickers = ["A", "B", "C", "D", "E", "F", "G", "H"]
    info = {
        "A": {"shares_outstanding": 1.5e9},
        "B": {"shares_outstanding": None, "market_cap": 3.0e11},
        "C": {"shares_outstanding": float("nan"), "market_cap": 7.7e10},
        "D": {"market_cap": float("nan")},
        "E": {"market_cap": 5.0e10},          # no positive price
        "F": None,
        "G": {"shares_outstanding": 2, "market_cap": 1e9},
    }
    last = np.array([10.0, 150.0, 33.3, 12.0, -1.0, 5.0, 7.0, np.nan])
    got = tturn.shares_outstanding_vector(tickers, info, last)
    want = jturn.shares_outstanding_vector(tickers, info, last)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tturn.shares_outstanding_vector(tickers, info),
                                  jturn.shares_outstanding_vector(tickers, info))
    np.testing.assert_array_equal(tturn.shares_outstanding_vector(tickers, None),
                                  jturn.shares_outstanding_vector(tickers, None))


@pytest.mark.parametrize("lookback", [1, 3, 6])
def test_turnover_features_equal_the_reference(panel, lookback):
    _, _, vol, vmask = panel
    shares = np.random.default_rng(4).uniform(1e7, 1e9, size=vol.shape[0])
    shares[[0, 5]] = np.nan
    shares[7] = 0.0
    got = tturn.turnover_features(torch.as_tensor(vol), torch.as_tensor(vmask),
                                  shares, lookback=lookback)
    want = jturn.turnover_features(vol, vmask, shares, lookback=lookback)
    assert set(got) == set(want) == {"adv_est", "turnover_monthly", "turn_avg"}
    for k in want:
        _close(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1].numpy(), np.asarray(want[k][1]))


@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("n_vol_bins", [2, 3, 5])
def test_volume_tercile_labels_equal_the_reference(panel, mode, n_vol_bins):
    _, _, vol, vmask = panel
    ft = tturn.turnover_features(torch.as_tensor(vol), torch.as_tensor(vmask),
                                 np.ones(vol.shape[0]), lookback=3)["turn_avg"]
    fj = jturn.turnover_features(vol, vmask, np.ones(vol.shape[0]), lookback=3)["turn_avg"]
    got, g_eff = tturn.volume_tercile_labels(*ft, n_vol_bins=n_vol_bins, mode=mode)
    want, w_eff = jturn.volume_tercile_labels(*fj, n_vol_bins=n_vol_bins, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(g_eff.numpy(), np.asarray(w_eff))


@pytest.mark.parametrize("lookback,skip,est_window,scale", [
    (12, 1, 36, True), (12, 1, 36, False), (6, 0, 24, True), (3, 2, 12, True),
    (1, 1, 3, False), (12, 1, 12, True), (6, 1, 48, False),
])
def test_residual_momentum_equals_the_reference(panel, lookback, skip, est_window, scale):
    pm, mm, *_ = panel
    got, gv = tres.residual_momentum(torch.as_tensor(pm), torch.as_tensor(mm),
                                     lookback=lookback, skip=skip,
                                     est_window=est_window, scale_by_vol=scale)
    want, wv = jres.residual_momentum(jnp.asarray(pm), jnp.asarray(mm),
                                      lookback=lookback, skip=skip,
                                      est_window=est_window, scale_by_vol=scale)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gv.any()
    _close(got, want)


def test_residual_momentum_refuses_short_estimation_windows(panel):
    pm, mm, *_ = panel
    for lb, w in ((12, 6), (2, 2)):
        with pytest.raises(ValueError) as got:
            tres.residual_momentum(torch.as_tensor(pm), torch.as_tensor(mm),
                                   lookback=lb, est_window=w)
        with pytest.raises(ValueError) as want:
            jres.residual_momentum(jnp.asarray(pm), jnp.asarray(mm),
                                   lookback=lb, est_window=w)
        assert str(got.value) == str(want.value)


JS_, WS_ = [3, 6, 12], [2, 12, 24, 36]   # W=2 and (12, 12): invalid cells


def test_residual_momentum_sweep_equals_the_reference(panel):
    pm, mm, *_ = panel
    got, gv = tres.residual_momentum_sweep(torch.as_tensor(pm), torch.as_tensor(mm),
                                           JS_, WS_, skip=1)
    want, wv = jres.residual_momentum_sweep(jnp.asarray(pm), jnp.asarray(mm),
                                            np.asarray(JS_), np.asarray(WS_), skip=1)
    assert tuple(got.shape) == (3, 4) + pm.shape
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    _close(got, want)
    assert not gv[:, 0].any() and torch.isnan(got[:, 0]).all()   # W=2 < 3


@pytest.mark.parametrize("mode", ["rank", "qcut"])
def test_residual_sweep_backtest_equals_the_reference(panel, mode):
    pm, mm, *_ = panel
    got = tres.residual_sweep_backtest(torch.as_tensor(pm), torch.as_tensor(mm),
                                       JS_, WS_, skip=1, n_bins=5, mode=mode)
    want = jres.residual_sweep_backtest(jnp.asarray(pm), jnp.asarray(mm),
                                        np.asarray(JS_), np.asarray(WS_), skip=1,
                                        n_bins=5, mode=mode)
    assert tuple(got.spreads.shape) == (3, 4, pm.shape[1])
    # the cells whose score is rounding noise (est_window == lookback)
    noise = np.array([[j == w for w in WS_] for j in JS_])
    np.testing.assert_array_equal(got.spread_valid.numpy()[~noise],
                                  np.asarray(want.spread_valid)[~noise])
    for f in ("spreads", "mean_spread", "ann_sharpe", "tstat", "tstat_nw"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_allclose(a[~noise], b[~noise], equal_nan=True, err_msg=f, **TOL)
    # structurally invalid cells (est_window < max(lookback, 3)): all NaN
    for i, j in enumerate(JS_):
        for k, w in enumerate(WS_):
            if w < max(j, 3):
                assert not got.spread_valid[i, k].any()
                assert torch.isnan(got.spreads[i, k]).all()
                assert np.isnan(np.asarray(want.spreads)[i, k]).all()
                assert np.isnan(got.mean_spread[i, k].item())
    # the noise cell's score is zero up to rounding on both sides
    s_t, v_t = tres.residual_momentum(torch.as_tensor(pm), torch.as_tensor(mm),
                                      lookback=12, est_window=12)
    s_j, _ = jres.residual_momentum(jnp.asarray(pm), jnp.asarray(mm),
                                    lookback=12, est_window=12)
    assert np.nanmax(np.abs(s_t.numpy())) < 1e-12
    assert np.nanmax(np.abs(np.asarray(s_j))) < 1e-12
