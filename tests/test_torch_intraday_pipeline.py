"""The port's ``intraday_pipeline`` against csmom_tpu's in float64: every
score model on a seeded minute frame, the JAX package's ``EVENT`` and
``ONLINE`` golden fingerprints on the CPU, the empty-minute-frame
fallback, the errors and warnings, the default device, and the
``INTRADAY`` pins ``chip_smoke.py`` holds the card to.

Tolerances as ``tests/test_torch_models.py``: f64 ``rtol=1e-10,
atol=1e-13`` and integers equal; the MLP's scores ``rtol=1e-9,
atol=1e-13`` and its MSEs ``rtol=1e-10``; the per-bar PnL within 1e-15 of
the portfolio value (a difference of values near 1e6).
"""

import importlib.util
import logging
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from csmom_tpu import api as japi
from csmom_tpu.backtest import event as jevent
from csmom_tpu_torch import api

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)
MLP_SCORE_TOL = dict(rtol=1e-9, atol=1e-13, equal_nan=True)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(n_assets, n_days, seed):
    from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

    daily = synthetic_daily_panel(n_assets, n_days, seed=seed)
    a, t = len(daily.tickers), len(daily.times)
    v = daily.values.T.ravel()
    df = pd.DataFrame({"date": np.repeat(daily.times, a), "ticker": np.tile(daily.tickers, t),
                       "open": v, "close": v, "adj_close": v, "volume": 1e6})
    minutes = api.synthetic_minute_frame(df, seed=seed)
    # missing minutes, so row counts differ between tickers
    minutes = minutes[np.random.default_rng(seed).random(len(minutes)) > 0.03]
    return minutes.reset_index(drop=True), df


@pytest.fixture(scope="module")
def frames():
    return _frames(5, 3, 41)


def _assert_pipeline(got, want, score_tol=TOL):
    res, fit, compact, score, price, valid = got
    jres, jfit, jcompact, jscore, jprice, jvalid = want
    assert compact.tickers == jcompact.tickers
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(price.numpy(), np.asarray(jprice), **TOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **score_tol)
    assert int(fit.n_train) == int(jfit.n_train)
    np.testing.assert_allclose(fit.cv_mse.numpy(), np.asarray(jfit.cv_mse),
                               rtol=1e-10, atol=0)
    for f in ("n_trades", "n_buys", "n_sells"):
        assert int(getattr(res, f)) == int(getattr(jres, f)), f
    np.testing.assert_array_equal(res.trade_side.numpy(), np.asarray(jres.trade_side))
    np.testing.assert_allclose(res.cash.numpy(), np.asarray(jres.cash), **TOL)
    np.testing.assert_allclose(float(res.total_pnl), float(jres.total_pnl), rtol=1e-10)


@pytest.mark.parametrize("model,kw", [
    ("ridge", {}), ("ridge", {"latency_bars": 2, "alpha": 5.0}),
    ("online_ridge", {}), ("elastic_net", {"l1_ratio": 0.3}), ("lasso", {}),
    ("mlp", {}),
])
def test_pipeline_equals_the_reference(frames, model, kw):
    minutes, daily = frames
    want = japi.intraday_pipeline(minutes, daily, model=model, **kw)
    got = api.intraday_pipeline(minutes, daily, model=model, device="cpu", **kw)
    assert got[3].dtype == torch.float64 and got[3].device.type == "cpu"
    _assert_pipeline(got, want, MLP_SCORE_TOL if model == "mlp" else TOL)


def test_pipeline_without_daily_bars_takes_the_fallback_risk_maps(frames):
    minutes, _ = frames
    _assert_pipeline(api.intraday_pipeline(minutes, None, device="cpu"),
                     japi.intraday_pipeline(minutes, None))


def test_empty_minute_frame_synthesizes_minutes_from_daily_bars():
    _, daily = _frames(4, 2, 7)
    empty = pd.DataFrame(columns=["datetime", "ticker", "price", "volume"])
    got = api.intraday_pipeline(empty, daily, device="cpu")
    _assert_pipeline(got, japi.intraday_pipeline(empty, daily))
    assert len(got[2].times) == 2 * 390
    with pytest.raises(ValueError, match="no intraday rows and no daily bars"):
        api.intraday_pipeline(empty, daily.iloc[:0], device="cpu")


def test_unknown_model_raises(frames):
    with pytest.raises(ValueError, match="unknown model 'svm'"):
        api.intraday_pipeline(*frames, model="svm", device="cpu")


def test_lasso_that_zeroes_every_coefficient_warns(frames, caplog):
    with caplog.at_level(logging.WARNING, logger="csmom_tpu_torch.api"):
        res, fit, *_ = api.intraday_pipeline(*frames, model="lasso", alpha=1e-3,
                                             device="cpu")
    assert int((fit.coef != 0).sum()) == 0
    assert "lasso with alpha=0.001 zeroed every coefficient" in caplog.text


def test_default_device_raises_without_a_card(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.intraday_pipeline(*frames)
    from csmom_tpu_torch.workloads import golden_event_inputs

    with pytest.raises(RuntimeError, match="device='cpu'"):
        golden_event_inputs()


@pytest.fixture(scope="module")
def golden():
    return _chip_smoke().golden_minute_frame()


@pytest.mark.parametrize("model,pin", [("ridge", "EVENT"), ("online_ridge", "ONLINE")])
def test_golden_fingerprints_on_the_cpu(golden, model, pin):
    """The JAX package's committed fingerprints (its
    tests/test_synthetic_golden.py), with the rules the smoke applies on
    the card."""
    spec = importlib.util.spec_from_file_location(
        "synthetic_golden", os.path.join(_REPO, "tests", "test_synthetic_golden.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    smoke = _chip_smoke()
    assert getattr(smoke, pin) == getattr(ref, pin)
    minutes, daily = golden
    assert len(minutes) == 31_200
    res, fit, *_ = api.intraday_pipeline(minutes, daily, model=model, device="cpu")
    smoke.check_event_golden(res, fit, getattr(smoke, pin), pin)


def test_golden_event_inputs_have_the_reference_shape():
    from csmom_tpu_torch.workloads import golden_event_inputs

    price, valid, score, adv, vol, n_trades = golden_event_inputs(device="cpu")
    assert price.shape == valid.shape == score.shape == (20, 7 * 390)
    assert adv.shape == vol.shape == (20,) and bool(torch.isfinite(score).all())
    assert 0 < n_trades == int((torch.abs(score[valid]) > 1e-5).sum())


def _jax_intraday_fingerprints():
    """``INTRADAY``'s layout from csmom_tpu on the golden frame (f64)."""
    minutes, daily = _chip_smoke().golden_minute_frame()
    out = {}
    _, _, compact, score, price, valid = japi.intraday_pipeline(minutes, daily)
    for model in ("elastic_net", "lasso", "mlp"):
        r, f, *_ = japi.intraday_pipeline(minutes, daily, model=model)
        cv = np.asarray(f.cv_mse).tolist()
        if model == "mlp":
            s = np.nan_to_num(np.asarray(f.scores))
            out[model] = {"cv_mse": cv, "train_mse": float(f.train_mse),
                          "score_sum": float(s.sum()), "score_abs_sum": float(np.abs(s).sum())}
        else:
            out[model] = {"n_nonzero": int((np.asarray(f.coef) != 0).sum()), "cv_mse": cv,
                          "n_trades": int(r.n_trades), "total_pnl": float(r.total_pnl)}
    adv, vol = japi.daily_risk_maps(daily, compact.tickers)
    sc = np.nan_to_num(np.asarray(score))
    h = jevent.hysteresis_event_backtest(price, valid, sc, adv, vol, threshold_hi=1e-4,
                                         threshold_lo=2e-5)
    out["hysteresis"] = {"n_trades": int(h.n_trades), "total_pnl": float(h.total_pnl),
                         "final_cash": float(np.asarray(h.cash)[-1])}
    r3 = jevent.event_backtest(price, valid, sc, adv, vol, latency_bars=3)
    tca = jevent.cost_attribution(r3, price, latency_bars=3, valid=valid)
    out["latency3"] = {"n_trades": int(r3.n_trades), "total_pnl": float(r3.total_pnl),
                       **{k: float(getattr(tca, k)) for k in (
                           "total_cost", "delay_cost", "spread_cost", "impact_cost",
                           "gross_notional")}}
    rl = jevent.event_backtest(price, valid, sc, adv, vol, order_type="limit",
                               fill_key=jax.random.PRNGKey(0))
    out["limit"] = {"n_trades": int(rl.n_trades), "total_pnl": float(rl.total_pnl)}
    p, n, b = jevent.threshold_sweep(price, valid, sc, adv, vol,
                                     np.asarray(_chip_smoke().INTRADAY_SWEEP))
    out["sweep"] = {"total_pnl": np.asarray(p).tolist(), "n_trades": np.asarray(n).tolist(),
                    "cost_bps": np.asarray(b).tolist()}
    return out


def test_intraday_fingerprints_pinned_for_the_card():
    """chip_smoke.py's INTRADAY pins are the reference's outputs, and the
    port reproduces them on the CPU with the function the smoke runs on
    the card (the MLP's pins, ``mlp_fingerprint``, on the card only:
    2,000 full-batch steps over 31,200 rows take ~20 s on a CPU;
    tests/test_torch_models.py and the pipeline test above hold the
    port's MLP to the reference)."""
    smoke = _chip_smoke()
    smoke.check_intraday(_jax_intraday_fingerprints())
    got = smoke.intraday_fingerprints(torch.device("cpu"))
    assert set(got) | {"mlp"} == set(smoke.INTRADAY)
    smoke.check_intraday(got)
