"""The port's intraday device body against the benchmark's plain reference
(``perfbench/reference/intraday.py``), in float64 on the CPU, on compacted
minute bars from the benchmark's generator at 8 names x 2 days x 390
minutes with missing bars.

Every stage is held to the reference: the five features, the label and
the modeling rows, the scaler, each fold's and the final fit's
coefficients and intercept, the CV MSEs, ``n_train``, the scores, and the
event backtest's trades, positions, fills, PnL and costs.  The float32
reference falls outside the tolerances, so they would catch a port that
computed in float32.  ``intraday_pipeline`` is the host compaction and
the upload, then ``intraday_on_device``.

Tolerances, each relative to the quantity's own scale (its largest
magnitude, or RMS for the scores and the PnL), since single values may
sit near zero:

- features ``1e-10``: the port's windows are differences of prefix sums
  (volumes up to ~1e5 a minute summed over 780 rows to ~1e8, an ulp
  of ~1e-8 against window sums near 3e6), the reference's direct sums;
- label, modeling rows, ``n_train``, trades, positions and counts exact:
  the same divisions and integers;
- scaler ``1e-12``, fits and CV MSEs ``1e-9``: normal equations from the
  fold segments' co-moments against least squares on ~4,000 rows (the
  design's condition number squared times rounding stays far below);
- scores ``1e-9`` of their RMS, fills ``1e-12``, costs ``1e-9``, the PnL
  ``1e-9`` of its RMS: differences of portfolio values near 1e6.

The port reads within ~6e-13 of every scale; float32 moves the features
and the fits by ~3e-5 and the scores by ~1.3e-4.
"""

import numpy as np
import pytest
import torch

from csmom_tpu_torch import api
from csmom_tpu_torch.backtest.event import cost_attribution
from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.signals.intraday import minute_features, next_row_return
from perfbench.generators import minute_bars_volume
from perfbench.reference import intraday as ref_intraday

torch.set_num_threads(2)

CFG = {
    "n_assets": 8, "n_days": 2, "minutes_per_day": 390,
    "start_price_range": [20.0, 200.0], "minute_vol_range": [0.0005, 0.002],
    "ma1_theta": -0.1, "missing_share": 0.02, "adv_range": [5e5, 5e7],
    "volume_profile_depth": 2.0, "volume_noise_sd": 0.5, "dtype": "float64",
}
KNOBS = dict(window=30, n_splits=3, alpha=1.0, train_frac=0.7)
ENGINE = dict(size_shares=50, threshold=1e-5, cash0=1_000_000.0, spread=0.001)
SEEDS = [5, 2**31 + 11]

TOL = {"features": 1e-10, "scaler": 1e-12, "fit": 1e-9, "cv_mse": 1e-9,
       "scores": 1e-9, "fill": 1e-12, "costs": 1e-9, "pnl": 1e-9}


def _panels(seed):
    d = minute_bars_volume.make(CFG, seed, "cpu")
    return (d["price"], d["volume"], d["row_valid"], d["time_idx"], d["n_minutes"],
            d["adv"], d["vol"])


def _port(panels):
    """Every stage of the port on ``panels``: features, label, the ridge
    fit's stages as the device body computes them (the fold segments,
    their co-moments, every fold's fit and the final one) and the device
    body's results with the cost attribution."""
    price, volume, row_valid, *_ = panels
    feats, feat_valid = minute_features(price, volume, row_valid, window=KNOBS["window"])
    y, y_valid = next_row_return(price, feat_valid)
    A, R, F = feats.shape
    seg, n_train = kernels.ridge_segments(y_valid, KNOBS["n_splits"], KNOBS["train_frac"],
                                          0.6, 100, feats.dtype)
    Xf = torch.nan_to_num(feats.reshape(A * R, F))
    Z = torch.cat([Xf, torch.nan_to_num(y.reshape(A * R, 1))], 1)
    moments = kernels.segment_moments_plain(Z, seg, KNOBS["n_splits"] + 1)
    coefs, icepts, mean, std, cv_mse = kernels.ridge_from_moments(*moments, KNOBS["alpha"])
    fits = list(zip(coefs, icepts))
    scores = torch.where(y_valid, (((Xf - mean) / std) @ coefs[-1] + icepts[-1]).reshape(A, R),
                         torch.nan)
    res, fit, dense_score, dense_price, dense_valid = api.intraday_on_device(
        *panels, window_minutes=KNOBS["window"], n_splits=KNOBS["n_splits"],
        alpha=KNOBS["alpha"], size_shares=ENGINE["size_shares"],
        threshold=ENGINE["threshold"], cash0=ENGINE["cash0"])
    costs = cost_attribution(res, dense_price, size_shares=ENGINE["size_shares"],
                             spread=ENGINE["spread"])
    return dict(feats=feats, feat_valid=feat_valid, y=y, y_valid=y_valid, fits=fits,
                mean=mean, std=std, cv_mse=cv_mse, scores=scores, n_train=n_train,
                res=res, fit=fit, dense_score=dense_score, dense_valid=dense_valid,
                costs=costs)


def _reference(panels, dtype=torch.float64):
    price, volume, row_valid, time_idx, n_minutes, adv, vol = panels
    return ref_intraday.pipeline(price, volume, row_valid, time_idx, n_minutes, adv,
                                 vol, KNOBS["window"], KNOBS["n_splits"], KNOBS["alpha"],
                                 KNOBS["train_frac"], ENGINE["size_shares"],
                                 ENGINE["threshold"], ENGINE["cash0"], ENGINE["spread"],
                                 dtype=dtype)


def _gaps(p, r):
    """Each compared stage's widest gap, relative to its scale."""
    f64 = torch.float64

    def rel(a, b, scale):
        return float((a.to(f64) - b.to(f64)).abs().max() / scale)

    fv = p["feat_valid"]
    feats = max(rel(p["feats"][..., k][fv], r["features"][..., k][fv],
                    r["features"][..., k][fv].abs().max()) for k in range(5))
    fit = 0.0
    for (c, b), (rc, rb) in zip(p["fits"], r["folds"] + [(r["coef"], r["intercept"])]):
        scale = max(float(rc.abs().max()), abs(float(rb)))
        fit = max(fit, rel(c, rc, scale), rel(b.reshape(1), rb.reshape(1), scale))
    v = r["valid"]
    s = r["scores"][v]
    traded = r["units"] != 0
    pnl = r["pnl"]
    return {
        "features": feats,
        "scaler": max(rel(p["mean"], r["mean"], r["mean"].abs().max()),
                      rel(p["std"], r["std"], r["std"].abs().max())),
        "fit": fit,
        "cv_mse": max(float(x) for x in ((p["cv_mse"].to(f64) - r["cv_mse"].to(f64)).abs()
                                         / r["cv_mse"].to(f64).abs())),
        "scores": rel(p["scores"][v], s, s.to(f64).pow(2).mean().sqrt()),
        "fill": float(((p["res"].exec_price.to(f64) - r["fill"].to(f64)).abs()[traded]
                       / r["fill"].to(f64).abs()[traded]).max()),
        "costs": max(abs(float(getattr(p["costs"], k)) - float(r[k])) / abs(float(r[k]))
                     for k in ("total_cost", "spread_cost", "impact_cost",
                               "gross_notional")),
        "pnl": rel(p["res"].pnl, pnl, pnl.to(f64).pow(2).mean().sqrt()),
    }


@pytest.fixture(scope="module", params=SEEDS)
def runs(request):
    panels = _panels(request.param)
    return panels, _port(panels), _reference(panels)


def test_the_panels_have_missing_bars_and_trade(runs):
    panels, p, r = runs
    counts = panels[2].sum(dim=1)
    assert counts.min() < counts.max() == panels[0].shape[1]
    assert 0 < r["n_trades"] < int(r["dense_valid"].sum())
    assert p["dense_valid"].shape == (8, panels[4])


def test_rows_label_and_counts_are_exact(runs):
    _, p, r = runs
    assert torch.equal(p["feat_valid"], ~torch.isnan(r["features"][..., 0]))
    assert torch.equal(p["y_valid"], r["valid"])
    assert torch.equal(p["y"][r["valid"]], r["label"][r["valid"]])
    assert int(p["n_train"]) == int(p["fit"].n_train) == r["n_train"]
    assert len(p["fits"]) == KNOBS["n_splits"] + 1
    res = p["res"]
    assert torch.equal(res.trade_side.to(torch.int64), r["units"])
    assert torch.equal(res.positions.to(torch.int64), r["positions"])
    assert torch.equal(p["dense_valid"], r["dense_valid"])
    for k in ("n_trades", "n_buys", "n_sells"):
        assert int(getattr(res, k)) == r[k], k


@pytest.mark.parametrize("stage", sorted(TOL))
def test_each_stage_is_within_its_tolerance(runs, stage):
    _, p, r = runs
    assert _gaps(p, r)[stage] <= TOL[stage]


def test_the_device_body_gives_the_harness_fit(runs):
    """The body's fit is the final fit of the stages compared above, and
    its scores theirs: the stages compared are the ones the body runs."""
    _, p, _ = runs
    coef, icept = p["fits"][-1]
    assert torch.equal(p["fit"].coef, coef) and torch.equal(p["fit"].intercept, icept)
    assert torch.equal(p["fit"].cv_mse, p["cv_mse"])
    torch.testing.assert_close(p["fit"].scores, p["scores"], rtol=0, atol=0,
                               equal_nan=True)


def test_the_float32_reference_falls_outside(runs):
    panels, p, r = runs
    r32 = _reference(panels, torch.float32)
    over = [k for k, v in _gaps(p, r32).items() if not v <= TOL[k]]
    assert {"fit", "scores", "cv_mse"} <= set(over), over


def test_pipeline_is_the_compaction_then_the_device_body(monkeypatch):
    """``intraday_pipeline`` calls ``intraday_on_device`` once, on the
    compacted frame's panels, and returns its results with ``compact``."""
    from csmom_tpu_torch.signals.intraday import compact_minutes
    from csmom_tpu_torch.workloads import minute_frame

    frame = minute_frame(4, 2)
    calls = []
    body = api.intraday_on_device

    def spy(*a, **k):
        calls.append((a, k))
        return body(*a, **k)

    monkeypatch.setattr(api, "intraday_on_device", spy)
    got = api.intraday_pipeline(frame, None, device="cpu")
    assert len(calls) == 1
    compact = compact_minutes(frame)
    assert got[2].tickers == compact.tickers
    panels = api.intraday_panels(compact, *api.daily_risk_maps(None, compact.tickers),
                                 "cpu", torch.float64)
    for a, b in zip(calls[0][0], panels):
        assert a == b if isinstance(b, int) else torch.equal(a, b)
    want = body(*panels, **calls[0][1])
    res, fit, _, score, price, valid = got
    assert torch.equal(res.pnl, want[0].pnl) and torch.equal(res.cash, want[0].cash)
    assert torch.equal(fit.coef, want[1].coef)
    for a, b in zip((score, price, valid), want[2:]):
        assert torch.equal(torch.nan_to_num(a.double()), torch.nan_to_num(b.double()))


def test_scatter_takes_the_resident_minute_index():
    """``scatter_to_minutes`` places each modeling row at its minute and
    sends the other rows to the sliced-off spill column."""
    time_idx = torch.tensor([[0, 2, 3, 0], [1, 3, 0, 0]], dtype=torch.int32)
    y_valid = torch.tensor([[True, True, False, False], [True, True, False, False]])
    vals = torch.arange(8, dtype=torch.float64).reshape(2, 4)
    dense, valid = api.scatter_to_minutes(time_idx, 5, y_valid, (vals,))
    assert np.array_equal(np.nan_to_num(dense.numpy(), nan=-1),
                          [[0, -1, 1, -1, -1], [-1, 4, -1, 5, -1]])
    assert valid.sum() == 4 and bool(valid[0, 2]) and bool(valid[1, 3])
