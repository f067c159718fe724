"""The f32 limits ``chip_smoke.py`` holds the intraday leg to at scale
(phase 9(b)), on the CPU at a small size: the port's f32 features, label,
ridge fit and scores lie within the limits derived from the f64 run, also
when the prefix sums round as the card's scan rounds them (emulated here
in f32), and a broken f32 stage fails its hold.
"""

import importlib.util
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch

from csmom_tpu_torch import api
from csmom_tpu_torch.models import ridge_time_series_cv
from csmom_tpu_torch.ops import rolling
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
from csmom_tpu_torch.signals.intraday import compact_minutes, minute_features, next_row_return

torch.set_num_threads(2)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CUMSUM = torch.cumsum


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_scan(x, dim=-1, **kw):
    """torch's CUDA scan along the last dim of a 2-D f32 tensor, in f32:
    chunks of 2^(lx+1), a Sklansky tree in each, the last prefix carried
    into the next chunk's first element (ATen ScanUtils.cuh)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        return _CUMSUM(x, dim=dim, **kw)
    rows, size = x.shape
    lx = min(max(4, (9 + math.ceil(math.log2(size)) - math.ceil(math.log2(rows))) // 2), 9)
    chunk = 2 ** (lx + 1)
    tid = torch.arange(chunk // 2)
    out = torch.empty_like(x)
    carry = torch.zeros(rows, dtype=x.dtype)
    for c0 in range(0, size, chunk):
        n = min(chunk, size - c0)
        buf = torch.zeros(rows, chunk, dtype=x.dtype)
        buf[:, :n] = x[:, c0:c0 + n]
        buf[:, 0] = buf[:, 0] + carry
        for m in range(lx + 1):
            s = 1 << m
            a = ((tid >> m) << (m + 1)) | s
            buf[:, a + tid % s] = buf[:, a + tid % s] + buf[:, a - 1]
        out[:, c0:c0 + n] = buf[:, :n]
        carry = buf[:, chunk - 1]
    return out


def test_card_scan_emulation_is_a_prefix_sum():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(7, 1000)).astype(np.float32))
    torch.testing.assert_close(_card_scan(x), torch.cumsum(x.double(), 1).float(),
                               rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def compact():
    daily = synthetic_daily_panel(6, 8, seed=7, listing_gaps=True)
    a, t = daily.values.shape
    v = daily.values.T.ravel()
    df = pd.DataFrame({"date": np.repeat(daily.times, a), "ticker": np.tile(daily.tickers, t),
                       "open": v, "close": v, "adj_close": v, "volume": 1e6})
    df = df[np.isfinite(df["close"])].reset_index(drop=True)
    return compact_minutes(api.synthetic_minute_frame(df, seed=5))


def _stages(compact, dtype, scan=None, window=30):
    price = torch.as_tensor(compact.price, dtype=dtype)
    volume = torch.as_tensor(compact.volume, dtype=dtype)
    rv = torch.as_tensor(compact.row_valid)
    if scan is not None:
        rolling.torch.cumsum = scan
    try:
        feats, fv = minute_features(price, volume, rv, window=window)
    finally:
        rolling.torch.cumsum = _CUMSUM
    y, yv = next_row_return(price, fv)
    return dict(price=price, volume=volume, rv=rv, feats=feats, fv=fv, y=y, yv=yv)


@pytest.fixture(scope="module")
def f64(compact):
    d = _stages(compact, torch.float64)
    d["fit"] = ridge_time_series_cv(d["feats"], d["y"], d["yv"])
    return d


@pytest.mark.parametrize("scan", ["cpu", "card"])
def test_f32_stages_hold_their_limits(compact, f64, scan):
    smoke = _chip_smoke()
    d32 = _stages(compact, torch.float32, _card_scan if scan == "card" else None)
    fit32 = ridge_time_series_cv(d32["feats"], d32["y"], d32["yv"])
    band, held = smoke.hold_f32(d32, f64, fit32, 30, 1.0)
    assert max(held["feature_err_over_limit"].values()) <= 1.0
    for key in ("coef_err_over_limit", "intercept_err_over_limit", "score_err_over_limit"):
        assert held[key] <= 1.0
    yv = f64["yv"]
    err = (fit32.scores.double() - f64["fit"].scores).abs()[yv]
    assert bool((err <= band[yv]).all())


def test_a_window_off_by_one_fails_the_feature_hold(compact, f64):
    smoke = _chip_smoke()
    d32 = _stages(compact, torch.float32, _card_scan, window=29)
    fit32 = ridge_time_series_cv(d32["feats"], d32["y"], d32["yv"])
    with pytest.raises(AssertionError, match="vol_roll_sum off f64 beyond"):
        smoke.hold_f32(d32, f64, fit32, 30, 1.0)


def test_a_fit_on_bf16_features_fails_the_fit_hold(compact, f64):
    smoke = _chip_smoke()
    d32 = _stages(compact, torch.float32, _card_scan)
    fit32 = ridge_time_series_cv(d32["feats"].to(torch.bfloat16).float(), d32["y"], d32["yv"])
    with pytest.raises(AssertionError, match="f32 fit is off the f64 fit"):
        smoke.hold_f32(d32, f64, fit32, 30, 1.0)
