"""``monthly_price_panel`` of the port against csmom_tpu's, on the CPU: the
committed CSV universe and its pack give the reference's month-end prices,
volumes and volume masks; the CSV-universe golden of
tests/test_synthetic_golden.py; the pack's errors and sorted subsets;
the stored type of an f32 pack; cuda by default."""

import os

import numpy as np
import pytest
import torch

from csmom_tpu.api import monthly_price_panel as jax_monthly_price_panel
from csmom_tpu.panel.pack import pack_csv_cache as jax_pack_csv_cache
from csmom_tpu_torch import monthly_price_panel as lazy_monthly_price_panel
from csmom_tpu_torch.analytics.stats import nw_t_stat
from csmom_tpu_torch.api import monthly_price_panel
from csmom_tpu_torch.backtest.monthly import monthly_spread_backtest
from csmom_tpu_torch.panel.ingest import load_daily
from csmom_tpu_torch.panel.pack import pack_csv_cache, save_packed
from csmom_tpu_torch.panel.panel import Panel

torch.set_num_threads(2)

UNIVERSE = os.path.join(os.path.dirname(__file__), "fixtures", "universe")
TICKERS = sorted(n.split("_")[0] for n in os.listdir(UNIVERSE))
TOL = dict(rtol=1e-10, atol=1e-13)

# tests/test_synthetic_golden.py::test_csv_universe_golden's pins
CSV_GOLDEN = {"shape": (8, 23), "n_valid_spreads": 15, "mean_spread": 0.007170869622,
              "ann_sharpe": 0.207281538823, "nw_t": 0.249081731114}


def _assert_panels_equal(got, want):
    for g, w in zip(got, want):
        assert g.tickers == w.tickers and g.name == w.name
        np.testing.assert_array_equal(g.times, w.times)
        np.testing.assert_array_equal(g.mask, np.asarray(w.mask))
        np.testing.assert_allclose(g.values, np.asarray(w.values), equal_nan=True, **TOL)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    d = tmp_path_factory.mktemp("packs")
    pack_csv_cache(UNIVERSE, TICKERS, str(d / "port"))
    jax_pack_csv_cache(UNIVERSE, TICKERS, str(d / "ref"))
    pack_csv_cache(UNIVERSE, TICKERS, str(d / "f32"), dtype=np.float32)
    return d


@pytest.mark.parametrize("source", ["csv", "port_pack", "ref_pack", "daily_df"])
def test_month_end_panels_equal_the_reference(source, packs):
    data_dir = {"csv": UNIVERSE, "port_pack": str(packs / "port"),
                "ref_pack": str(packs / "ref"), "daily_df": UNIVERSE}[source]
    df = load_daily(UNIVERSE, TICKERS) if source == "daily_df" else None
    got = monthly_price_panel(data_dir, TICKERS, daily_df=df, device="cpu")
    want = jax_monthly_price_panel(UNIVERSE, TICKERS)
    _assert_panels_equal(got, want)
    prices, volume = got
    assert prices.values.dtype == np.float64 and prices.name == "month_end_adj_close"
    assert volume.name == "monthly_volume"
    # a month with no daily bar is no volume observation, not a phantom 0
    assert not volume.mask.all() and (volume.values[~volume.mask] == 0).all()
    np.testing.assert_array_equal(volume.mask, prices.mask)


def test_other_fields_and_f32_packs(packs):
    for field in ("adj_close", "volume"):
        _assert_panels_equal(
            monthly_price_panel(str(packs / "port"), None, field=field, device="cpu"),
            jax_monthly_price_panel(UNIVERSE, TICKERS, field=field))
    p32, v32 = monthly_price_panel(str(packs / "f32"), None, device="cpu")
    p64, v64 = monthly_price_panel(str(packs / "port"), None, device="cpu")
    assert p32.values.dtype == np.float32 and v32.values.dtype == np.float32
    # month ends are a selection, so the cast commutes with it
    np.testing.assert_array_equal(p32.values, p64.values.astype(np.float32))
    np.testing.assert_array_equal(p32.mask, p64.mask)
    np.testing.assert_allclose(v32.values, v64.values, rtol=1e-4, atol=1e-6)
    p, _ = monthly_price_panel(str(packs / "port"), None, device="cpu",
                               dtype=torch.float32)
    np.testing.assert_array_equal(p.values, p32.values)


def test_csv_universe_golden_on_the_cpu():
    prices, _ = monthly_price_panel(UNIVERSE, TICKERS, device="cpu")
    assert prices.shape == CSV_GOLDEN["shape"]
    v, m = prices.tensors(device="cpu")
    res = monthly_spread_backtest(v, m, lookback=6, skip=1, n_bins=4)
    assert int(res.spread_valid.sum()) == CSV_GOLDEN["n_valid_spreads"]
    for got, k in [(res.mean_spread, "mean_spread"), (res.ann_sharpe, "ann_sharpe"),
                   (nw_t_stat(res.spread, res.spread_valid), "nw_t")]:
        np.testing.assert_allclose(float(got), CSV_GOLDEN[k], rtol=1e-9, err_msg=k)


def test_pack_subsets_and_errors_match_the_reference(packs, tmp_path):
    pk = str(packs / "port")
    want_sub = [TICKERS[5], TICKERS[1], TICKERS[3]]
    got = monthly_price_panel(pk, want_sub, device="cpu")
    assert got[0].tickers == tuple(sorted(want_sub))
    _assert_panels_equal(got, jax_monthly_price_panel(str(packs / "ref"), want_sub))
    with pytest.raises(ValueError, match="lacks 2 requested tickers: ZZA,ZZB"):
        monthly_price_panel(pk, [TICKERS[0], "ZZB", "ZZA"], device="cpu")
    with pytest.raises(ValueError, match="lacks field 'close'"):
        monthly_price_panel(pk, None, field="close", device="cpu")
    single = Panel.from_dense(np.ones((2, 3)), ["a", "b"],
                              np.arange(3).astype("datetime64[D]"), name="adj_close")
    save_packed(single, str(tmp_path / "one"))
    with pytest.raises(ValueError, match="holds only 'adj_close'"):
        monthly_price_panel(str(tmp_path / "one"), None, device="cpu")
    for args in ([pk, [TICKERS[0], "ZZB", "ZZA"]], [str(tmp_path / "one"), None]):
        with pytest.raises(ValueError):
            jax_monthly_price_panel(*args)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    assert lazy_monthly_price_panel is monthly_price_panel
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monthly_price_panel(UNIVERSE, TICKERS)
