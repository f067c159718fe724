"""The port's artifact writers: each writes a non-empty PNG or CSV under the
same file name as csmom_tpu's, and the trade log byte for byte."""

import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from csmom_tpu.analytics import plots as jplots
from csmom_tpu.analytics.tables import tercile_labels as jax_tercile_labels
from csmom_tpu_torch.analytics import plots
from csmom_tpu_torch.analytics.tables import tercile_labels

PNG = b"\x89PNG\r\n\x1a\n"


def _written(path, out_dir):
    assert os.path.dirname(path) == str(out_dir)
    assert os.path.getsize(path) > 0
    return os.path.basename(path)


@pytest.mark.parametrize("kind", ["monthly", "monthly_overlays", "intraday",
                                  "horizon", "horizon_terciles"])
def test_plots_write_pngs_under_the_reference_names(tmp_path, kind):
    rng = np.random.default_rng(3)
    times = np.arange("2020-01", 24, dtype="datetime64[M]").astype("datetime64[ns]")
    spread = rng.normal(0.01, 0.05, 24)
    spread[[2, 7]] = np.nan
    calls = {
        "monthly": lambda m, d: m.save_monthly_cum_plot(times, spread, d),
        "monthly_overlays": lambda m, d: m.save_monthly_cum_plot(
            times, spread, d, overlays={"banded": spread * 0.5, "vol": spread[::-1]}),
        "intraday": lambda m, d: m.save_intraday_pnl_plot(
            np.arange(50), rng.normal(0, 10, 50), d),
        "horizon": lambda m, d: m.save_horizon_plot(
            SimpleNamespace(cum_spread=np.cumsum(rng.normal(0, 0.01, 12))), d),
        "horizon_terciles": lambda m, d: m.save_horizon_plot(
            SimpleNamespace(cum_spread=np.cumsum(rng.normal(0, 0.01, (3, 12)), 1)), d),
    }[kind]
    got = calls(plots, str(tmp_path / "port"))
    want = calls(jplots, str(tmp_path / "ref"))
    assert _written(got, tmp_path / "port") == _written(want, tmp_path / "ref")
    assert open(got, "rb").read(8) == PNG


def test_trades_csv_equal_the_reference(tmp_path):
    trades = pd.DataFrame({
        "datetime": pd.date_range("2025-01-02 09:30", periods=4, freq="min"),
        "ticker": ["A", "B", "A", "C"], "size": [50, -50, 50, 10],
        "price": [10.0, 20.5, 10.25, 3.0], "impact": [1e-4, 2e-4, 0.0, 5e-5],
        "score": [0.1, -0.2, 0.3, 0.05], "extra": [1, 2, 3, 4]})
    got = plots.save_trades_csv(trades, str(tmp_path / "port"))
    want = jplots.save_trades_csv(trades, str(tmp_path / "ref"))
    assert _written(got, tmp_path / "port") == _written(want, tmp_path / "ref") == "trades.csv"
    assert open(got).read() == open(want).read()
    assert open(got).readline().strip() == "datetime,ticker,size,price,impact,score"


@pytest.mark.parametrize("V", [1, 2, 3, 5])
def test_tercile_labels_equal(V):
    assert tercile_labels(V) == jax_tercile_labels(V)
