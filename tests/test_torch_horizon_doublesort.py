"""The port's volume double sort and event-time horizon profiles against
csmom_tpu's, on the CPU in f64: ``volume_double_sort`` (spreads, cell
counts, book turnover) and its table, ``horizon_profile`` at max_h 12 and
36, and ``volume_horizon_profile`` in the ``kernel``, ``plain`` and
``matmul`` forms, each against the reference and against one another, with
their tables.  Tolerances: f64 ``rtol=1e-10, atol=1e-13``; counts and
validity exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.analytics import tables as jtables
from csmom_tpu.backtest.double_sort import volume_double_sort as jax_double_sort
from csmom_tpu.backtest.horizon import horizon_profile as jax_horizon
from csmom_tpu.backtest.horizon import volume_horizon_profile as jax_vhorizon
from csmom_tpu.signals.turnover import turnover_features as jax_turnover
from csmom_tpu_torch.analytics import tables
from csmom_tpu_torch.backtest.double_sort import volume_double_sort
from csmom_tpu_torch.backtest.horizon import horizon_profile, volume_horizon_profile
from csmom_tpu_torch.panel.calendar import month_end_aggregate, month_end_segments
from csmom_tpu_torch.panel.panel import to_tensors
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel
from csmom_tpu_torch.signals.turnover import turnover_features

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13)


@pytest.fixture(scope="module")
def data():
    """Month-end prices of 60 gappy names over 72 months and their
    3-month turnover (a volume proxy over partly unknown shares)."""
    daily = synthetic_daily_panel(60, 1512, seed=31, listing_gaps=True)
    seg, ends = month_end_segments(daily.times)
    v, m = to_tensors(daily.values, daily.mask, device="cpu")
    pm, mm = month_end_aggregate(v, m, seg, len(ends))
    rng = np.random.default_rng(32)
    vol = np.where(mm.numpy(), rng.uniform(1e5, 5e7, size=pm.shape), 0.0)
    shares = rng.uniform(1e7, 1e9, size=pm.shape[0])
    shares[:4] = np.nan
    turn_t = turnover_features(torch.as_tensor(vol), mm, shares)["turn_avg"]
    turn_j = jax_turnover(vol, mm.numpy(), shares)["turn_avg"]
    return {"p": pm, "m": mm, "turn": turn_t, "jp": jnp.asarray(pm.numpy()),
            "jm": jnp.asarray(mm.numpy()), "jturn": turn_j}


def _assert_fields_equal(got, want, exact=()):
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        if f in exact or b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, equal_nan=True, err_msg=f, **TOL)


@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("lookback,n_bins,n_vol", [(6, 10, 3), (3, 5, 2)])
def test_volume_double_sort_equals_the_reference(data, mode, lookback, n_bins, n_vol):
    got = volume_double_sort(data["p"], data["m"], *data["turn"], lookback=lookback,
                             n_bins=n_bins, n_vol_bins=n_vol, mode=mode)
    want = jax_double_sort(data["jp"], data["jm"], *data["jturn"], lookback=lookback,
                           n_bins=n_bins, n_vol_bins=n_vol, mode=mode)
    _assert_fields_equal(got, want, exact=("spread_valid", "cell_counts"))
    assert got.cell_counts.dtype == torch.int32
    assert got.spread_valid.any(dim=-1).all()


@pytest.mark.parametrize("bps", [None, 10.0])
def test_double_sort_table_equals_the_reference(data, bps):
    got = volume_double_sort(data["p"], data["m"], *data["turn"], lookback=6)
    want = jax_double_sort(data["jp"], data["jm"], *data["jturn"], lookback=6)
    a = tables.double_sort_table(got, half_spread_bps=bps)
    b = jtables.double_sort_table(want, half_spread_bps=bps)
    assert list(a.index) == list(b.index) and list(a.columns) == list(b.columns)
    np.testing.assert_allclose(a.to_numpy(float), b.to_numpy(float), equal_nan=True, **TOL)
    assert a.round(4).to_string() == b.round(4).to_string()


@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("max_h", [12, 36])
def test_horizon_profile_equals_the_reference(data, mode, max_h):
    got = horizon_profile(data["p"], data["m"], lookback=6, mode=mode, max_h=max_h)
    want = jax_horizon(data["jp"], data["jm"], lookback=6, mode=mode, max_h=max_h)
    _assert_fields_equal(got, want)
    assert tuple(got.mean_spread.shape) == (max_h,)
    for group in (1, 6, 5):
        a = tables.horizon_table(got, group=group)
        b = jtables.horizon_table(want, group=group)
        np.testing.assert_allclose(a.to_numpy(float), b.to_numpy(float), equal_nan=True,
                                   **TOL)
        assert a.round(4).to_string() == b.round(4).to_string()


def test_horizon_profile_forms_agree(data):
    kernel = horizon_profile(data["p"], data["m"], lookback=9, max_h=24)
    for impl in ("plain", "matmul"):
        other = horizon_profile(data["p"], data["m"], lookback=9, max_h=24, impl=impl)
        _assert_fields_equal(other, kernel, exact=("n_cohorts",))
    with pytest.raises(ValueError, match="must be <= 128"):
        horizon_profile(data["p"], data["m"], max_h=129)


@pytest.mark.parametrize("impl", ["kernel", "plain", "matmul"])
@pytest.mark.parametrize("mode", ["qcut", "rank"])
def test_volume_horizon_profile_equals_the_reference(data, impl, mode):
    got = volume_horizon_profile(data["p"], data["m"], *data["turn"], lookback=6,
                                 mode=mode, max_h=36, impl=impl)
    want = jax_vhorizon(data["jp"], data["jm"], *data["jturn"], lookback=6,
                        mode=mode, max_h=36)
    _assert_fields_equal(got, want)
    assert tuple(got.mean_spread.shape) == (3, 36)
    a = tables.volume_horizon_table(got, group=6)
    b = jtables.volume_horizon_table(want, group=6)
    np.testing.assert_allclose(a.to_numpy(float), b.to_numpy(float), equal_nan=True, **TOL)
    assert a.round(4).to_string() == b.round(4).to_string()


def test_volume_horizon_forms_agree_with_each_other(data):
    forms = {impl: volume_horizon_profile(data["p"], data["m"], *data["turn"],
                                          lookback=3, n_vol_bins=2, max_h=20, impl=impl)
             for impl in ("kernel", "plain", "matmul")}
    for impl in ("plain", "matmul"):
        _assert_fields_equal(forms[impl], forms["kernel"], exact=("n_cohorts",))
    assert tuple(forms["kernel"].diff_mean.shape) == (20,)
