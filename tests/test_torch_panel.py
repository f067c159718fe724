"""The port's panel layer against csmom_tpu: the synthetic generator copy is
bit-identical, and the month-end aggregation equals the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.panel import calendar as jcal
from csmom_tpu.panel.synthetic import synthetic_daily_panel as jax_synthetic
from csmom_tpu_torch.panel import calendar
from csmom_tpu_torch.panel.panel import Panel, to_tensors
from csmom_tpu_torch.panel.synthetic import synthetic_daily_panel

torch.set_num_threads(2)


@pytest.mark.parametrize("a,t,seed,gaps", [(40, 1260, 123, True),
                                           (7, 300, 5, False),
                                           (31, 777, 7, True)])
def test_synthetic_daily_panel_bit_equal(a, t, seed, gaps):
    p = synthetic_daily_panel(a, t, seed=seed, listing_gaps=gaps)
    q = jax_synthetic(a, t, seed=seed, listing_gaps=gaps)
    assert p.values.tobytes() == q.values.tobytes()
    np.testing.assert_array_equal(p.mask, q.mask)
    np.testing.assert_array_equal(p.times, q.times)
    assert p.tickers == q.tickers and p.name == q.name


def test_month_end_segments_equal():
    times = synthetic_daily_panel(1, 900, seed=0).times
    seg, ends = calendar.month_end_segments(times)
    jseg, jends = jcal.month_end_segments(times)
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_array_equal(ends, jends)
    with pytest.raises(ValueError, match="nondecreasing"):
        calendar.month_end_segments(times[::-1])


def _gappy_daily(seed):
    panel = synthetic_daily_panel(24, 500, seed=seed, listing_gaps=True)
    rng = np.random.default_rng(seed)
    mask = panel.mask & (rng.random(panel.mask.shape) > 0.3)  # interior holes
    mask[3, 40:90] = False                                    # whole months missing
    values = np.where(mask, panel.values, np.nan)
    return values, mask, panel.times


@pytest.mark.parametrize("seed", [11, 12])
def test_month_end_aggregate_matches_jax(seed):
    values, mask, times = _gappy_daily(seed)
    seg, ends = calendar.month_end_segments(times)
    v, m = to_tensors(values, mask, device="cpu")
    pm, mm = calendar.month_end_aggregate(v, m, seg, len(ends))
    jpm, jmm = jcal.month_end_aggregate(jnp.asarray(values), jnp.asarray(mask),
                                        seg, len(ends))
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
    assert pm.numpy().tobytes() == np.asarray(jpm).tobytes()
    assert not mm.numpy().all()  # the case does exercise empty months


def test_month_end_aggregate_extra_empty_segments():
    """Segments past the last day (num_segments > max id + 1) are empty."""
    values, mask, times = _gappy_daily(3)
    seg, ends = calendar.month_end_segments(times)
    v, m = to_tensors(values, mask, device="cpu")
    pm, mm = calendar.month_end_aggregate(v, m, seg, len(ends) + 2)
    jpm, jmm = jcal.month_end_aggregate(jnp.asarray(values), jnp.asarray(mask),
                                        seg, len(ends) + 2)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))


def test_to_tensors_casts_on_host():
    values, mask, times = _gappy_daily(4)
    v, m = to_tensors(values, mask, device="cpu", dtype=torch.float32)
    assert v.dtype == torch.float32 and m.dtype == torch.bool
    np.testing.assert_array_equal(v.numpy(), values.astype(np.float32))
    v64, _ = to_tensors(values, mask, device="cpu")
    assert v64.dtype == torch.float64


def test_panel_validates_shapes():
    values, mask, times = _gappy_daily(5)
    tickers = tuple(str(i) for i in range(len(values)))
    Panel(values=values, mask=mask, tickers=tickers, times=times)
    with pytest.raises(ValueError, match="tickers"):
        Panel(values=values, mask=mask, tickers=tickers[1:], times=times)
    with pytest.raises(ValueError, match="times"):
        Panel(values=values, mask=mask, tickers=tickers, times=times[1:])
    with pytest.raises(ValueError, match="differ"):
        Panel(values=values, mask=mask[:, 1:], tickers=tickers, times=times)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_segment_sum_panel_matches_jax(dtype):
    """Per-(asset, month) sums of valid days as prefix-sum differences at
    the sorted segment bounds, including an empty segment and masked days;
    float64 to the reference's rounding, float32 to one rounding of the
    float64 prefix (the prefix is taken in float64 either way)."""
    p = synthetic_daily_panel(9, 400, seed=3, listing_gaps=True)
    seg, ends = calendar.month_end_segments(p.times)
    seg = np.where(seg >= 5, seg + 1, seg).astype(np.int32)   # month 5 has no day
    vol = np.abs(p.values) * 1e6
    vol[p.mask & (np.arange(400) % 7 == 0)] = np.nan           # NaN on valid days: 0
    vol = vol.astype(dtype)
    n_seg = int(seg.max()) + 1
    v, m = to_tensors(vol, p.mask, device="cpu")
    got = calendar.segment_sum_panel(v, m, seg, n_seg)
    want = np.asarray(jcal.segment_sum_panel(jnp.asarray(vol), jnp.asarray(p.mask),
                                             jnp.asarray(seg), n_seg))
    assert got.dtype == v.dtype and got.shape == (9, n_seg)
    assert (got[:, 5] == 0).all()
    if dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-6)
    else:
        ref = np.asarray(jcal.segment_sum_panel(jnp.asarray(vol.astype(np.float64)),
                                                jnp.asarray(p.mask), jnp.asarray(seg),
                                                n_seg))
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))
    with pytest.raises(ValueError, match="nondecreasing"):
        calendar.segment_sum_panel(v, m, seg[::-1].copy(), n_seg)


@pytest.mark.parametrize("seed,minutes", [(0, 390), (5, 7)])
def test_synthetic_minute_bars_bit_equal(seed, minutes):
    from csmom_tpu.panel.synthetic import SYNTH_VERSION as JAX_SYNTH_VERSION
    from csmom_tpu.panel.synthetic import synthetic_minute_bars as jax_minutes
    from csmom_tpu_torch.panel.synthetic import SYNTH_VERSION, synthetic_minute_bars

    assert SYNTH_VERSION == JAX_SYNTH_VERSION
    rng = np.random.default_rng(seed)
    o = rng.uniform(10, 50, size=(3, 4))
    c = o * rng.uniform(0.95, 1.05, size=(3, 4))
    v = rng.uniform(0, 1e6, size=(3, 4))
    p, vol = synthetic_minute_bars(o, c, v, minutes_per_day=minutes, seed=seed)
    jp, jvol = jax_minutes(o, c, v, minutes_per_day=minutes, seed=seed)
    assert p.tobytes() == jp.tobytes() and vol.dtype == np.int64
    np.testing.assert_array_equal(vol, jvol)


def test_panel_host_views_equal_the_reference():
    from csmom_tpu.panel.panel import Panel as JPanel
    from csmom_tpu_torch.panel.panel import PanelBundle

    values, mask, times = _gappy_daily(5)
    tickers = [f"T{i}" for i in range(values.shape[0])]
    p = Panel.from_dense(values, tickers, times, name="adj_close")
    jp = JPanel.from_dense(values, tickers, times, name="adj_close")
    np.testing.assert_array_equal(p.mask, jp.mask)
    assert (p.n_assets, p.n_times, p.shape) == (jp.n_assets, jp.n_times, jp.shape)
    assert p.to_dataframe().equals(jp.to_dataframe())
    keep = ["T7", "T2", "T19"]
    s, js = p.select_assets(keep), jp.select_assets(keep)
    assert s.tickers == js.tickers == tuple(keep)
    assert s.values.tobytes() == js.values.tobytes()
    np.testing.assert_array_equal(s.mask, js.mask)
    with pytest.raises(ValueError, match="differ"):
        Panel(values=values, mask=mask[:, 1:], tickers=tuple(tickers), times=times)
    b = PanelBundle(panels={"adj_close": p}, tickers=p.tickers, times=p.times)
    assert b.fields == ("adj_close",) and "adj_close" in b and b["adj_close"] is p
    v, m = p.tensors(device="cpu", dtype=torch.float32)
    assert v.dtype == torch.float32 and torch.equal(m, torch.as_tensor(p.mask))
