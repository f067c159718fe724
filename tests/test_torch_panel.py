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
