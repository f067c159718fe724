"""The port's tearsheet against csmom_tpu's: every field over batched series
(all-invalid, lengths 1-3, gaps, q*n on an integer) in f64 and f32, the
per-year returns with non-contiguous years, and the text rendering."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu_torch.analytics.tearsheet import (
    Tearsheet,
    annual_returns,
    format_tearsheet,
    max_drawdown,
    tearsheet,
)

torch.set_num_threads(2)

# the module (the package's __init__ exports the function by the same name)
jts = importlib.import_module("csmom_tpu.analytics.tearsheet")
ts_mod = importlib.import_module("csmom_tpu_torch.analytics.tearsheet")

TOL = {torch.float64: dict(rtol=1e-10, atol=1e-13), torch.float32: dict(rtol=1e-4, atol=1e-6)}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
FIELDS = [f.name for f in __import__("dataclasses").fields(Tearsheet)]


def _batch(seed, T):
    """[7, T] series: gappy, all-invalid, all-valid, one valid period, all
    positive (no drawdown, no downside), all equal (zero variance: 2**-6
    sums exactly, so the variance is 0 in any summation order, where a
    constant like 0.01 leaves order-dependent rounding as the "std"), and
    declining from inception."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0.004, 0.05, size=(7, T))
    valid = rng.random((7, T)) > 0.2
    valid[1] = False
    valid[2] = True
    valid[3] = False
    valid[3, T // 2] = True
    r[4] = np.abs(r[4]) + 0.001
    r[5] = 2.0 ** -6
    r[6] = -np.abs(r[6]) - 0.001
    valid[4:] = True
    return np.where(valid, r, np.nan), valid


def _assert_ts_equal(got, want, dtype):
    assert set(FIELDS) == {f.name for f in __import__("dataclasses").fields(jts.Tearsheet)}
    for k in FIELDS:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        if k == "n_periods":
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g.dtype == np.dtype(str(dtype).split(".")[1]), k
            np.testing.assert_allclose(g, w, equal_nan=True, err_msg=k, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [1, 2, 3, 24, 240, 400])
def test_tearsheet_fields_equal_the_reference(T, dtype):
    r, valid = _batch(T, T)
    got = tearsheet(torch.as_tensor(r, dtype=dtype), torch.as_tensor(valid))
    want = jts.tearsheet(jnp.asarray(r, JDT[dtype]), jnp.asarray(valid))
    _assert_ts_equal(got, want, dtype)
    # a [2, 7, T] grid reduces as its rows do
    grid = tearsheet(torch.as_tensor(np.stack([r, r[::-1]]), dtype=dtype),
                     torch.as_tensor(np.stack([valid, valid[::-1]])), freq_per_year=4)
    jgrid = jts.tearsheet(jnp.asarray(np.stack([r, r[::-1]]), JDT[dtype]),
                          jnp.asarray(np.stack([valid, valid[::-1]])), freq_per_year=4)
    _assert_ts_equal(grid, jgrid, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_empty_batch(dtype):
    """A batch of no series reduces to empty fields, as the reference's."""
    r, valid = np.zeros((0, 24)), np.zeros((0, 24), bool)
    got = tearsheet(torch.as_tensor(r, dtype=dtype), torch.as_tensor(valid))
    want = jts.tearsheet(jnp.asarray(r, JDT[dtype]), jnp.asarray(valid))
    _assert_ts_equal(got, want, dtype)
    assert got.ann_return.shape == (0,)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tail_count_on_an_integer_q_n(dtype):
    """n = 240, q = 0.05: the tail is exactly 12 periods in either type."""
    n = 240
    r = np.linspace(-0.12, 0.119, n)
    got = tearsheet(torch.as_tensor(r, dtype=dtype), torch.ones(n, dtype=torch.bool))
    want = jts.tearsheet(jnp.asarray(r, JDT[dtype]), jnp.ones(n, bool))
    _assert_ts_equal(got, want, dtype)
    np.testing.assert_allclose(float(got.var_95), np.sort(r)[11], **TOL[dtype])
    np.testing.assert_allclose(float(got.cvar_95), np.sort(r)[:12].mean(), **TOL[dtype])
    assert ts_mod._tail_stats(torch.as_tensor(r), torch.ones(n, dtype=torch.bool),
                              0.05)[0] == np.sort(r)[11]


def test_max_drawdown_from_inception():
    r = np.array([-0.10, -0.05, 0.02, 0.01])
    got = float(max_drawdown(torch.as_tensor(r), torch.ones(4, dtype=torch.bool)))
    assert got == pytest.approx(1.0 - 0.90 * 0.95, rel=1e-12)
    assert got == float(jts.max_drawdown(jnp.asarray(r), jnp.ones(4, bool)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_annual_returns_with_non_contiguous_years(dtype):
    rng = np.random.default_rng(4)
    T = 30
    years = np.repeat([2001, 2003, 2004, 2009, 2010], 6).astype(np.int32)
    years[6:9] = 2010            # a year that comes back after others
    r = rng.normal(0.01, 0.04, size=(3, T))
    valid = rng.random((3, T)) > 0.25
    valid[1, years == 2009] = False   # a year with nothing valid
    r = np.where(valid, r, np.nan)
    uniq, ann, anyv = annual_returns(torch.as_tensor(r, dtype=dtype),
                                     torch.as_tensor(valid), years)
    juniq, jann, janyv = jts.annual_returns(jnp.asarray(r, JDT[dtype]),
                                            jnp.asarray(valid), years)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_array_equal(anyv.numpy(), np.asarray(janyv))
    np.testing.assert_allclose(ann.numpy(), np.asarray(jann), equal_nan=True, **TOL[dtype])
    assert not anyv[1, 3] and torch.isnan(ann[1, 3])


@pytest.mark.parametrize("case", ["gappy", "all_invalid", "one_valid", "all_positive"])
def test_format_tearsheet_text_equal(case):
    r, valid = _batch(9, 36)
    row = {"gappy": 0, "all_invalid": 1, "one_valid": 3, "all_positive": 4}[case]
    got = format_tearsheet(tearsheet(torch.as_tensor(r[row]), torch.as_tensor(valid[row])),
                           case)
    want = jts.format_tearsheet(jts.tearsheet(jnp.asarray(r[row]), jnp.asarray(valid[row])),
                                case)
    assert got == want
    assert got.startswith(f"-- tearsheet: {case} --")
