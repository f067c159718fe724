"""The port's momentum signals against csmom_tpu on panels with late
entrants, delistings, interior gaps and zero prices."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jmom = importlib.import_module("csmom_tpu.signals.momentum")
momentum = importlib.import_module("csmom_tpu_torch.signals.momentum")

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)


def _gappy_panel(seed, a=30, m=60):
    rng = np.random.default_rng(seed)
    prices = 50 * np.exp(np.cumsum(rng.normal(0.0, 0.06, size=(a, m)), axis=1))
    prices[:5, :20] = np.nan          # late entrants
    prices[25:, 40:] = np.nan         # delistings
    prices[rng.random((a, m)) < 0.05] = np.nan  # interior gaps
    prices[7, 30] = 0.0               # zero prices
    prices[8, 10:13] = 0.0
    mask = np.isfinite(prices)
    return prices, mask


def _both(prices, mask):
    return (torch.as_tensor(prices), torch.as_tensor(mask),
            jnp.asarray(prices), jnp.asarray(mask))


@pytest.mark.parametrize("seed", [0, 1])
def test_padded_prices_and_returns(seed):
    tp, tm, jp, jm = _both(*_gappy_panel(seed))
    f, s = momentum.padded_prices(tp, tm)
    jf, js = jmom.padded_prices(jp, jm)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    r, v = momentum.monthly_returns(tp, tm)
    jr, jv = jmom.monthly_returns(jp, jm)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)


@pytest.mark.parametrize("lookback", [1, 3, 12])
@pytest.mark.parametrize("skip", [0, 1])
def test_momentum_matches_jax(lookback, skip):
    tp, tm, jp, jm = _both(*_gappy_panel(2))
    mom, valid = momentum.momentum(tp, tm, lookback=lookback, skip=skip)
    jm_, jv = jmom.momentum(jp, jm, lookback=lookback, skip=skip)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_allclose(mom.numpy(), np.asarray(jm_), **TOL)
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("skip", [0, 1, 2])
def test_formation_listed_mask(skip):
    tp, tm, jp, jm = _both(*_gappy_panel(3))
    np.testing.assert_array_equal(
        momentum.formation_listed_mask(tm, skip).numpy(),
        np.asarray(jmom.formation_listed_mask(jm, skip)))


@pytest.mark.parametrize("skip", [0, 1])
def test_momentum_dynamic_batched_equals_per_j(skip):
    """One call on a tensor of Js == the reference's per-J calls."""
    tp, tm, jp, jm = _both(*_gappy_panel(4))
    Js = [1, 3, 6, 12]
    mom, valid = momentum.momentum_dynamic(tp, tm, torch.tensor(Js), skip)
    assert mom.shape == (len(Js),) + tuple(tp.shape)
    for i, J in enumerate(Js):
        jm_, jv = jmom.momentum_dynamic(jp, jm, J, skip)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        np.testing.assert_allclose(mom[i].numpy(), np.asarray(jm_), **TOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_raw_monthly_returns_matches_jax(seed):
    """Adjacent-month returns on the unpadded panel: a gap month drops out."""
    prices, mask = _gappy_panel(seed)
    ret, valid = momentum.raw_monthly_returns(torch.as_tensor(prices),
                                              torch.as_tensor(mask))
    jret, jvalid = jmom.raw_monthly_returns(jnp.asarray(prices), jnp.asarray(mask))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), **TOL)
    assert not valid[:, 0].any() and not valid[7, 31]      # after a zero price
