"""The port's ``normal``, XLA's ``erf_inv`` and the batched ``fold_in``
against ``jax.random`` on the CPU, and ``counter_uniform`` (the limit
orders' draws) against the JAX package's.

``normal`` builds on :func:`csmom_tpu_torch.random.erf_inv`, XLA's own
polynomial evaluated in the same fused multiply-adds, not
``torch.erfinv``.  It equals ``lax.erf_inv`` bit for bit in the branch
|x| < ~0.64; beyond it the logarithm rounds apart now and then (in
float32 the emulated XLA log in 33 of 2,000,000 draws, by 1 ulp; in
float64 the C library's log against torch's in 96 of 2,000,000, by 1 or
2 ulp), so the bounds below are 1 ulp (f32) and 2 ulp (f64) in at most
0.01% of draws.  The MLP's initial draws (key 0) are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.backtest.event import counter_uniform as jax_counter_uniform
from csmom_tpu_torch import random
from csmom_tpu_torch.backtest.event import counter_uniform

torch.set_num_threads(2)

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _key(seed):
    return torch.as_tensor(np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


def _ulps(a, b):
    """Distance in units in the last place between two float arrays."""
    it = np.int32 if a.dtype == np.float32 else np.int64
    lo = np.iinfo(it).min

    def ordered(x):
        i = x.view(it).astype(np.int64)
        return np.where(i < 0, lo - i, i)

    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("np_dt,dt", DTYPES, ids=["f32", "f64"])
def test_erf_inv_is_xlas_within_one_ulp(np_dt, dt):
    x = np.random.default_rng(0).uniform(-1, 1, 200_001).astype(np_dt)
    x = np.concatenate([x, np.array(
        [0.0, -0.0, 1.0, -1.0, np.nextafter(np_dt(-1), np_dt(0)), 0.5, -0.9999],
        np_dt)])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = random.erf_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
    fin = np.isfinite(want)
    d = _ulps(got[fin], want[fin])
    assert d.max() <= (1 if np_dt == np.float32 else 2)
    assert (d > 0).sum() <= 20            # of 200,008
    # every difference sits in the large branch, |x| > ~0.64
    assert (np.abs(x[fin][d > 0]) > 0.64).all()


@pytest.mark.parametrize("np_dt,dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("seed", [0, 1, 42, 2**33 + 5])
@pytest.mark.parametrize("shape", [(5, 32), (32, 16), (1001,), ()])
def test_normal_equals_jax_random_normal(np_dt, dt, seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, np_dt))
    got = random.normal(_key(seed), shape, dt).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    d = _ulps(got.ravel(), want.ravel())
    assert d.max(initial=0) <= (1 if np_dt == np.float32 else 2)
    assert (d > 0).sum() <= max(1, d.size // 200)


def test_normal_of_a_split_key_is_the_mlp_draw():
    """The He-normal draw of the MLP's first layer, key and split as the
    JAX package takes them."""
    k = jax.random.PRNGKey(0)
    _, sub = jax.random.split(k)
    want = np.asarray(jax.random.normal(sub, (5, 32), jnp.float64))
    _, tsub = random.split(_key(0))
    assert np.array_equal(random.normal(tsub, (5, 32), torch.float64).numpy(), want)


def test_batched_fold_in_equals_jax_word_for_word():
    key = jax.random.PRNGKey(7)
    data = np.array([0, 1, 2, 77, 2**31 - 1, 4_000_000], np.int64)
    want = np.stack([np.asarray(jax.random.fold_in(key, int(d))) for d in data])
    got = random.fold_in(_key(7), torch.from_numpy(data))
    assert got.shape == (6, 2)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # a grid of keys against a row of data, broadcast in one call
    keys = random.fold_in(_key(7), torch.arange(3))
    grid = random.fold_in(keys[:, None, :], torch.arange(4)[None, :])
    for i in range(3):
        ki = jax.random.fold_in(key, i)
        for j in range(4):
            assert np.array_equal(grid[i, j].numpy(),
                                  np.asarray(jax.random.fold_in(ki, j)).astype(np.int64))
    # the scalar form is unchanged
    assert np.array_equal(random.fold_in(_key(7), 77).numpy(), want[3])


@pytest.mark.parametrize("np_dt,dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("offsets", [(0, 0), (3, 11)])
def test_counter_uniform_equals_the_reference(np_dt, dt, offsets):
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_counter_uniform(key, (6, 45), *offsets, np_dt))
    got = counter_uniform(_key(0), (6, 45), *offsets, dt)
    assert got.dtype == dt and np.array_equal(got.numpy(), want)


def test_uniform_per_key_equals_scalar_draws():
    keys = random.split(_key(3), 5)
    for dt, np_dt in ((torch.float32, np.float32), (torch.float64, np.float64)):
        got = random.uniform_per_key(keys, dt).numpy()
        want = [np.asarray(jax.random.uniform(jnp.asarray(k.numpy().astype(np.uint32)),
                                              (), np_dt)) for k in keys]
        assert np.array_equal(got, np.array(want))
