"""The port's threefry against jax.random: keys, split and fold_in chains,
raw bits of both widths, randint in int32 and int64 and uniform in float32
and float64, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu_torch import random

torch.set_num_threads(2)

SEEDS = [0, 1, 42, 2**33 + 5, -1]


def _np(jkey):
    return np.asarray(jkey).astype(np.int64)


def _chain(seed):
    """The same key through PRNGKey -> split -> fold_in -> split in both."""
    jk, k = jax.random.PRNGKey(seed), random.PRNGKey(seed)
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    jk, k = jax.random.split(jk, 3)[2], random.split(k, 3)[2]
    jk, k = jax.random.fold_in(jk, 2**32 - 7), random.fold_in(k, 2**32 - 7)
    jk, k = jax.random.split(jk)[0], random.split(k)[0]
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    return jk, k


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    jk, k = jax.random.PRNGKey(seed), random.PRNGKey(seed)
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    for num in (1, 2, 7, (2, 3)):
        np.testing.assert_array_equal(random.split(k, num).numpy(),
                                      _np(jax.random.split(jk, num)))
    for data in (0, 1, 12345, 2**31 + 3):
        np.testing.assert_array_equal(random.fold_in(k, data).numpy(),
                                      _np(jax.random.fold_in(jk, data)))
    _chain(seed)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (200, 116)])
@pytest.mark.parametrize("width", [32, 64])
def test_random_bits(shape, width):
    for seed in SEEDS[:3]:
        jk, k = _chain(seed)
        jbits = np.asarray(jax.random.bits(
            jk, shape, dtype=jnp.uint32 if width == 32 else jnp.uint64))
        want = jbits.astype(np.int64) if width == 32 else jbits.view(np.int64)
        np.testing.assert_array_equal(random.random_bits(k, width, shape).numpy(),
                                      want)


@pytest.mark.parametrize("dtype,jdtype", [(torch.int32, jnp.int32),
                                          (torch.int64, jnp.int64)])
@pytest.mark.parametrize("lo,hi", [(0, 696), (-5, 17), (3, 3), (9, 2),
                                   (0, 2**31 - 1), (10, 2**20 + 10)])
def test_randint(dtype, jdtype, lo, hi):
    for seed in SEEDS:
        jk, k = _chain(seed)
        for shape in [(7,), (3, 5), (200, 116)]:
            got = random.randint(k, shape, lo, hi, dtype=dtype)
            want = np.asarray(jax.random.randint(jk, shape, lo, hi, dtype=jdtype))
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(), want)


def test_randint_int32_out_of_range_bounds():
    """Bounds past the type clip, and a span of the whole type wraps."""
    jk, k = _chain(3)
    for lo, hi in [(-2**31, 2**31), (-2**40, 5), (0, 2**40)]:
        np.testing.assert_array_equal(
            random.randint(k, (50,), lo, hi, dtype=torch.int32).numpy(),
            np.asarray(jax.random.randint(jk, (50,), lo, hi, dtype=jnp.int32)))


@pytest.mark.parametrize("lo,hi", [(-2**31, 2**31 - 1), (0, 2**31 + 10),
                                   (-2**40, 0), (-2**63, 2**63 - 1)])
def test_randint_int64_wide_spans(lo, hi):
    """Spans of 2**31 and more: the unsigned 64-bit products and
    remainders, built from 32-bit words, draw what jax.random draws."""
    for seed in SEEDS:
        jk, k = _chain(seed)
        for shape in [(7,), (200, 116)]:
            got = random.randint(k, shape, lo, hi, dtype=torch.int64)
            want = np.asarray(jax.random.randint(jk, shape, lo, hi, dtype=jnp.int64))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float64, jnp.float64)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.5), (1e-3, 1e-3 + 1e-9)])
def test_uniform(dtype, jdtype, lo, hi):
    for seed in SEEDS:
        jk, k = _chain(seed)
        for shape in [(), (9,), (40, 25)]:
            got = random.uniform(k, shape, dtype=dtype, minval=lo, maxval=hi)
            want = np.asarray(jax.random.uniform(jk, shape, dtype=jdtype,
                                                 minval=lo, maxval=hi))
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(), want)


def test_refusals():
    k = random.PRNGKey(0)
    with pytest.raises(TypeError, match="int32 or int64"):
        random.randint(k, (3,), 0, 5, dtype=torch.int16)
    with pytest.raises(TypeError, match="float32 or float64"):
        random.uniform(k, (3,), dtype=torch.float16)
    with pytest.raises(ValueError, match="2 words"):
        random.random_bits(torch.zeros(3, dtype=torch.int64), 32, (2,))
