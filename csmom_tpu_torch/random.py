"""Counter-based random numbers with the bits of ``jax.random``.

Counterpart of ``jax.random`` under the JAX package's settings
(``jax_default_prng_impl="threefry2x32"``, ``jax_threefry_partitionable=True``):
the same keys give the same bits, so a bootstrap or a random fill drawn here
equals the JAX package's draw index for index.

- a key is an int64 tensor ``[2]`` (or ``[..., 2]`` from :func:`split`)
  holding the two uint32 words of a JAX key;
- every value is computed in int64 with an explicit ``& 0xFFFFFFFF``:
  torch has no shifts on ``uint32`` on the CPU and no ``uint64``
  arithmetic, so 64-bit draws are int64 bit patterns, and ``randint``'s
  unsigned products and remainders are built from their two 32-bit
  words;
- the draw runs on the key's device.

The JAX package's production setting keeps 64-bit types off, so its
``randint`` draws int32 and its ``uniform`` float32; these are the
defaults here.  Its test suite turns 64-bit types on, where the defaults
are int64 and float64: pass ``dtype`` to reproduce those.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry_2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words held in
    int64 tensors: key ``(k1, k2)``, counters ``(x1, x2)`` -> two words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _as_key(key):
    key = torch.as_tensor(key)
    if key.shape != (2,):
        raise ValueError(f"a key is 2 words, got shape {tuple(key.shape)}")
    return key.to(torch.int64) & _M32


def _iota_2x32(shape, device):
    """The flat index of every element of ``shape`` as (high, low) words."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (i >> 32).reshape(shape), (i & _M32).reshape(shape)


def _hash(key, shape):
    key = _as_key(key)
    hi, lo = _iota_2x32(tuple(shape), key.device)
    return threefry_2x32(key[0], key[1], hi, lo)


def PRNGKey(seed: int, device=None):
    """The key of an integer seed: its high and low 32-bit words.

    A key is a two-word tensor like ``torch.tensor``'s own results, on the
    CPU unless ``device`` says otherwise; the samplers draw on the key's
    device and the bootstraps move it to their data's.
    """
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def split(key, num=2):
    """``num`` new keys (an int or a shape): int64 ``[*shape, 2]``."""
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    b1, b2 = _hash(key, shape)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data: int):
    """A new key from ``key`` and one 32-bit integer."""
    key = _as_key(key)
    x1 = torch.zeros(1, dtype=torch.int64, device=key.device)
    x2 = torch.full((1,), int(data) & _M32, dtype=torch.int64, device=key.device)
    b1, b2 = threefry_2x32(key[0], key[1], x1, x2)
    return torch.cat([b1, b2])


def random_bits(key, bit_width: int, shape):
    """Uniform random bits: uint32 values in int64 (``bit_width=32``) or
    uint64 bit patterns as int64 (``bit_width=64``)."""
    b1, b2 = _hash(key, shape)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _words(key, bit_width: int, shape):
    """One draw of ``bit_width`` random bits as (high, low) uint32 words."""
    b1, b2 = _hash(key, shape)
    if bit_width == 32:
        return torch.zeros_like(b1), b1 ^ b2
    return b1, b2


def _mul_word(a, b: int):
    """(high, low) words of ``a * b`` for uint32 words ``a`` and an int
    ``0 <= b < 2**32``, from 16-bit pieces of ``b`` (no product passes
    2**49)."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (s >> 32) + (p1 >> 16), s & _M32


def _mul64(x, b: int):
    """``x * b mod 2**64`` for a uint64 ``x`` held as words and an int
    ``0 <= b < 2**64``."""
    hi, lo = x
    carry, out_lo = _mul_word(lo, b & _M32)
    out_hi = carry + _mul_word(hi, b & _M32)[1] + _mul_word(lo, b >> 32)[1]
    return out_hi & _M32, out_lo


def _add64(x, y):
    """``x + y mod 2**64`` of two uint64 values held as words."""
    lo = x[1] + y[1]
    return (x[0] + y[0] + (lo >> 32)) & _M32, lo & _M32


def _urem64(x, span: int):
    """``x mod span`` of a uint64 ``x`` held as words, ``0 <= span < 2**64``
    (XLA's unsigned remainder: ``x mod 0 == x``)."""
    hi, lo = x
    if span == 0:
        return x
    if span < 1 << 31:   # every product below fits in int64
        r = ((hi % span) * ((1 << 32) % span) + lo % span) % span
        return torch.zeros_like(r), r
    # binary long division over the low word's 32 bits, from hi mod span
    # (hi itself when span > hi's range): the remainder r < span is held
    # as words, and a bit shifted out of the high word means r >= span
    s_hi, s_lo = span >> 32, span & _M32
    r_hi = torch.zeros_like(hi)
    r_lo = hi % span if span <= _M32 else hi
    for i in range(31, -1, -1):
        out = r_hi >> 31
        r_hi = ((r_hi << 1) | (r_lo >> 31)) & _M32
        r_lo = ((r_lo << 1) | ((lo >> i) & 1)) & _M32
        ge = (out == 1) | (r_hi > s_hi) | ((r_hi == s_hi) & (r_lo >= s_lo))
        d_lo = r_lo - s_lo
        r_hi = torch.where(ge, (r_hi - s_hi - (d_lo < 0).to(torch.int64)) & _M32, r_hi)
        r_lo = torch.where(ge, d_lo & _M32, r_lo)
    return r_hi, r_lo


def _join(x):
    """The int64 whose bit pattern is the uint64 held as words ``x``."""
    hi, lo = x
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


def randint(key, shape, minval: int, maxval: int, dtype=torch.int32):
    """Integers in ``[minval, maxval)``, as ``jax.random.randint``: two
    draws of the type's width from a split key, the high one scaled by
    ``2**width mod span`` (the type's overflow included), then ``mod span``.

    ``dtype`` is ``torch.int32`` (the JAX package's production draw) or
    ``torch.int64`` (its draw with 64-bit types on); the bounds are Python
    ints.  Every value is a uint64 held as two uint32 words, so spans up to
    ``2**64 - 1`` take the unsigned arithmetic XLA does.
    """
    if dtype == torch.int32:
        nbits = 32
    elif dtype == torch.int64:
        nbits = 64
    else:
        raise TypeError(f"randint draws int32 or int64, got {dtype}")
    lo_t, hi_t = -(1 << (nbits - 1)), (1 << (nbits - 1)) - 1
    minval, maxval = int(minval), int(maxval)
    maxval_out_of_range = maxval > hi_t
    minval = min(max(minval, lo_t), hi_t)
    maxval = min(max(maxval, lo_t), hi_t)
    span = (maxval - minval) % (1 << nbits)
    if maxval <= minval:
        span = 1
    elif maxval_out_of_range:
        span = (span + 1) % (1 << nbits)

    k1, k2 = split(key)
    higher = _words(k1, nbits, shape)
    lower = _words(k2, nbits, shape)
    half = 1 << (nbits // 2)
    mult = (half % span) if span else half
    mult = (mult * mult) % (1 << nbits)
    mult = mult % span if span else mult
    offset = _add64(_mul64(_urem64(higher, span), mult), _urem64(lower, span))
    if nbits == 32:   # the sum wraps at the type's width
        offset = (torch.zeros_like(offset[0]), offset[1])
    offset = _urem64(offset, span)
    m = minval % (1 << 64)
    return _join(_add64(offset, (m >> 32, m & _M32))).to(dtype)


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """Floats in ``[minval, maxval)`` as ``jax.random.uniform``: the top
    mantissa bits of one draw of the type's width over an exponent of 1,
    minus 1, scaled; ``dtype`` is ``torch.float32`` or ``torch.float64``."""
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    elif dtype == torch.float64:
        bits = random_bits(key, 64, shape)
        word = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
    else:
        raise TypeError(f"uniform draws float32 or float64, got {dtype}")
    floats = word.view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    # XLA contracts the scale and shift into one fused multiply-add, and
    # addcmul rounds once as well (a separate product and sum can differ
    # by an ulp on a range other than [0, 1))
    return torch.maximum(lo, torch.addcmul(lo, floats, hi - lo))
