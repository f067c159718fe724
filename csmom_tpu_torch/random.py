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
- the draw runs on the key's device;
- :func:`normal` inverts the error function with XLA's own polynomial
  (:func:`erf_inv`), not ``torch.erfinv``, whose different algorithm
  gives other normals from the same uniforms.

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


def fold_in(key, data):
    """A new key from ``key`` and 32-bit integer data.

    ``data`` is an int (one key ``[2]``) or an integer tensor of any shape
    (a key ``[*data.shape, 2]`` per element).  ``key`` is one key ``[2]``
    or a batch ``[..., 2]`` that broadcasts against ``data``, so a grid of
    keys folds in one call."""
    key = torch.as_tensor(key)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is 2 words, got shape {tuple(key.shape)}")
    key = key.to(torch.int64) & _M32
    x2 = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    b1, b2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(x2), x2)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key, bit_width: int, shape):
    """Uniform random bits: uint32 values in int64 (``bit_width=32``) or
    uint64 bit patterns as int64 (``bit_width=64``)."""
    return _bits(*_hash(key, shape), bit_width)


def _bits(b1, b2, bit_width: int):
    """One draw of ``bit_width`` bits from a block's two output words."""
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


def _unit_floats(bits, dtype):
    """Floats in ``[0, 1)`` from random bits of the type's width."""
    if dtype == torch.float32:
        word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    elif dtype == torch.float64:
        word = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
    else:
        raise TypeError(f"uniform draws float32 or float64, got {dtype}")
    return word.view(dtype) - 1.0


def uniform_per_key(keys, dtype=torch.float32):
    """One ``uniform(key, (), dtype)`` draw for each key of a batch
    ``[..., 2]``: a float tensor ``[...]``, on the keys' device."""
    keys = torch.as_tensor(keys).to(torch.int64) & _M32
    zero = torch.zeros((), dtype=torch.int64, device=keys.device)
    b1, b2 = threefry_2x32(keys[..., 0], keys[..., 1], zero, zero)
    return _unit_floats(_bits(b1, b2, 32 if dtype == torch.float32 else 64), dtype)


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """Floats in ``[minval, maxval)`` as ``jax.random.uniform``: the top
    mantissa bits of one draw of the type's width over an exponent of 1,
    minus 1, scaled; ``dtype`` is ``torch.float32`` or ``torch.float64``."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"uniform draws float32 or float64, got {dtype}")
    bits = random_bits(key, 32 if dtype == torch.float32 else 64, shape)
    floats = _unit_floats(bits, dtype)
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    # XLA contracts the scale and shift into one fused multiply-add, and
    # addcmul rounds once as well (a separate product and sum can differ
    # by an ulp on a range other than [0, 1))
    return torch.maximum(lo, torch.addcmul(lo, floats, hi - lo))


# XLA's ErfInv (Giles, "Approximating the erfinv function"): the
# polynomials of its f32 and f64 forms in evaluation order, highest degree
# first, as XLA's CPU backend compiles them (their values read from the
# jaxlib build the JAX package runs on)
_ERFINV32 = (
    # w < 5
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    # w >= 5
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV64 = (
    # w < 6.25: 23 terms
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    # 6.25 <= w < 16: 19 terms
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    # w >= 16: 17 terms
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221),
)
# XLA's log1p for |x| < sqrt(2) - 1 (a Cephes rational form); log(1 + x)
# elsewhere
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's float32 log (Cephes' logf): the polynomial and the split of ln 2
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
           -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
           2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375


def _fma(a, b, c):
    """``a * b + c`` rounded once: XLA's CPU backend contracts a product
    feeding a sum into a fused multiply-add, and ``addcmul`` rounds once
    as well."""
    a, b, c = (v if torch.is_tensor(v) else torch.full_like(a, v) for v in (a, b, c))
    return torch.addcmul(c, a, b)


def _horner(coeffs, x):
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _log_f32(v):
    """XLA's float32 ``log`` for v > 0: the exponent and a mantissa in
    [sqrt(1/2), sqrt(2)) - 1, a degree-9 polynomial in three parts, ln 2
    added in two pieces."""
    v = torch.clamp(v, min=torch.finfo(torch.float32).tiny)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < 0.707106781186547524
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    p = _LOGF_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOGF_Q1)
    x = _fma(-x2, 0.5, x) + y
    return _fma(e, _LOGF_Q2, x)


def _log1p(t):
    """XLA's ``log1p`` on the CPU, for ``t > -1``."""
    t2 = t * t
    ratio = _horner(_LOG1P_NUM, t) / _horner(_LOG1P_DEN, t)
    small = t + _fma(t2, -0.5, (t * t2) * ratio)
    v = t + 1.0
    large = _log_f32(v) if t.dtype == torch.float32 else torch.log(v)
    return torch.where(torch.abs(t) < 0.41421356237309504880, small, large)


def erf_inv(x):
    """The inverse error function as XLA computes it (``lax.erf_inv``):
    Giles' polynomials in ``w = -log1p(-x**2)``, with one branch at w = 5
    in float32 and two at w = 6.25 and 16 in float64, each evaluated by
    Horner's rule in fused multiply-adds; ``erf_inv(+-1) = +-inf``."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"erf_inv takes float32 or float64, got {x.dtype}")

    def const(c):
        return torch.tensor(c, dtype=x.dtype, device=x.device)

    L = _log1p(x * -x)                                    # -w
    sqrt_w = torch.sqrt(-L)
    if x.dtype == torch.float32:
        lt5 = L > -5.0
        w = torch.where(lt5, -2.5 - L, sqrt_w - 3.0)
        coef = torch.where(lt5[..., None], const(_ERFINV32[0]), const(_ERFINV32[1]))
        p = coef[..., 0]
        for i in range(1, coef.shape[-1]):
            p = _fma(p, w, coef[..., i])
    else:
        lt625, lt16 = L > -6.25, L > -16.0
        w = torch.where(lt625, -3.125 - L, torch.where(lt16, sqrt_w - 3.25, sqrt_w - 5.0))
        a, b, c = (const(t) for t in _ERFINV64)
        p = torch.where(lt16, torch.where(lt625, a[0], b[0]), c[0])
        for i in range(1, 23):
            if i < 17:
                ci = torch.where(lt16, torch.where(lt625, a[i], b[i]), c[i])
                p = _fma(p, w, ci)
            elif i < 19:
                p = torch.where(lt16, _fma(p, w, torch.where(lt625, a[i], b[i])), p)
            else:
                p = torch.where(lt625, _fma(p, w, a[i]), p)
    return x * torch.where(torch.abs(x) == 1.0, torch.inf, p)


def normal(key, shape=(), dtype=torch.float32):
    """Standard normals as ``jax.random.normal``: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform on ``[nextafter(-1, 0), 1)`` from the
    same key; ``dtype`` is ``torch.float32`` or ``torch.float64``."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype))
    u = uniform(key, shape, dtype, float(lo), 1.0)
    return erf_inv(u) * torch.tensor(math.sqrt(2.0), dtype=dtype, device=u.device)
