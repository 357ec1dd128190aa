"""JAX's default PRNG on the host, in numpy: threefry2x32 with
``jax_threefry_partitionable`` on (the default since JAX 0.5), so that the
port draws what ``jax.random`` draws from the same key.

    key = fold_in(PRNGKey(seed), step)
    normal(key, (B, E))       # jax.random.normal(key, (B, E)), float32
    permutation(fold_in(key, 1), E)
    randint(key, (B, 1), 0, k)  # jax.random.randint, int32

Keys are ``uint32 [2]`` arrays, as ``jax.random.key_data`` gives them. The
integer parts (keys, ``fold_in``, ``split``, ``random_bits``, ``uniform``,
``randint`` and ``permutation``) are bit for bit JAX's. ``normal`` is ``sqrt(2) *
erfinv(u)`` on JAX's uniform ``u`` in (-1, 1), with the single-precision
erfinv that XLA's CPU backend emits (Giles' polynomial on ``w =
-log1p(-u^2)``, with XLA's log1p: Cephes' rational below |x| = sqrt(2) - 1,
else Cephes' log of 1 + x), its multiply-adds fused as XLA fuses them.
``tests/test_torch_moe_train.py`` holds every function against ``jax.random``
and states what is left of ``normal``'s difference.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK32 = 0xFFFFFFFF


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under ``key``."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 - jax.random's name
    """``jax.random.PRNGKey(seed)`` for a seed of int32's range: ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} is outside int32's range (JAX without x64)")
    return np.array([0, seed & _MASK32], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, uint32(data))``: the hash of the count pair (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, _U32), np.array([int(data) & _MASK32], _U32))
    return np.array([a[0], b[0]], _U32)


def _iota_2x32(n: int) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(_MASK32)).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` [num, 2]: key i is the hash of the 64-bit count i."""
    b1, b2 = threefry2x32(key, *_iota_2x32(num))
    return np.stack([b1, b2], axis=-1)


def _shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (int(shape),) if np.isscalar(shape) else tuple(int(s) for s in shape)


def random_bits(key: np.ndarray, shape: Union[int, Sequence[int]]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: element i (row-major) is the xor of
    the two words of the hash of the 64-bit count i."""
    shape = _shape(shape)
    b1, b2 = threefry2x32(key, *_iota_2x32(int(np.prod(shape, dtype=np.int64))))
    return (b1 ^ b2).reshape(shape)


def uniform(key: np.ndarray, shape: Union[int, Sequence[int]], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23 random bits
    as the mantissa of a float in [1, 2), minus 1, scaled, and at least minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = ((random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1)
    return np.maximum(lo, floats * (hi - lo) + lo)


def fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, rounded once: the exact product in float64, the
    sum there, and where that sum lies on a float32 tie while its own rounding
    error does not vanish, the sum moved one float64 step toward the exact value
    (so that the second rounding cannot go the wrong way)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly (TwoSum)
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    s = np.where(tie & (err != 0), np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _horner(coeffs: Sequence[float], x: np.ndarray) -> np.ndarray:
    """sum coeffs[i] x^(n-1-i), highest degree first, one fused multiply-add a step."""
    p = np.full_like(x, np.float32(coeffs[0]))
    for c in coeffs[1:]:
        p = fma32(p, x, np.float32(c))
    return p


# Cephes' log1p rational, numerator and denominator, highest degree first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
            2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
            3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Cephes' logf polynomial, and ln 2 split in two
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LN2_LO, _LN2_HI = -2.12194440e-4, 0.693359375
# Giles' single-precision erfinv, for w < 5 and w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _log(v: np.ndarray) -> np.ndarray:
    """Cephes' single-precision log of positive normal floats, as XLA's CPU backend
    evaluates it: the mantissa m in [sqrt(1/2), sqrt(2)) less 1, a degree-8
    polynomial in three fused parts, and e*ln2 added back in two pieces."""
    f32 = np.float32
    bits = v.astype(f32).view(_U32)
    e = f32(1) + ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(f32)
    m = ((bits & _U32(~0x7F800000 & _MASK32)) | np.array(0.5, f32).view(_U32)).view(f32)  # [0.5, 1)
    low = m < f32(0.707106781186547524)
    x = (m - f32(1)) + np.where(low, m, f32(0))
    e = e - np.where(low, f32(1), f32(0))
    x2 = x * x
    x3 = x2 * x
    y = fma32(x, f32(_LOG_P[0]), f32(_LOG_P[1]))
    y1 = fma32(x, f32(_LOG_P[3]), f32(_LOG_P[4]))
    y2 = fma32(x, f32(_LOG_P[6]), f32(_LOG_P[7]))
    y = fma32(y, x, f32(_LOG_P[2]))
    y1 = fma32(y1, x, f32(_LOG_P[5]))
    y2 = fma32(y2, x, f32(_LOG_P[8]))
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, f32(_LN2_LO) * e)
    x = x - f32(0.5) * x2
    x = x + y
    return x + f32(_LN2_HI) * e


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's log1p in float32: Cephes' rational where |x| < sqrt(2) - 1, else log(1 + x)."""
    f32 = np.float32
    x2 = x * x
    small = x + (f32(-0.5) * x2 + (x * x2) * (_horner(_LOG1P_P, x) / _horner(_LOG1P_Q, x)))
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log(f32(1) + x)
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 erfinv of x in (-1, 1) (+-inf at +-1), as XLA's CPU backend computes it."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -_log1p(x * -x)
    lt = w < f32(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3))
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, w, np.where(lt, f32(a), f32(b)))
    return np.where(np.abs(x) == f32(1), x * f32(np.inf), p * x)


def normal(key: np.ndarray, shape: Union[int, Sequence[int]]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: sqrt(2) * erfinv(u), u uniform
    in (nextafter(-1, 0), 1)."""
    u = uniform(key, shape, np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    return np.float32(np.sqrt(2)) * erfinv(u)


def normal_scaled(key: np.ndarray, shape: Union[int, Sequence[int]], const: float, scale=1.0) -> np.ndarray:
    """``normal(key, shape) * const * scale`` (``const`` a Python float, ``scale`` a
    float32 scalar) as XLA compiles that product: the constant factors folded
    into one, ``float32(sqrt(2)) * float32(const)``, times ``scale``, times
    ``erfinv(u)``. (Rounded in that order, a third of the values differ from
    ``normal(...) * const * scale`` by an ulp.)"""
    u = uniform(key, shape, np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    return erfinv(u) * (np.float32(scale) * (np.float32(np.sqrt(2)) * np.float32(const)))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` (int32): ceil(3 ln n / ln(2^32 - 1))
    rounds, each splitting the key and stably sorting by 32 random bits."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x


def randint(key: np.ndarray, shape: Union[int, Sequence[int]], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 bounds: two sets of
    32 random bits from the key's split, ``higher`` and ``lower``, folded into
    ``span = maxval - minval`` (1 where maxval <= minval) as ``((higher % span) *
    m + lower % span) % span`` with ``m = (2^16 % span)^2 % span``, the product
    and the sum wrapping in uint32, plus minval (int32)."""
    shape = _shape(shape)
    lo, hi = int(minval), int(maxval)
    for v in (lo, hi):
        if not -2**31 <= v < 2**31:
            raise OverflowError(f"bound {v} is outside int32's range (JAX without x64)")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(1) if hi <= lo else _U32((hi - lo) & _MASK32)
    multiplier = _U32(2**16) % span
    with np.errstate(over="ignore"):
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int64(lo) + offset.astype(np.int64)).astype(np.int32)
