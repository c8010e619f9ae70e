"""JAX's default random number generator, threefry-2x32, in numpy: the
stream of ``jax.random`` with ``jax_threefry_partitionable`` on (JAX's
default since 0.5), bit for bit, for the functions the data pipeline draws
from. A key is a uint32 array of two elements, as a raw ``PRNGKey``.

- :func:`prng_key` is ``jax.random.PRNGKey`` (``threefry_seed``) of a
  32-bit seed: (0, seed mod 2**32);
- :func:`fold_in` hashes (0, data) under the key;
- :func:`split` and :func:`random_bits` hash the 64-bit counters 0, 1, ...
  of the output shape (row-major), as two uint32 halves (high, low); split
  keeps both words of each hash, 32-bit bits are their xor;
- :func:`randint` is ``jax.random.randint`` over int32: two draws of 32
  bits, combined modulo the span with uint32 arithmetic that wraps;
- :func:`uniform` puts 23 random bits in the mantissa of a float in
  [1, 2), then scales (a fused multiply-add); :func:`normal` is sqrt(2) erfinv(u) of a uniform u on
  (nextafter(-1, 0), 1), erfinv being XLA's float32 approximation (Giles'
  polynomials in w = -log1p(-u**2), each step a fused multiply-add). Its
  log1p is XLA's own; numpy's, rounded from float64, differs from it in
  the last bit now and then, and so about 1 % of the normal draws differ
  from JAX's by an ulp of float32, a few ulps where |u| nears 1.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray,
                 x2: np.ndarray) -> tuple:
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under ``key``: two uint32 arrays of their shape."""
    k1, k2 = (np.asarray(key, dtype=_U32)[i:i + 1] for i in (0, 1))
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, dtype=_U32) + ks[0], np.asarray(x2, dtype=_U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits."""
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed % 2**32], dtype=_U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    y1, y2 = threefry2x32(key, np.zeros(1, _U32),
                          np.array([data % 2**32], dtype=_U32))
    return np.concatenate([y1, y2])


def _counters(shape) -> tuple:
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(_U32).reshape(shape),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32).reshape(shape))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    y1, y2 = threefry2x32(key, *_counters((num,)))
    return np.stack([y1, y2], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits an element (uint32) of ``shape``."""
    y1, y2 = threefry2x32(key, *_counters(tuple(shape)))
    return y1 ^ y2


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` for
    int32 bounds with minval < maxval."""
    if not -2**31 <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"randint over int32 needs minval < maxval within "
                         f"int32, got [{minval}, {maxval})")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval)
    multiplier = 2**16 % int(span)
    # uint32 products wrap: a span above 2**16 makes the multiplier 0
    multiplier = _U32(multiplier * multiplier % 2**32 % int(span))
    offset = (higher % span) * multiplier + lower % span
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


def uniform(key: np.ndarray, shape, minval: float,
            maxval: float) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(32 - 23)) | one).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # floats * (hi - lo) + lo as one fused multiply-add, as XLA emits it
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


#: XLA's ErfInv32: the coefficients for w < 5 and for w >= 5
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941],
                         np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682], np.float32)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv of ``x`` in (-1, 1)."""
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        # c + p * w as one fused multiply-add: the product of two float32
        # values is exact in float64
        c = np.where(small, cs, cl).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(
            np.float32)
    return p * x


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erfinv(u)
