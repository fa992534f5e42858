"""The part of ``jax.random`` that the default VGG19 draw needs, in numpy:
``PRNGKey``, ``split``, 32-bit random bits, ``uniform`` and ``normal`` at
float32, for the default threefry2x32 key with JAX's
``jax_threefry_partitionable`` setting on (the default since JAX 0.5; a
split and a draw hash a 64-bit counter over the output shape).

Keys are (2,) uint32 arrays, as ``jax.random.key_data`` gives them. The
key splits and the random bits are bit-equal to JAX's. ``normal`` is
``sqrt(2) * erf_inv(u)`` with XLA's float32 ``erf_inv`` polynomial, its
multiply-adds fused (each rounded once, as XLA's CPU code does), and its
``log1p`` as XLA's (a Cephes rational near 0, else ``log(1 + x)``); that
``log`` is numpy's, where XLA's CPU code has its own approximation, so
about 0.5 % of the values come out 1-3 ulp from JAX's
(``tests/test_torch_port_jax_random.py`` holds the bound).
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed):                                  # noqa: N802 (JAX's name)
    """The threefry key of an integer seed: its high and low 32 bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123) of the counter pairs
    (x0, x1) under ``key``; uint32 arrays of one shape in and out."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))
    x0 = x0.astype(_U32) + ks[0]
    x1 = x1.astype(_U32) + ks[1]
    with np.errstate(over='ignore'):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                high = x1 << _U32(r)            # x1 rotated left by r
                x1 >>= _U32(32 - r)
                x1 |= high
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _counters(shape):
    """The 64-bit row-major iota over ``shape`` as (high, low) words."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(_U32).reshape(shape),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32).reshape(shape))


def split(key, num=2):
    """``jax.random.split``: (num, 2) uint32 keys."""
    hi, lo = _counters((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def random_bits(key, shape):
    """32-bit random words of ``shape`` (``jax.random.bits``)."""
    hi, lo = _counters(tuple(shape))
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def _fma32(a, b, c):
    """float32 a * b + c rounded once (exact in float64 for float32
    operands: the product has at most 48 significant bits)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """float32 uniform on [minval, maxval): the top 23 bits as a mantissa
    in [1, 2), minus 1, scaled and shifted in one multiply-add."""
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


# XLA's float32 erf_inv (xla/client/lib/math.cc ErfInv32, chlo's
# erf_inv expansion): a degree-8 polynomial in w - 2.5 (w < 5) or
# sqrt(w) - 3, w = -log1p(-x^2)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


# XLA's log1p (its elemental emitter): numerator and denominator of the
# Cephes rational for |x| < sqrt(2) - 1, highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _polynomial(coefs, x):
    p = np.full_like(x, np.float32(coefs[0]))
    for c in coefs[1:]:
        p = _fma32(p, x, np.float32(c))
    return p


def log1p(x):
    """XLA's float32 log1p of a float32 array."""
    x = np.asarray(x, np.float32)
    out = np.log((x + np.float32(1)).astype(np.float64)).astype(np.float32)
    small = np.abs(x) < np.float32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    r = _polynomial(_LOG1P_NUM, xs) / _polynomial(_LOG1P_DEN, xs)
    out[small] = xs + _fma32(np.full_like(xs, np.float32(-0.5)), x2,
                             xs * x2 * r)
    return out


def erf_inv(x):
    """XLA's float32 erf_inv of a float32 array."""
    x = np.asarray(x, np.float32)
    w = -log1p(-(x * x))
    small = w < np.float32(5.0)
    p = _polynomial(_ERFINV_SMALL, w - np.float32(2.5))
    p[~small] = _polynomial(_ERFINV_LARGE,
                            np.sqrt(w[~small]) - np.float32(3.0))
    out = p * x
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


def normal(key, shape):
    """``jax.random.normal`` at float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)
