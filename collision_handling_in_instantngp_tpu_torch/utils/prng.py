"""JAX's default PRNG (threefry2x32) on the host, in numpy.

A copy of what ``jax.random`` computes for ``PRNGKey``, ``split``, 32-bit
``bits`` and ``uniform`` as JAX 0.9.0 runs them by default:
``jax_default_prng_impl`` threefry2x32, ``jax_threefry_partitionable`` True,
``jax_enable_x64`` False. With it ``models/gngf.py: init_params(cfg, seed)``
draws the JAX package's ``init_params(PRNGKey(seed), cfg)`` bit for bit, so a
seed names the same start in both packages.

A key is a (2,) uint32 array. Under the partitionable layout every output
element i of a draw of ``shape`` hashes the 64-bit counter i (its high and
low words, ``iota_2x32_shape``) under the key; a split keeps both words of
each hash as a new key, and 32-bit bits are the two words XORed.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (JAX ``prng._threefry2x32_lowering``):
    the key (2,) uint32 hashes the counter words ``x0``, ``x1`` (uint32
    arrays of one shape) into two uint32 arrays of that shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3]
        x1 = x1 + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: a 32-bit seed (JAX without x64) is the
    key (0, seed mod 2^32)."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(shape: Sequence[int]):
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters((int(num),)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    b0, b1 = threefry2x32(key, *_counters(tuple(int(s) for s in shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    The top 23 bits become a float in [1, 2), less 1; then
    ``f * (maxval - minval) + minval``, clamped below at ``minval``. XLA on
    the CPU fuses that multiply and add into one fused multiply-add, rounded
    once: float32 numpy, rounding the product first, misses it by an ulp on
    some draws, so the product and sum are taken in float64 and rounded once
    to float32."""
    lo = np.float32(minval)
    hi = np.float32(maxval)
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    span = np.float32(hi - lo)
    out = (f.astype(np.float64) * np.float64(span) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out)
