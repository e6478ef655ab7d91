"""JAX's random permutation, reproduced in numpy.

The Inception Score shuffles its samples before it splits them, and each
split's mean depends on that order. The JAX package draws the order with
``jax.random.permutation(jax.random.PRNGKey(seed), n)``, so the port draws the
same order with the same algorithm:

- the key of an integer seed is the pair of 32-bit words ``(0, seed mod
  2**32)``, as JAX makes it with 64-bit types off (the JAX package's
  setting, under which a seed is a 32-bit integer);
- ``threefry2x32`` is the Threefry-2x32 block cipher (20 rounds, Salmon et
  al., SC 2011) as JAX writes it;
- keys split and random bits are drawn in the "partitionable" layout: the
  counter of element ``i`` is the 64-bit ``i`` as two words, and 32 random
  bits are the XOR of the cipher's two output words;
- the shuffle sorts ``arange(n)`` by fresh 32-bit keys, with a stable sort,
  ``ceil(3 ln n / ln(2**32 - 1))`` times, each round with the second half of
  a fresh split of the key.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``: two
    uint32 arrays of the counters' shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota ``0 .. n-1`` as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two words (64-bit types off)."""
    return 0, int(seed) & 0xFFFFFFFF


def split(key: Tuple[int, int], num: int = 2):
    """``jax.random.split(key, num)``: ``num`` new keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def random_bits(key: Tuple[int, int], n: int) -> np.ndarray:
    """``n`` uint32 random words, as ``jax.random.bits(key, (n,))``."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1


def permutation(seed: int, n: int) -> np.ndarray:
    """``jax.random.permutation(jax.random.PRNGKey(seed), n)`` as int64."""
    x = np.arange(n, dtype=np.int64)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(np.iinfo(np.uint32).max))
    key = prng_key(seed)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x
