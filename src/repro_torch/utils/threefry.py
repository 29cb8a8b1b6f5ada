"""JAX's Threefry-2x32 key chain in numpy uint32 arithmetic.

The reference's Pegasos fit (``core/averaging.py::train_linear_svm``)
draws its sample index at step t as
``jax.random.randint(jax.random.fold_in(PRNGKey(seed), t), (), 0, n)``.
The port draws the same indices without JAX: this module repeats the
chain of the default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (the default since jax 0.5):

  * ``prng_key(seed)``: the raw key ``(0, seed)`` of a seed below 2^32;
  * ``fold_in(key, data)``: the hash of the counter pair ``(0, data)``;
  * ``split(key)``: the hash of the counters ``(0, 0)`` and ``(0, 1)``,
    one new key each;
  * ``randint(key, lo, hi)``: two 32-bit draws, one from each half of
    ``split(key)``, each the XOR of the hash's two words at counter
    ``(0, i)``, folded into ``[lo, hi)`` as ``jax._src.random._randint``
    folds them (higher word times ``2^32 mod span``, plus the lower word,
    modulo the span, all in wrapping uint32).

Every function takes and returns uint32 arrays and is vectorised over a
leading batch of keys, so a fit's ``epochs * n`` indices are drawn in one
call. ``tests/test_torch_averaging.py`` holds the draws to jax's bit for
bit.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words
    ``(x0, x1)`` under ``key`` (..., 2); the words broadcast against the
    key's batch. Returns the two output words."""
    key = np.asarray(key, np.uint32)
    ks = [key[..., 0], key[..., 1]]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    with np.errstate(over="ignore"):   # uint32 sums wrap, as the hash wants
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as raw uint32 words (2,)."""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for uint32 ``data`` (scalar or a
    batch); returns keys (..., 2)."""
    a, b = threefry2x32(key, np.uint32(0), np.asarray(data, np.uint32))
    return np.stack([a, b], axis=-1)


def split(key: np.ndarray):
    """``jax.random.split(key)``: the two new keys, each (..., 2)."""
    hi, lo = threefry2x32(np.asarray(key, np.uint32)[..., None, :], np.uint32(0),
                          np.arange(2, dtype=np.uint32))
    keys = np.stack([hi, lo], axis=-1)
    return keys[..., 0, :], keys[..., 1, :]


def random_bits32(key: np.ndarray) -> np.ndarray:
    """One 32-bit draw a key (``jax.random.bits(key, (), uint32)``)."""
    a, b = threefry2x32(key, np.uint32(0), np.uint32(0))
    return a ^ b


def randint(key: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """``jax.random.randint(key, (), lo, hi)`` (int32) for each key of the
    batch ``key`` (..., 2)."""
    span = np.uint32(max(int(hi) - int(lo), 1))
    k1, k2 = split(key)
    higher, lower = random_bits32(k1), random_bits32(k2)
    wrap = np.uint64(0xFFFFFFFF)
    mult = np.uint64(np.uint32(2**16) % span)
    mult = ((mult * mult) & wrap) % np.uint64(span)   # the square wraps at span > 2^16
    offset = ((higher % span).astype(np.uint64) * mult) & wrap
    offset = (offset + (lower % span)) & wrap
    offset = offset % np.uint64(span)
    return (int(lo) + offset.astype(np.int64)).astype(np.int32)


def pegasos_indices(seed: int, steps: int, n: int) -> np.ndarray:
    """The reference Pegasos fit's sample index at each of ``steps`` steps:
    ``randint(fold_in(PRNGKey(seed), uint32(float32(t))), (), 0, n)``."""
    t = np.arange(steps, dtype=np.float32).astype(np.uint32)
    return randint(fold_in(prng_key(seed), t), 0, n)
