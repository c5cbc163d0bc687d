"""Bit-exact PyTorch replica of the ``jax.random`` calls of the capped KS.

nanomod_tpu/stats/kernels.py ``capped_ks_d`` draws its subsamples with
``jax.random`` (threefry2x32, ``jax_threefry_partitionable`` on, 32-bit
default integers):

    base   = PRNGKey(seed)
    k1, k2 = split(fold_in(base, row_index))
    idx    = randint(k, (repeats, cov), 0, max(count, 1))

The golden tables were made with those draws, and the port must draw the
same indices on every tiling, so this module recomputes them: the same
threefry2x32 hash, the same key derivation and the same ``randint``
reduction.  A 32-bit word is held in an int64 tensor (values in
[0, 2^32)), since torch's uint32 lacks most operators; every sum is masked
back to 32 bits.  Works on any device.  csrc/threefry.cuh is the kernel's
copy of the same arithmetic.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block (20 rounds) of key (k0, k1) on the counter
    pair (x0, x1); arguments broadcast.  Returns (y0, y1)."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as two 32-bit words.  With 64-bit
    types off (JAX's default) the seed is first cut to int32, so the high
    word is 0 and the low word is the seed modulo 2^32."""
    return 0, int(seed) & MASK


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the hash of the counter
    (0, data) under ``key``; ``data`` is taken modulo 2^32."""
    return threefry2x32(key[0], key[1], 0, data & MASK)


def split(key):
    """``jax.random.split(key)`` (partitionable): the keys of counters
    (0, 0) and (0, 1)."""
    return fold_in(key, 0), fold_in(key, 1)


def random_bits(key, counters):
    """32 random bits per element: ``bits1 ^ bits2`` of the counter pair
    (0, n), n the element's flat index (``counters``)."""
    y0, y1 = threefry2x32(key[0], key[1], 0, counters)
    return y0 ^ y1


def randint(key, counters, maxval):
    """``jax.random.randint(key, shape, 0, maxval)`` at the flat element
    indices ``counters`` (int64, broadcasting against the key's words) for
    maxval >= 1: with (kh, kl) = split(key), ``(bits(kh) % span * m +
    bits(kl) % span) % span``, m = (2^16 % span)^2 % span, in wrapping
    uint32.  Returns int64 indices."""
    kh, kl = split(key)
    higher = random_bits(kh, counters)
    lower = random_bits(kl, counters)
    span = maxval
    mult = torch.remainder(torch.full_like(span, 65536), span)
    mult = ((mult * mult) & MASK) % span
    return (((higher % span) * mult + lower % span) & MASK) % span


def row_keys(seed: int, row_index):
    """The two per-row ``randint`` keys of capped_ks_d: ``split(
    fold_in(PRNGKey(seed), row_index))`` for rows ``row_index`` (int
    tensor [P]).  Returns ((k1a, k1b), (k2a, k2b)), int64 [P] words."""
    base = prng_key(seed)
    row = fold_in(base, row_index.to(torch.int64))
    return split(row)
