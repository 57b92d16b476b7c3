"""Bit-exact port of JAX's threefry2x32 PRNG (partitionable mode).

The reference draws every random number through ``jax.random`` with
``jax_threefry_partitionable=True`` (the default on jax 0.9). This module
reproduces ``PRNGKey``, ``split``, ``fold_in``, ``randint`` and
``uniform`` bit for bit as integer torch ops on the key's device, so the
port and the reference pick the same sources, candidates and probe
targets from the same seed.

A key is an ``int64[2]`` tensor holding the two u32 words. Counts are
the flattened element index as a (hi, lo) u32 pair, hashed with the key
through 20 rounds of threefry2x32 (jax/_src/prng.py ``threefry2x32``
lowering, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counts (x1, x2) under key (k1, k2); all
    int64 tensors holding u32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < (1 << 31):
        raise ValueError(f"seed must be in [0, 2^31), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _counts(shape: tuple[int, ...], device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (idx >> 32).reshape(shape), (idx & MASK).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> int64[num, 2]."""
    hi, lo = _counts((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a non-negative 32-bit datum."""
    d = torch.tensor([int(data) & MASK], dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (u32 in int64), partitionable layout."""
    hi, lo = _counts(tuple(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def randint(
    key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 range,
    Python-int bounds) -> int64 tensor. Same biased double-width modulus
    as the reference, including its u32 wraparound."""
    minval, maxval = int(minval), int(maxval)
    if not (-(1 << 31) <= minval < (1 << 31) and maxval < (1 << 31)):
        raise ValueError("randint bounds must lie in the int32 range")
    k = split(key, 2)
    higher = random_bits(k[0], shape)
    lower = random_bits(k[1], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (((1 << 16) % span) ** 2) % span
    off = ((((higher % span) * mult) & MASK) + (lower % span)) & MASK
    return minval + off % span


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) as float32, bit-exact:
    23 random mantissa bits under a 1.0 exponent, minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
