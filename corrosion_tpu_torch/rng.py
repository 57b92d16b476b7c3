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

``split_keys`` keeps the subkeys it derived on the key object itself:
mesh positions that share a round's key (``parallel.simulate_sharded``)
derive each subkey once, not once a position, and the subkeys live as
long as their key. Keys are never modified in place, so a key object
always derives the same subkeys.

Because a count is an element's flat index in the full shape, a mesh
position can draw just its own rows: ``random_bits``, ``randint`` and
``uniform`` take ``rows`` (a ``(start, stop)`` range or an index tensor
along ``axis``) and hash only that sub-box's counts. The sub-box draw is
the full draw sliced, bit for bit, and never builds the full shape.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counts (x1, x2) under key (k1, k2); all
    int64 tensors holding u32 values, broadcast together. Between key
    injections ``a`` runs unmasked (below 2^35 in int64): only its low 32
    bits reach ``b``, which is masked after every rotation."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = x1 + ks[0]
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = a + b
            b = (((b << r) | (b >> (32 - r))) ^ a) & MASK
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < (1 << 31):
        raise ValueError(f"seed must be in [0, 2^31), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _counts(
    shape: tuple[int, ...], device, rows=None, axis: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) u32 words of each element's flat index in ``shape``,
    over the whole shape or over the sub-box that keeps ``rows`` of
    dimension ``axis`` (``(start, stop)``, or an int64 index tensor whose
    negative entries count as 0)."""
    shape = tuple(shape)
    if rows is None:
        idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
        return (idx >> 32).reshape(shape), (idx & MASK).reshape(shape)
    inner = math.prod(shape[axis + 1 :])
    if isinstance(rows, tuple) and axis == 0:
        start, stop = int(rows[0]), int(rows[1])
        idx = torch.arange(start * inner, stop * inner, dtype=torch.int64, device=device)
        sub = (stop - start,) + shape[1:]
    else:
        if isinstance(rows, tuple):
            r = torch.arange(int(rows[0]), int(rows[1]), dtype=torch.int64, device=device)
        else:
            r = torch.clamp(rows.reshape(-1), min=0)
        outer = torch.arange(math.prod(shape[:axis]), dtype=torch.int64, device=device)
        cols = torch.arange(inner, dtype=torch.int64, device=device)
        idx = ((outer[:, None, None] * shape[axis] + r[None, :, None]) * inner
               + cols[None, None, :])
        sub = shape[:axis] + (r.shape[0],) + shape[axis + 1 :]
    return (idx >> 32).reshape(sub), (idx & MASK).reshape(sub)




def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> int64[num, 2]."""
    hi, lo = _counts((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def _split_once(key: torch.Tensor, num: int) -> tuple:
    """(``split(key, num)``, its rows), made once per key object and kept
    on it."""
    made = getattr(key, "_corro_subkeys", None)
    if made is None:
        made = key._corro_subkeys = {}
    if num not in made:
        keys = split(key, num)
        made[num] = keys, keys.unbind(0)
    return made[num]


def split_keys(key: torch.Tensor, num: int = 2) -> tuple:
    """``split(key, num)`` as a tuple of ``num`` keys, derived once per key
    object."""
    return _split_once(key, num)[1]


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a non-negative 32-bit datum."""
    d = torch.tensor([int(data) & MASK], dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.cat([b1, b2])


def random_bits(
    key: torch.Tensor, shape: tuple[int, ...], rows=None, axis: int = 0
) -> torch.Tensor:
    """32 random bits per element (u32 in int64), partitionable layout;
    with ``rows``, only that sub-box of ``shape`` (see ``_counts``)."""
    hi, lo = _counts(tuple(shape), key.device, rows, axis)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def randint(
    key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int, rows=None,
    axis: int = 0,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 range,
    Python-int bounds) -> int64 tensor. Same biased double-width modulus
    as the reference, including its u32 wraparound. ``rows``/``axis``
    draw one sub-box of ``shape`` (see ``_counts``)."""
    minval, maxval = int(minval), int(maxval)
    if not (-(1 << 31) <= minval < (1 << 31) and maxval < (1 << 31)):
        raise ValueError("randint bounds must lie in the int32 range")
    # The high and low words' draws in one hash: the two keys broadcast
    # over a leading axis of 2 against the shared counts.
    keys = _split_once(key, 2)[0]
    hi, lo = _counts(tuple(shape), key.device, rows, axis)
    kshape = (2,) + (1,) * hi.dim()
    b1, b2 = threefry2x32(keys[:, 0].reshape(kshape), keys[:, 1].reshape(kshape), hi[None],
                          lo[None])
    bits = b1 ^ b2
    higher, lower = bits[0], bits[1]
    span = (maxval - minval) & MASK if maxval > minval else 1
    # 2^32 mod span, squared in u32 as the reference squares it: the
    # product wraps once span passes 2^16 (node counts past 65,536).
    mult = ((((1 << 16) % span) ** 2) & MASK) % span
    off = ((((higher % span) * mult) & MASK) + (lower % span)) & MASK
    return minval + off % span


def uniform(
    key: torch.Tensor, shape: tuple[int, ...], rows=None, axis: int = 0
) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) as float32, bit-exact:
    23 random mantissa bits under a 1.0 exponent, minus 1. ``rows``/``axis``
    draw one sub-box of ``shape`` (see ``_counts``)."""
    bits = (random_bits(key, shape, rows, axis) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
