"""JAX's threefry2x32 stream in integer tensor arithmetic.

``jax.random.PRNGKey(seed)`` is two 32-bit words, the seed's high and
low halves; ``jax.random.uniform(key, (n,))`` hashes a counter per
element with threefry2x32 (20 rounds, Salmon et al. 2011, JAX's
``prng.threefry2x32``). With ``jax_threefry_partitionable`` set (the
default from JAX 0.5), the counters are the flat index split into its
high and low 32-bit words, and an element's 32 bits are the two output
words xor-ed together (``prng._threefry_random_bits_partitionable``).
The uniform then takes the top 23 bits as the mantissa of a float in
[1, 2) and subtracts 1.0 (``random._uniform``).

Every word is held in int64 and masked to 32 bits after each add and
shift, so the card and the CPU compute the same bits. GOSS's legacy
sampler (models/boosting.py ``legacy_goss_sample``) draws from it.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``'s words (high, low) of a seed in
    [-2^63, 2^64)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & _MASK, seed & _MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(key: tuple, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """threefry2x32 of the counter words ``x0``, ``x1`` (int64 tensors
    holding uint32 values) under ``key`` = (k0, k1): the two output
    words, int64 holding uint32."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def random_bits(key: tuple, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` under the partitionable stream:
    [n] int64 holding uint32."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & _MASK)
    return b0 ^ b1


def uniform(key: tuple, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: [n] float32 in [0, 1)."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
