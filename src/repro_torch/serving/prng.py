"""``jax.random``'s threefry PRNG, bit for bit, in PyTorch.

The JAX package's sampler draws from ``jax.random`` with the default
``threefry2x32`` implementation and ``jax_threefry_partitionable = True``
(the default of the JAX it was written against).  This module reproduces
the parts the sampler uses, so that a request's sampled stream is the same
token for token in both packages:

  * ``prng_key(seed)``      ``jax.random.PRNGKey`` — the key [hi, lo] of
                            the seed; with 64-bit types off (the default)
                            the seed is taken modulo 2**32 and hi is 0;
  * ``fold_in(key, data)``  ``threefry_2x32(key, [0, data])``;
  * ``split(key)``          two keys hashed from the counters
                            (hi, lo) = (0, 0) and (0, 1);
  * ``random_bits(key, n)`` 32-bit words ``y1 ^ y2`` hashed from the
                            counters (0, i), i < n (the partitionable
                            scheme: one counter per output word);
  * ``uniform``             ``bits >> 9 | 0x3F800000`` read as float32,
                            minus 1, scaled into [minval, 1) and clamped
                            below at minval;
  * ``gumbel``              ``-log(-log(uniform(minval=tiny)))``, the
                            default "low" mode;
  * ``categorical``         ``argmax(gumbel + logits)`` over the last axis.

Keys are int64 tensors of shape (..., 2) whose values are the uint32 words
(PyTorch has too few uint32 operators); every word operation masks to 32
bits.  All functions broadcast over leading key dimensions, run on the
keys' device and never synchronise with the host.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcast int64 tensors holding uint32 words.  Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (2,) int64."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int in [0, 2**32) or
    a tensor broadcasting against the key's leading dimensions."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.split(key, 2)``: (..., 2) -> (..., 2, 2)."""
    lo = torch.arange(2, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: (..., 2) -> (..., n) int64."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, n, minval=_F32_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    per row: key (..., 2), logits (..., V) float32 -> (...) int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
