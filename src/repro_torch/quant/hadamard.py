"""Randomized Hadamard transform for latent pre-conditioning (Table 4;
port of ``repro.quant.hadamard``).

Per-token quantization suffers from outlier channels; rotating by a
(randomized) Hadamard matrix flattens the distribution.  For dim = 2^k * m
the transform is H_{2^k} (x) I_m — the fast Walsh-Hadamard transform over
the largest power-of-two factor — after a fixed +-1 diagonal, seeded
with numpy's Philox exactly as the JAX package seeds it, so both packages
rotate by the same matrix.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _pow2_factor(n: int) -> int:
    p = 1
    while n % (2 * p) == 0:
        p *= 2
    return p


def rademacher_diag(dim: int, seed: int = 7) -> np.ndarray:
    g = np.random.Generator(np.random.Philox(key=[seed, dim]))
    return (g.integers(0, 2, size=dim) * 2 - 1).astype(np.float32)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard over the last axis (power-of-two blocks),
    orthonormal; computed in float32, returned in x's dtype."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    p = _pow2_factor(n)
    m = n // p
    y = x.float().reshape(lead + (m, p))
    h = 1
    while h < p:
        y = y.reshape(lead + (m, p // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    y = y.reshape(lead + (m, p)) / math.sqrt(p)
    return y.reshape(x.shape).to(x.dtype)


def _diag(dim: int, seed: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(rademacher_diag(dim, seed)).to(like.device, like.dtype)


def hadamard_transform(x: torch.Tensor, seed: int = 7) -> torch.Tensor:
    """Randomized orthogonal transform: diag(+-1) then FWHT."""
    return fwht(x * _diag(x.shape[-1], seed, x))


def hadamard_inverse(y: torch.Tensor, seed: int = 7) -> torch.Tensor:
    """FWHT is an involution (orthonormal); undo the diagonal after."""
    return fwht(y) * _diag(y.shape[-1], seed, y)
