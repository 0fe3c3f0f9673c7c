"""Matrix Fusion (OCMF, second half) and offline head-permutation folding
(port of ``repro.core.fusion``).

Fusion (paper eqs. (9)-(11)): with grouped value factors ``W_v[:, group
g] ~= L_g R_g`` the cache stores ``z_g = x @ L_g`` and each query head's
attention output stays latent, so the per-head block-fused projection

    W~_o[h] = R_{g(h)}[:, head-slice of h] @ W_o[rows of head h]   (r_v, d)

means decode never reconstructs values.

Permutation folding (Fig. 3): the HSR kv-head permutation ``perm`` (new
position -> old head index) is baked into the weights once — W_k and W_v
columns by kv head, W_q columns and W_o rows by blocks of q_per_kv query
heads — so decode never permutes activations.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def fuse_output_projection(R_v: torch.Tensor, W_o: torch.Tensor,
                           num_q_heads: int, num_kv_heads: int) -> torch.Tensor:
    """Block-fused output projection W~_o: (H_q, r_v, d_model).  Query
    head h reads kv head ``h // q_per_kv``, which lives in group ``kv //
    s`` at slot ``kv % s``."""
    G, r_v, sdh = R_v.shape
    d_h = W_o.shape[0] // num_q_heads
    s = sdh // d_h
    if G * s != num_kv_heads:
        raise ValueError(f"R_v groups {G}x{s} != kv heads {num_kv_heads}")
    q_per_kv = num_q_heads // num_kv_heads
    blocks = []
    for h in range(num_q_heads):
        g, j = divmod(h // q_per_kv, s)
        blocks.append(R_v[g, :, j * d_h:(j + 1) * d_h]
                      @ W_o[h * d_h:(h + 1) * d_h, :])
    return torch.stack(blocks)


def fused_output_apply(o_latent: torch.Tensor,
                       W_o_fused: torch.Tensor) -> torch.Tensor:
    """(..., H_q, r_v) x (H_q, r_v, d) -> (..., d)."""
    return torch.einsum("...hr,hrd->...d", o_latent, W_o_fused)


def _permute_blocks(W: torch.Tensor, perm: np.ndarray, block: int,
                    axis: int) -> torch.Tensor:
    """Permute contiguous ``block``-sized chunks of ``W`` along ``axis``."""
    n = W.shape[axis]
    if n % block:
        raise ValueError(f"axis size {n} not divisible by block {block}")
    nb = n // block
    if len(perm) != nb:
        raise ValueError(f"perm length {len(perm)} != num blocks {nb}")
    shape = list(W.shape)
    shape[axis:axis + 1] = [nb, block]
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=W.device)
    return W.reshape(shape).index_select(axis, idx).reshape(W.shape)


def fold_head_permutation(W_q: torch.Tensor, W_k: torch.Tensor,
                          W_v: torch.Tensor, W_o: torch.Tensor,
                          perm: Sequence[int], num_q_heads: int,
                          num_kv_heads: int):
    """Bake the HSR kv-head permutation into the attention weights."""
    perm = np.asarray(perm, dtype=np.int64)
    d_h = W_k.shape[1] // num_kv_heads
    qb = (num_q_heads // num_kv_heads) * d_h
    return (_permute_blocks(W_q, perm, qb, axis=1),
            _permute_blocks(W_k, perm, d_h, axis=1),
            _permute_blocks(W_v, perm, d_h, axis=1),
            _permute_blocks(W_o, perm, qb, axis=0))


def inverse_permutation(perm: Sequence[int]) -> np.ndarray:
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv
