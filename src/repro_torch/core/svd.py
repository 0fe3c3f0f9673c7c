"""Truncated / whitened / grouped SVD primitives for ReCalKV (port of
``repro.core.svd``).

Conventions (row-vector):
  activations  X  : (N, m)   -- N calibration tokens, m = input feature dim
  weight       W  : (m, n)   -- y = x @ W
  factors      W ~= L @ R,  L: (m, r), R: (r, n); the cache stores z = x @ L.

Whitening follows SVD-LLM: minimizing ||X W - X L R||_F is equivalent to
plain truncated SVD of (S^T W) where C = X^T X = S S^T (Cholesky).

Everything runs in float32 on the operands' device; callers hold TF32
off (``repro_torch.device.full_float32``).  An SVD's column signs are
arbitrary, so factors agree with the JAX package's only up to signs:
compare products (``L @ R``), not entries.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class LowRankFactors:
    """A rank-r factorization W ~= L @ R."""

    L: torch.Tensor  # (m, r)
    R: torch.Tensor  # (r, n)

    @property
    def rank(self) -> int:
        return self.L.shape[1]

    def reconstruct(self) -> torch.Tensor:
        return self.L @ self.R


def _split(U: torch.Tensor, s: torch.Tensor, Vt: torch.Tensor, rank: int):
    r = int(rank)
    sqrt_s = torch.sqrt(s[:r])
    return U[:, :r] * sqrt_s[None, :], sqrt_s[:, None] * Vt[:r, :]


def truncated_svd(W: torch.Tensor, rank: int) -> LowRankFactors:
    """Plain Eckart-Young truncated SVD, split symmetrically (eq. (1))."""
    U, s, Vt = torch.linalg.svd(W.float(), full_matrices=False)
    L, R = _split(U, s, Vt, rank)
    return LowRankFactors(L=L, R=R)


def _safe_cholesky(C: torch.Tensor, eps_scale: float = 1e-6,
                   max_tries: int = 5) -> torch.Tensor:
    """Cholesky of a PSD covariance with adaptive diagonal jitter: the
    JAX package's jitter (``eps_scale`` times the mean diagonal) first,
    then ten times more per failed try.  A covariance of fewer distinct
    calibration inputs than dimensions (at the first layer, the distinct
    tokens' embeddings) is singular, and in float32 the first jitter may
    not lift it: JAX's Cholesky then returns NaN factors, this one tries
    again and raises only after ``max_tries``."""
    C = C.float()
    m = C.shape[0]
    eye = torch.eye(m, dtype=C.dtype, device=C.device)
    jitter = eps_scale * (torch.trace(C) / m + 1e-30)
    for _ in range(max_tries):
        S, info = torch.linalg.cholesky_ex(C + jitter * eye)
        if int(info) == 0:
            return S
        jitter = jitter * 10
    raise torch.linalg.LinAlgError(
        f"covariance not positive-definite after jitter {jitter / 10:.3e}")


def whitened_svd(W: torch.Tensor, cov: torch.Tensor, rank: int) -> LowRankFactors:
    """Data-aware truncated SVD (SVD-LLM whitening): minimizes
    ||X W - X L R||_F for the rank budget, where cov = X^T X.  With cov =
    I this reduces to :func:`truncated_svd`."""
    W = W.float()
    S = _safe_cholesky(cov)                       # C = S S^T, S lower
    U, s, Vt = torch.linalg.svd(S.T @ W, full_matrices=False)
    Lw, R = _split(U, s, Vt, rank)
    # L = S^{-T} U_r sqrt(Sigma_r): solve S^T L = U_r * sqrt_s
    L = torch.linalg.solve_triangular(S.T, Lw, upper=True)
    return LowRankFactors(L=L, R=R)


def data_weighted_error(W: torch.Tensor, f: LowRankFactors,
                        cov: torch.Tensor) -> torch.Tensor:
    """||X W - X L R||_F^2 expressed through cov = X^T X (no data needed)."""
    D = (f.L @ f.R - W).float()
    return torch.einsum("ij,ik,kj->", D, cov.float(), D)


def frobenius_error(W: torch.Tensor, f: LowRankFactors) -> torch.Tensor:
    return ((f.reconstruct() - W.float()) ** 2).sum()


def head_columns(W: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Reshape (m, H*d_h) -> (H, m, d_h)."""
    m, n = W.shape
    return W.reshape(m, num_heads, n // num_heads).permute(1, 0, 2)


def grouped_svd(W: torch.Tensor, groups: Sequence[Sequence[int]],
                ranks: Sequence[int], num_heads: int,
                cov: torch.Tensor | None = None) -> list[LowRankFactors]:
    """Grouped low-rank decomposition (Palu G-LRD, eq. (4)): for group g
    the columns of the listed heads are concatenated and factorized to
    ``ranks[g]``; whitened when ``cov`` is given."""
    per_head = head_columns(W, num_heads)          # (H, m, d_h)
    out: list[LowRankFactors] = []
    for g, r in zip(groups, ranks, strict=True):
        Wg = torch.cat([per_head[h] for h in g], dim=1)      # (m, s*d_h)
        out.append(whitened_svd(Wg, cov, r) if cov is not None
                   else truncated_svd(Wg, r))
    return out


def stack_group_factors(factors: Sequence[LowRankFactors]):
    """Stack uniform-rank group factors: (G, m, r) and (G, r, s*d_h)."""
    ranks = {f.rank for f in factors}
    if len(ranks) != 1:
        raise ValueError(f"groups must share a rank to stack, got {sorted(ranks)}")
    return (torch.stack([f.L for f in factors]),
            torch.stack([f.R for f in factors]))


def effective_rank_for_ratio(width: int, keep_ratio: float, multiple: int = 8,
                             min_rank: int = 8) -> int:
    """Rank giving a ``keep_ratio`` cache footprint, rounded to a multiple
    of ``multiple``."""
    r = int(round(width * keep_ratio / multiple)) * multiple
    return max(min_rank, min(width, r))
