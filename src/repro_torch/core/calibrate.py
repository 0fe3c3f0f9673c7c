"""Offline Calibration (OCMF, first half) -- alternating closed-form
updates (port of ``repro.core.calibrate``).

Minimizes the *data-weighted* approximation error (paper eq. (6))

    E(L, R) = || X L R - X W ||_F^2,        C := X^T X

by alternating the two normal-equation solutions (eqs. (7)-(8), in the
row-vector convention):

    R <- (L^T C L + lam I)^{-1} L^T C W        (data-weighted)
    L <- W R^T (R R^T + lam I)^{-1}            (C cancels exactly)

Each step is the exact minimizer in one factor, so E does not rise but
for rounding.  A tiny ridge keeps the solves well-posed when the
covariance is rank-deficient.  An orthogonal ambiguity (R <- Q^T R,
L <- L Q) passes through unchanged, so the factors agree with the JAX
package's only through their product.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.svd import LowRankFactors


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    factors: LowRankFactors
    initial_error: float
    final_error: float
    errors: tuple[float, ...]  # per-iteration trace


def _ridge(mat: torch.Tensor, lam_scale: float) -> torch.Tensor:
    k = mat.shape[0]
    lam = lam_scale * (torch.trace(mat) / k + 1e-30)
    return mat + lam * torch.eye(k, dtype=mat.dtype, device=mat.device)


def weighted_error(W: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                   C: torch.Tensor) -> torch.Tensor:
    D = (L @ R - W).float()
    return torch.einsum("ij,ik,kj->", D, C.float(), D)


def calibrate_factors(W: torch.Tensor, cov: torch.Tensor, init: LowRankFactors,
                      num_iters: int = 8,
                      lam_scale: float = 1e-6) -> CalibrationResult:
    """Alternating least-squares refinement of (L, R) against cov = X^T X."""
    W, C = W.float(), cov.float()
    L, R = init.L.float(), init.R.float()
    trace = [weighted_error(W, L, R, C).item()]
    CW = C @ W
    for _ in range(num_iters):
        R = torch.linalg.solve(_ridge(L.T @ C @ L, lam_scale), L.T @ CW)
        L = torch.linalg.solve(_ridge(R @ R.T, lam_scale), R @ W.T).T
        trace.append(weighted_error(W, L, R, C).item())
    return CalibrationResult(factors=LowRankFactors(L=L, R=R),
                             initial_error=trace[0], final_error=trace[-1],
                             errors=tuple(trace))
