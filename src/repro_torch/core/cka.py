"""Centered Kernel Alignment between attention-head representations (port
of ``repro.core.cka``).

The feature-space form of *linear* CKA (Kornblith et al., 2019):

    CKA(X, Y) = ||Yc^T Xc||_F^2 / (||Xc^T Xc||_F ||Yc^T Yc||_F)

identical to the Gram/HSIC formulation in the paper (eqs. (2)-(3)) but
without N x N Gram matrices for N calibration tokens.
"""

from __future__ import annotations

import torch


def linear_cka(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """CKA between two representation matrices (N, d1), (N, d2)."""
    Xc = X.float() - X.float().mean(dim=0, keepdim=True)
    Yc = Y.float() - Y.float().mean(dim=0, keepdim=True)
    hsic_xy = ((Yc.T @ Xc) ** 2).sum()
    hsic_xx = torch.sqrt(((Xc.T @ Xc) ** 2).sum())
    hsic_yy = torch.sqrt(((Yc.T @ Yc) ** 2).sum())
    return hsic_xy / (hsic_xx * hsic_yy + 1e-12)


def _normalise(cross: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(torch.diagonal(cross))
    return cross / (norms[:, None] * norms[None, :] + 1e-12)


def head_cka_from_cov(W: torch.Tensor, cov_centered: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """Pairwise head CKA from the *centered input covariance* only: for
    per-head key features ``Z_h = Xc @ W_h`` the cross term is
    ``||W_i^T C W_j||_F^2`` with ``C = Xc^T Xc``.

    W: (d_model, H * d_h) key projection; cov_centered: (d_model, d_model).
    Returns the symmetric (H, H) CKA matrix with unit diagonal."""
    C = cov_centered.float()
    m, n = W.shape
    Wh = W.float().reshape(m, num_heads, n // num_heads).permute(1, 0, 2)
    CW = torch.einsum("mk,hkd->hmd", C, Wh)          # C @ W_h
    G = torch.einsum("imd,jme->ijde", Wh, CW)        # W_i^T C W_j
    return _normalise((G ** 2).sum(dim=(2, 3)))


def head_cka_matrix(head_reps: torch.Tensor) -> torch.Tensor:
    """Pairwise CKA similarity matrix (eq. (5)) of (H, N, d_h) per-head
    key representations on calibration tokens."""
    Z = head_reps.float()
    Z = Z - Z.mean(dim=1, keepdim=True)
    G = torch.einsum("ind,jne->ijde", Z, Z)
    return _normalise((G ** 2).sum(dim=(2, 3)))
