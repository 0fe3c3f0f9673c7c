"""Fisher-information-guided compression-ratio allocation (Palu-style)
(port of ``repro.core.fisher``).

The paper (§3.4, Algorithm 1 lines 4-5) follows Palu: estimate the
empirical Fisher information of each K/V projection layer from
calibration gradients,

    F(W) = sum_i  (dL/dW)_i^2        (diagonal empirical Fisher, summed)

and allocate *more rank* (a gentler compression ratio) to layers with a
higher Fisher score, subject to a global cache budget.

Allocation is a water-filling problem: find per-layer keep-ratios rho_l in
[rho_min, rho_max] proportional to the normalized importance w_l = F_l^alpha
such that sum_l rho_l * n_l = target_ratio * sum_l n_l.  It is solved with
a scale + clip + redistribute loop in numpy float64 (the JAX package's
arithmetic, copied), then each rank is rounded to a multiple of 8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.models.weights import leaves_in_jax_order, map_tree


@dataclasses.dataclass(frozen=True)
class RankAllocation:
    """Per-layer keep-ratios and ranks for one projection kind (K or V)."""

    ratios: tuple[float, ...]          # per-layer keep ratio in (0, 1]
    ranks: tuple[int, ...]             # per-group rank, rounded
    fisher: tuple[float, ...]          # the scores that produced them

    def mean_ratio(self) -> float:
        return float(np.mean(self.ratios))


def empirical_fisher(loss_fn: Callable[..., torch.Tensor], params, batches: Sequence):
    """Diagonal empirical Fisher of ``params`` (a nest of dicts / sequences
    of tensors) under ``loss_fn(params, batch) -> scalar``: a tree of
    float32 summed squared gradients over ``batches``."""
    leaves = [t for _, ts, _ in leaves_in_jax_order(None, params) for t in ts]
    fisher = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    try:
        for batch in batches:
            gs = torch.autograd.grad(loss_fn(params, batch), leaves, allow_unused=True)
            for f, g in zip(fisher, gs, strict=True):
                if g is not None:
                    f.add_(g.float() ** 2)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    by_id = {id(t): f for t, f in zip(leaves, fisher, strict=True)}
    return map_tree(params, lambda t: by_id[id(t)])


def layer_scores(fisher_tree: Mapping[str, torch.Tensor]) -> dict[str, float]:
    """Collapse each layer's Fisher tensor to a scalar importance score."""
    return {k: float(torch.sum(v)) for k, v in fisher_tree.items()}


def allocate_ratios(scores: Sequence[float], target_ratio: float, *,
                    alpha: float = 0.5, rho_min: float = 0.0625,
                    rho_max: float = 1.0, max_iters: int = 64) -> list[float]:
    """Water-filling: keep-ratios proportional to scores^alpha, meeting the
    global budget exactly (up to clipping feasibility).  ``target_ratio``
    is the *kept* fraction of the cache (1 - compression)."""
    n = len(scores)
    if n == 0:
        return []
    if not (0.0 < target_ratio <= 1.0):
        raise ValueError(f"target_ratio must be in (0, 1], got {target_ratio}")
    s = np.asarray(scores, dtype=np.float64)
    s = np.maximum(s, 1e-30) ** alpha
    w = s / s.mean()
    if not (rho_min <= target_ratio <= rho_max):
        # Budget outside the clip box: everything saturates.
        return np.full(n, np.clip(target_ratio, rho_min, rho_max)).tolist()
    rho = np.clip(target_ratio * w, rho_min, rho_max)
    for _ in range(max_iters):
        deficit = target_ratio * n - rho.sum()
        if abs(deficit) < 1e-9 * n:
            break
        free = (rho > rho_min + 1e-12) if deficit < 0 else (rho < rho_max - 1e-12)
        if not free.any():
            break
        rho[free] += deficit / free.sum()
        rho = np.clip(rho, rho_min, rho_max)
    return rho.tolist()


def ratios_to_ranks(ratios: Sequence[float], group_width: int, *,
                    multiple: int = 8, min_rank: int = 8) -> list[int]:
    """Convert keep-ratios to per-group ranks rounded to ``multiple``."""
    ranks = []
    for rho in ratios:
        r = int(round(group_width * rho / multiple)) * multiple
        ranks.append(max(min_rank, min(group_width, r)))
    return ranks


def allocate(scores: Sequence[float], target_ratio: float, group_width: int,
             **kwargs) -> RankAllocation:
    """Scores -> ratios -> rounded ranks, re-deriving the achieved ratios."""
    ratios = allocate_ratios(scores, target_ratio, **{
        k: v for k, v in kwargs.items() if k in ("alpha", "rho_min", "rho_max")})
    ranks = ratios_to_ranks(ratios, group_width, multiple=kwargs.get("multiple", 8),
                            min_rank=kwargs.get("min_rank", 8))
    return RankAllocation(ratios=tuple(r / group_width for r in ranks),
                          ranks=tuple(ranks),
                          fisher=tuple(float(x) for x in scores))
