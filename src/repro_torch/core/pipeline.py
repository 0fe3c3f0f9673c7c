"""ReCalKV Algorithm 1 — the post-training compression pipeline (port of
``repro.core.pipeline``).

Consumes per-layer dense attention weights and calibration statistics,
produces ``CompressedAttention`` bundles that the model's latent-cache
path serves.  Per layer (paper Algorithm 1):

  Keys   : CKA(head sim) -> greedy HSR grouping -> fold the permutation
           into (W_q, W_k, W_v, W_o) -> grouped (whitened) SVD -> (L_k, R_k)
  Values : grouped SVD on the key-aligned groups -> offline ALS
           calibration -> block fusion of R_v into W_o -> (L_v, W~_o)
  Ranks  : uniform per layer.  Fisher-guided allocation needs the training
           slice (gradients of the LM loss) and raises NotImplementedError
           (ROADMAP.md, Queue 1 item 8).

Calibration statistics are second moments (cov = X^T X and the token
mean), O(d_model^2) per layer; no activations are kept.  Every product
runs in float32 with TF32 off (``full_float32``) on the weights' device.

Beyond the JAX bundle, ``CompressedAttention.report`` records what the
layer's compression decided and achieved: the HSR groups, the mean
within-group CKA of HSR's and of the identity grouping, and each value
group's data-weighted error before and after ALS.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import calibrate as _calibrate
from repro_torch.core import cka as _cka
from repro_torch.core import fusion as _fusion
from repro_torch.core import reorder as _reorder
from repro_torch.core import svd as _svd
from repro_torch.device import full_float32

FISHER_NOT_PORTED = ("Fisher-guided rank allocation needs gradients of the LM "
                     "loss, which the port gains with the training slice "
                     "(ROADMAP.md, Queue 1 item 8); use uniform ranks "
                     "(use_fisher=False)")


@dataclasses.dataclass(frozen=True)
class ReCalKVConfig:
    """Knobs for the compression pipeline.  ``keep_ratio`` is the *kept*
    fraction of KV-cache bytes (the paper's "50% compression" is 0.5)."""

    keep_ratio: float = 0.5
    group_size: int = 4
    use_hsr: bool = True            # CKA reordering for key groups
    use_calibration: bool = True    # ALS refinement of value factors
    use_whitening: bool = True      # SVD-LLM whitening before truncation
    use_fisher: bool = True         # per-layer rank allocation (with scores)
    calib_iters: int = 8
    rank_multiple: int = 8
    min_rank: int = 8
    alpha: float = 0.5
    rho_min: float = 0.0625
    rho_max: float = 1.0

    def effective_group_size(self, num_kv_heads: int) -> int:
        return max(1, min(self.group_size, num_kv_heads))

    def rank_for_width(self, width: int) -> int:
        return _svd.effective_rank_for_ratio(
            width, self.keep_ratio, self.rank_multiple, self.min_rank)


@dataclasses.dataclass(frozen=True)
class AttnWeights:
    """Dense attention weights for one layer (row-vector convention)."""

    W_q: torch.Tensor   # (d_model, H_q * d_h)
    W_k: torch.Tensor   # (d_model, H_kv * d_h)
    W_v: torch.Tensor   # (d_model, H_kv * d_h)
    W_o: torch.Tensor   # (H_q * d_h, d_model)
    num_q_heads: int
    num_kv_heads: int

    @property
    def d_head(self) -> int:
        return self.W_k.shape[1] // self.num_kv_heads


@dataclasses.dataclass(frozen=True)
class CalibStats:
    """Second-moment summary of one layer's attention input activations."""

    cov: torch.Tensor    # (d_model, d_model) = X^T X (uncentered), float32
    mean: torch.Tensor   # (d_model,)
    count: int           # tokens accumulated

    def centered_cov(self) -> torch.Tensor:
        mu = self.mean.float()
        return self.cov.float() - self.count * torch.outer(mu, mu)

    @classmethod
    def identity(cls, d_model: int, device=None) -> "CalibStats":
        return cls(cov=torch.eye(d_model, dtype=torch.float32, device=device),
                   mean=torch.zeros(d_model, dtype=torch.float32, device=device),
                   count=1)


def collect_stats(activations: torch.Tensor) -> CalibStats:
    """Summarize a (..., d_model) activation tensor."""
    X = activations.reshape(-1, activations.shape[-1]).float()
    with full_float32():
        cov = X.T @ X
    return CalibStats(cov=cov, mean=X.mean(dim=0), count=X.shape[0])


def merge_stats(a: CalibStats, b: CalibStats) -> CalibStats:
    n = a.count + b.count
    return CalibStats(cov=a.cov + b.cov,
                      mean=(a.mean * a.count + b.mean * b.count) / n, count=n)


@dataclasses.dataclass(frozen=True)
class CompressedAttention:
    """Artifacts replacing one layer's dense K/V path; the kv-head
    permutation is already folded into every weight."""

    W_q: torch.Tensor        # (d_model, H_q * d_h)   permuted query projection
    L_k: torch.Tensor        # (G, d_model, r_k)      key latent down-projection
    R_k: torch.Tensor        # (G, r_k, s * d_h)      key reconstruction factor
    L_v: torch.Tensor        # (G, d_model, r_v)      value latent down-projection
    W_o_fused: torch.Tensor  # (H_q, r_v, d_model)    R_v folded into W_o
    perm: tuple[int, ...]    # kv-head permutation that was folded in
    rank_k: int
    rank_v: int
    num_q_heads: int
    num_kv_heads: int
    group_size: int
    report: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def num_groups(self) -> int:
        return self.L_k.shape[0]

    def cache_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        return self.num_groups * (self.rank_k + self.rank_v) * dtype_bytes

    def dense_cache_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        d_h = self.W_q.shape[1] // self.num_q_heads
        return 2 * self.num_kv_heads * d_h * dtype_bytes


def compress_attention_layer(w: AttnWeights, stats: CalibStats,
                             cfg: ReCalKVConfig, rank_k: int,
                             rank_v: int) -> CompressedAttention:
    """Run HSR + OCMF on one attention layer (float32, TF32 off)."""
    with full_float32():
        return _compress_layer(w, stats, cfg, rank_k, rank_v)


def _compress_layer(w, stats, cfg, rank_k, rank_v):
    # float32 throughout (JAX promotes the model-dtype weights the same way)
    w = dataclasses.replace(w, W_q=w.W_q.float(), W_k=w.W_k.float(),
                            W_v=w.W_v.float(), W_o=w.W_o.float())
    s = cfg.effective_group_size(w.num_kv_heads)
    H_kv = w.num_kv_heads
    if H_kv % s:
        raise ValueError(f"kv heads {H_kv} not divisible by group size {s}")
    cov = stats.cov.float()
    contiguous = _reorder.identity_groups(H_kv, s)
    report: dict = {}

    # --- Keys: HSR grouping -------------------------------------------------
    if cfg.use_hsr and s > 1:
        sim = _cka.head_cka_from_cov(w.W_k, stats.centered_cov(), H_kv)
        sim = sim.double().cpu().numpy()
        groups = _reorder.greedy_group_heads(sim, s)
        report.update(
            cka_hsr=_reorder.within_group_similarity(sim, groups),
            cka_identity=_reorder.within_group_similarity(sim, contiguous))
    else:
        groups = contiguous
    report["groups"] = [list(map(int, g)) for g in groups]
    perm = _reorder.groups_to_permutation(groups)
    W_q, W_k, W_v, W_o = _fusion.fold_head_permutation(
        w.W_q, w.W_k, w.W_v, w.W_o, perm, w.num_q_heads, H_kv)

    # --- Keys: grouped (whitened) SVD ---------------------------------------
    wcov = cov if cfg.use_whitening else None
    k_factors = _svd.grouped_svd(W_k, contiguous, [rank_k] * len(contiguous),
                                 H_kv, cov=wcov)
    L_k, R_k = _svd.stack_group_factors(k_factors)

    # --- Values: grouped SVD + offline calibration --------------------------
    v_factors = _svd.grouped_svd(W_v, contiguous, [rank_v] * len(contiguous),
                                 H_kv, cov=wcov)
    if cfg.use_calibration:
        per_head = _svd.head_columns(W_v, H_kv)
        calibrated, errors = [], []
        for g, f in zip(contiguous, v_factors, strict=True):
            Wg = torch.cat([per_head[h] for h in g], dim=1)
            res = _calibrate.calibrate_factors(Wg, cov, f,
                                               num_iters=cfg.calib_iters)
            calibrated.append(res.factors)
            errors.append([res.initial_error, res.final_error])
        v_factors = calibrated
        report["value_errors"] = errors
    L_v, R_v = _svd.stack_group_factors(v_factors)

    # --- Values: fuse R_v into the output projection ------------------------
    W_o_fused = _fusion.fuse_output_projection(R_v, W_o, w.num_q_heads, H_kv)
    return CompressedAttention(
        W_q=W_q, L_k=L_k, R_k=R_k, L_v=L_v, W_o_fused=W_o_fused,
        perm=tuple(int(p) for p in perm), rank_k=int(rank_k),
        rank_v=int(rank_v), num_q_heads=w.num_q_heads, num_kv_heads=H_kv,
        group_size=s, report=report)


def allocate_layer_ranks(cfg: ReCalKVConfig, num_layers: int, group_width: int,
                         fisher_k: Sequence[float] | None = None,
                         fisher_v: Sequence[float] | None = None,
                         ) -> tuple[list[int], list[int]]:
    """Per-layer ranks for K and V (Algorithm 1 l.4-5): uniform; Fisher
    scores with ``use_fisher`` raise (not ported)."""
    if cfg.use_fisher and fisher_k is not None and fisher_v is not None:
        raise NotImplementedError(FISHER_NOT_PORTED)
    r = cfg.rank_for_width(group_width)
    return [r] * num_layers, [r] * num_layers


def compress_model_layers(layers: Sequence[AttnWeights],
                          stats: Sequence[CalibStats], cfg: ReCalKVConfig,
                          fisher_k: Sequence[float] | None = None,
                          fisher_v: Sequence[float] | None = None,
                          ) -> list[CompressedAttention]:
    """Algorithm 1 over all attention layers of a model."""
    if len(layers) != len(stats):
        raise ValueError("one CalibStats required per layer")
    if not layers:
        return []
    w0 = layers[0]
    s = cfg.effective_group_size(w0.num_kv_heads)
    ranks_k, ranks_v = allocate_layer_ranks(cfg, len(layers), s * w0.d_head,
                                            fisher_k, fisher_v)
    return [compress_attention_layer(w, st, cfg, rk, rv)
            for w, st, rk, rv in zip(layers, stats, ranks_k, ranks_v, strict=True)]

