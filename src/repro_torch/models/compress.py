"""Model-level ReCalKV compression: a dense model -> a latent-KV model
(port of ``repro.models.compress``).

The port's params are per-layer already (``weights.py``), so any config
compresses; the compressed config says ``scan_layers=False``, the unrolled
layout the artifact stores, as the JAX package requires of its input.

Flow (paper Algorithm 1, at model scope):
    stats = capture_calibration(cfg, params, batches)      # X^T X per layer
    cfg2, params2 = compress_model(cfg, params, stats, recal_cfg)

Fisher scores (``fisher_scores`` in JAX) need the training slice and are
not ported (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import pipeline as P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ReCalKVRuntime, check_supported

SELF_ATTN = ("attn", "attn_dense", "local", "attn_cross")


def attn_layer_indices(cfg: ModelConfig) -> list[int]:
    """Indices (into the layer stack) of self-attention layers."""
    return [i for i, k in enumerate(cfg.expanded_layers()) if k in SELF_ATTN]


@torch.no_grad()
def capture_calibration(cfg: ModelConfig, params,
                        batches) -> list[P.CalibStats]:
    """Per-self-attention-layer input (post-ln1) second moments, from the
    einsum forward of the model (``want_cache=False``, as the JAX package
    runs it).  Each layer's statistics are summed as the forward reaches
    it, so no layer's activations outlive it.  ``batches`` are dicts with
    "tokens" (B, T) (numpy or torch)."""
    check_supported(cfg)
    dev = params["embed"].device
    kinds = cfg.expanded_layers()
    stats: list[P.CalibStats | None] = [None] * len(attn_layer_indices(cfg))
    for batch in batches:
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        B, Tn = tokens.shape
        ctx = {"positions": torch.arange(Tn, device=dev).expand(B, Tn),
               "lengths": torch.full((B,), Tn, dtype=torch.int64, device=dev),
               "max_len": Tn}
        x = T.embed_tokens(cfg, params, tokens)
        j = 0
        for i, kind in enumerate(kinds):
            p = params["layers"][i]
            if kind in SELF_ATTN:
                new = P.collect_stats(L.rmsnorm(x, p["ln1"], cfg.norm_eps))
                stats[j] = new if stats[j] is None else P.merge_stats(stats[j], new)
                j += 1
            x, _ = T.block_full(cfg, kind, p, x, ctx, want_cache=False)
    return stats


def _to_latent_params(attn_p: dict, ca: P.CompressedAttention, dtype) -> dict:
    out = {"wq": ca.W_q.to(dtype), "l_k": ca.L_k.to(dtype), "r_k": ca.R_k.to(dtype),
           "l_v": ca.L_v.to(dtype), "wo_fused": ca.W_o_fused.to(dtype)}
    for extra in ("q_norm", "k_norm"):
        if extra in attn_p:
            out[extra] = attn_p[extra]
    return out


def compress_model(cfg: ModelConfig, params, stats: Sequence[P.CalibStats],
                   recal_cfg: P.ReCalKVConfig,
                   fisher_k: Sequence[float] | None = None,
                   fisher_v: Sequence[float] | None = None,
                   reports: list | None = None):
    """Returns (compressed_cfg, compressed_params).  Self-attention layers
    get HSR keys + OCMF values, one layer at a time (its float32 factors
    are cast to ``cfg.dtype`` before the next starts); the other leaves
    are shared with ``params``, not copied.  ``reports``, when given,
    receives each layer's ``CompressedAttention.report``."""
    check_supported(cfg)
    if cfg.mla is not None:
        raise ValueError("MLA models already cache latents; nothing to do")
    if cfg.recalkv is not None:
        raise ValueError("the model already caches latents; compress a dense "
                         "(recalkv=None) model")
    idxs = attn_layer_indices(cfg)
    if len(stats) != len(idxs):
        raise ValueError(f"need {len(idxs)} stats, got {len(stats)}")
    if not idxs:
        raise ValueError(f"{cfg.name} has no self-attention layer to compress")
    s = recal_cfg.effective_group_size(cfg.num_kv_heads)
    ranks_k, ranks_v = P.allocate_layer_ranks(
        recal_cfg, len(idxs), s * cfg.d_head, fisher_k, fisher_v)
    layers = list(params["layers"])
    by_layer = [(0, 0)] * cfg.num_layers
    for j, i in enumerate(idxs):
        a = layers[i]["attn"]
        w = P.AttnWeights(W_q=a["wq"], W_k=a["wk"], W_v=a["wv"], W_o=a["wo"],
                          num_q_heads=cfg.num_heads,
                          num_kv_heads=cfg.num_kv_heads)
        ca = P.compress_attention_layer(w, stats[j], recal_cfg, ranks_k[j],
                                        ranks_v[j])
        layers[i] = {**layers[i], "attn": _to_latent_params(a, ca, cfg.dtype)}
        by_layer[i] = (ca.rank_k, ca.rank_v)
        if reports is not None:
            reports.append(ca.report)
    new_params = {**params, "layers": layers}
    new_cfg = dataclasses.replace(
        cfg, scan_layers=False,
        recalkv=ReCalKVRuntime(rank_k=ranks_k[0], rank_v=ranks_v[0],
                               group_size=s, ranks_by_layer=tuple(by_layer)))
    return new_cfg, new_params
