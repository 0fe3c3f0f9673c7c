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


def check_compressible(cfg: ModelConfig) -> None:
    """Refuse a model without attention layers (falcon-mamba's mixers
    cache no keys or values), with the registry's words; the JAX package
    refuses it at ``get_config(..., recalkv_ratio=...)``."""
    if not any(k in SELF_ATTN + ("cross",) for k in cfg.expanded_layers()):
        raise ValueError(f"ReCalKV inapplicable to {cfg.name}: it has no attention layer")


@torch.no_grad()
def capture_calibration(cfg: ModelConfig, params,
                        batches) -> list[P.CalibStats]:
    """Per-self-attention-layer input (post-ln1) second moments, from the
    einsum forward of the model (``want_cache=False``, as the JAX package
    runs it).  Each layer's statistics are summed as the forward reaches
    it, so no layer's activations outlive it.  ``batches`` are dicts with
    "tokens" (B, T) (numpy or torch) and, for a model with
    cross-attention layers, "source" (B, S_src, d) (encoded first for an
    encoder-decoder).  Recurrent layers pass through ``block_full``; a
    model with no attention layer raises ValueError."""
    check_supported(cfg)
    check_compressible(cfg)
    dev = params["embed"].device
    kinds = cfg.expanded_layers()
    stats: list[P.CalibStats | None] = [None] * len(attn_layer_indices(cfg))
    for batch in batches:
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        B, Tn = tokens.shape
        source = batch.get("source")
        if source is not None:
            source = T.cross_source(cfg, params, torch.as_tensor(source, device=dev)
                               .to(cfg.dtype))
        ctx = {"positions": torch.arange(Tn, device=dev).expand(B, Tn),
               "lengths": torch.full((B,), Tn, dtype=torch.int64, device=dev),
               "max_len": Tn, "source": source}
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
    (an encoder's and the recurrent mixers' among them) are shared with
    ``params``, not copied.
    Cross-attention layers go through the same pipeline on identity
    statistics (their source is the stub frontend's) at the first self
    layer's rank, or, in a model without self-attention layers, at the
    policy's rank for the group width (JAX ``compress_model``); there the
    runtime config carries that rank (the JAX package writes 0).
    ``reports``, when given, receives each layer's
    ``CompressedAttention.report`` (self layers, then cross layers)."""
    check_supported(cfg)
    if cfg.mla is not None:
        raise ValueError("MLA models already cache latents; nothing to do")
    if cfg.recalkv is not None:
        raise ValueError("the model already caches latents; compress a dense "
                         "(recalkv=None) model")
    idxs = attn_layer_indices(cfg)
    if len(stats) != len(idxs):
        raise ValueError(f"need {len(idxs)} stats, got {len(stats)}")
    cross = [i for i, k in enumerate(cfg.expanded_layers())
             if k in ("cross", "attn_cross")]
    check_compressible(cfg)
    s = recal_cfg.effective_group_size(cfg.num_kv_heads)
    ranks_k, ranks_v = P.allocate_layer_ranks(
        recal_cfg, len(idxs), s * cfg.d_head, fisher_k, fisher_v)
    layers = list(params["layers"])
    by_layer = [(0, 0)] * cfg.num_layers

    def compress(a, st, rk, rv):
        w = P.AttnWeights(W_q=a["wq"], W_k=a["wk"], W_v=a["wv"], W_o=a["wo"],
                          num_q_heads=cfg.num_heads,
                          num_kv_heads=cfg.num_kv_heads)
        ca = P.compress_attention_layer(w, st, recal_cfg, rk, rv)
        if reports is not None:
            reports.append(ca.report)
        return ca

    for j, i in enumerate(idxs):
        a = layers[i]["attn"]
        ca = compress(a, stats[j], ranks_k[j], ranks_v[j])
        layers[i] = {**layers[i], "attn": _to_latent_params(a, ca, cfg.dtype)}
        by_layer[i] = (ca.rank_k, ca.rank_v)
    rk = by_layer[idxs[0]][0] if idxs else recal_cfg.rank_for_width(s * cfg.d_head)
    for i in cross:
        a = layers[i]["cross"]
        ca = compress(a, P.CalibStats.identity(cfg.d_model, device=a["wq"].device),
                      rk, rk)
        layers[i] = {**layers[i], "cross": _to_latent_params(a, ca, cfg.dtype)}
    new_params = {**params, "layers": layers}
    r_k, r_v = (ranks_k[0], ranks_v[0]) if idxs else (rk, rk)
    new_cfg = dataclasses.replace(
        cfg, scan_layers=False,
        recalkv=ReCalKVRuntime(rank_k=r_k, rank_v=r_v,
                               group_size=s, ranks_by_layer=tuple(by_layer)))
    return new_cfg, new_params
