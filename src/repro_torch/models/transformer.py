"""Transformer stack: prefill / decode / speculative verify (port of the
serving half of ``repro.models.transformer``).

The JAX package scans over stacked layer params; here ``run_stack`` is a
Python loop over ``params["layers"]`` (see :mod:`.weights` for the layout)
and caches are a list with one ``{"self": {...}}`` dict per layer.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported

Params = dict[str, Any]


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind in ("attn", "attn_dense") and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def block_full(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
               ctx: dict):
    """One ``attn`` block over a full (B, T, d) sequence.  Returns (x, cache)
    with the block's freshly written ring cache."""
    window = cfg.window_for(kind)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, (zk, zv) = L.self_attention_latent(p["attn"], h, cfg, ctx["positions"],
                                          window, theta=_theta(cfg, kind))
    x = x + y
    x = x + L.swiglu(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, {"self": _prefill_self_cache(
        cfg, kind, ctx, KC.latent_cache_entry(cfg, zk, zv))}


def _prefill_self_cache(cfg: ModelConfig, kind: str, ctx: dict,
                        values: Params) -> Params:
    """Scatter full-sequence latents into a fresh ring cache (shapes come
    from the values, so per-layer ranks need no config plumbing)."""
    B, T = ctx["positions"].shape
    Lr = cfg.cache_len(kind, ctx["max_len"])
    out = {}
    for name, val in values.items():
        empty = torch.zeros((B, Lr) + tuple(val.shape[2:]), dtype=val.dtype,
                            device=val.device)
        out[name] = KC.write_prefill(empty, val, ctx["lengths"])
    out["pos"] = KC.prefill_pos(ctx["lengths"], T, Lr)
    return out


def block_decode(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 cache: Params, ctx: dict):
    """One ``attn`` block for a (B, 1, d) decode step.  Returns
    (x, deferred updates) — written by ``kv_cache.apply_decode_writes``
    after the layer loop."""
    window = cfg.window_for(kind)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, sc = KC.decode_attn_latent(p["attn"], h, cache["self"], cfg, ctx["cur"],
                                  window, theta=_theta(cfg, kind))
    x = x + y
    x = x + L.swiglu(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, {"self": sc}


def block_verify(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 cache: Params, ctx: dict):
    """One ``attn`` block for a (B, S, d) verify step over S fed tokens at
    positions cur..cur+S-1.  Returns (x, deferred (B, S, ...) entries) —
    the caller commits only the accepted prefix
    (``kv_cache.apply_verify_writes``)."""
    window = cfg.window_for(kind)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, sc = KC.verify_attn_latent(p["attn"], h, cache["self"], cfg, ctx["cur"],
                                  ctx["feed_mask"], window,
                                  theta=_theta(cfg, kind))
    x = x + y
    x = x + L.swiglu(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, {"self": sc}


def run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, ctx: dict,
              caches: list | None = None, *, decode: bool = False,
              verify: bool = False):
    """Apply every layer in order.  Prefill returns (x, new caches); decode
    and verify return (x, deferred updates)."""
    outs = []
    for i, kind in enumerate(cfg.expanded_layers()):
        p = params["layers"][i]
        if verify:
            x, o = block_verify(cfg, kind, p, x, caches[i], ctx)
        elif decode:
            x, o = block_decode(cfg, kind, p, x, caches[i], ctx)
        else:
            x, o = block_full(cfg, kind, p, x, ctx)
        outs.append(o)
    return x, outs


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def logits_for(cfg: ModelConfig, params: Params,
               hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (hidden @ w).float()


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> list:
    """Empty ring caches, one dict per layer, on ``device`` (default cuda)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [KC.init_block_cache(cfg, k, batch, max_len, dev, layer_idx=i)
            for i, k in enumerate(cfg.expanded_layers())]


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            lengths: torch.Tensor, max_len: int):
    """Aligned right-padded prefill.  tokens (B, T); lengths (B,).
    Returns (last-token logits (B, V) float32, caches)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    ctx = {"positions": positions, "lengths": lengths.to(torch.int64),
           "max_len": max_len}
    x = embed_tokens(cfg, params, tokens)
    x, caches = run_stack(cfg, params, x, ctx)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    idx = (lengths.to(torch.int64) - 1).clamp(min=0)
    last = x[torch.arange(B, device=x.device), idx]
    return logits_for(cfg, params, last[:, None, :])[:, 0], caches


def decode_step(cfg: ModelConfig, params: Params, caches: list,
                tokens: torch.Tensor, cur: torch.Tensor,
                active: torch.Tensor | None = None):
    """One decode step.  tokens (B,), cur (B,) absolute positions;
    ``active`` (B,) bool masks cache writes for idle rows.  The rings are
    updated in place after the layer loop.  Returns (logits (B, V), caches)."""
    x = embed_tokens(cfg, params, tokens[:, None])
    x, updates = run_stack(cfg, params, x, {"cur": cur}, caches, decode=True)
    KC.apply_decode_writes(caches, updates, cur, active)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(cfg, params, x)[:, 0], caches


def verify_step(cfg: ModelConfig, params: Params, caches: list,
                tokens: torch.Tensor, cur: torch.Tensor,
                feed_mask: torch.Tensor):
    """Speculative-decoding target pass: logits for S fed tokens in one
    pass.  tokens (B, S) — column 0 is the slot's next sequential feed,
    columns 1.. are draft proposals (-1 pads embed as token 0); cur (B,)
    the position of column 0; feed_mask (B, S) marks candidate columns.
    Cache writes are NOT applied: the deferred (B, S, ...) updates are
    returned for :func:`commit_verify_writes`.  Returns
    (logits (B, S, V) float32, updates)."""
    x = embed_tokens(cfg, params, tokens.clamp(min=0))
    ctx = {"cur": cur, "feed_mask": feed_mask}
    x, updates = run_stack(cfg, params, x, ctx, caches, verify=True)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(cfg, params, x), updates


def commit_verify_writes(caches: list, updates: list, cur: torch.Tensor,
                         mask: torch.Tensor) -> list:
    """Write a verify step's deferred entries for the accepted prefix
    (``mask`` (B, S) bool), in place."""
    return KC.apply_verify_writes(caches, updates, cur, mask)


def decode_loop(cfg: ModelConfig, params: Params, caches: list,
                tokens: torch.Tensor, cur: torch.Tensor, steps: int, *,
                active: torch.Tensor | None = None,
                sample_fn: Callable | None = None):
    """``steps`` iterations of step -> pick -> feed, the token staying on
    the device (no host round trip per token).  ``sample_fn(logits) ->
    (B,) int64`` picks the next token (greedy argmax when None).
    Returns (caches, last tokens, cur, out_tokens (B, steps))."""
    toks = []
    for _ in range(steps):
        logits, caches = decode_step(cfg, params, caches, tokens, cur, active)
        tokens = (logits.argmax(dim=-1) if sample_fn is None
                  else sample_fn(logits))
        cur = cur + (1 if active is None else active.to(cur.dtype))
        toks.append(tokens)
    return caches, tokens, cur, torch.stack(toks, dim=1)
