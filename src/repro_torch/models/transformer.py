"""Transformer stack: prefill / decode / speculative verify (port of the
serving half of ``repro.models.transformer``), over a dense, a latent or
an MLA KV cache.

The JAX package scans over stacked layer params; here ``run_stack`` is a
Python loop over ``params["layers"]`` (see :mod:`.weights` for the layout)
and caches are a list with one ``{"self": {...}}`` dict per layer.  With
``pages = (ptab, page_size)`` the caches are page-major pools read and
written through the page table (see :mod:`.kv_cache`).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.stage_install import InstallTable, stage_install_rows
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported

Params = dict[str, Any]


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind in ("attn", "attn_dense") and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _ffn(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's FFN on its residual: dense on ``attn_dense`` blocks."""
    return x + L.ffn(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg,
                     dense=kind == "attn_dense")


def block_full(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
               ctx: dict, want_cache: bool = True):
    """One self-attention block over a full (B, T, d) sequence.  Returns
    (x, cache) with the block's freshly written ring cache — dense, latent
    or MLA — or (x, None) without ``want_cache``: the calibration forward,
    which keeps the einsum path under the kernel backend, as the JAX
    package does."""
    window = cfg.window_for(kind)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        y, (ckv, krope) = L.mla_attention(p["attn"], h, cfg, ctx["positions"])
        values = {"ckv": ckv, "krope": krope}
    else:
        attn = (L.self_attention_dense if cfg.recalkv is None
                else L.self_attention_latent)
        y, (a, b) = attn(p["attn"], h, cfg, ctx["positions"], window,
                         theta=_theta(cfg, kind), use_kernel=want_cache)
        values = ({"k": a, "v": b} if cfg.recalkv is None
                  else KC.latent_cache_entry(cfg, a, b))
    x = _ffn(cfg, kind, p, x + y)
    if not want_cache:
        return x, None
    return x, {"self": _prefill_self_cache(cfg, kind, ctx, values)}


def _prefill_self_cache(cfg: ModelConfig, kind: str, ctx: dict,
                        values: Params) -> Params:
    """Scatter full-sequence K/V (or latents) into a fresh ring cache
    (shapes come from the values, so per-layer ranks need no config
    plumbing)."""
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
    """One self-attention block for a (B, 1, d) decode step.  Returns
    (x, deferred updates) — written by ``kv_cache.apply_decode_writes``
    after the layer loop."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        y, sc = KC.decode_attn_mla(p["attn"], h, cache["self"], cfg, ctx["cur"],
                                   pages=ctx.get("pages"))
    else:
        reader = (KC.decode_attn_dense if cfg.recalkv is None
                  else KC.decode_attn_latent)
        y, sc = reader(p["attn"], h, cache["self"], cfg, ctx["cur"],
                       cfg.window_for(kind), theta=_theta(cfg, kind),
                       pages=ctx.get("pages"))
    return _ffn(cfg, kind, p, x + y), {"self": sc}


def block_verify(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 cache: Params, ctx: dict):
    """One self-attention block for a (B, S, d) verify step over S fed
    tokens at positions cur..cur+S-1.  Returns (x, deferred (B, S, ...)
    entries) — the caller commits only the accepted prefix
    (``kv_cache.apply_verify_writes``)."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        y, sc = KC.verify_attn_mla(p["attn"], h, cache["self"], cfg, ctx["cur"],
                                   ctx["feed_mask"], pages=ctx.get("pages"))
    else:
        reader = (KC.verify_attn_dense if cfg.recalkv is None
                  else KC.verify_attn_latent)
        y, sc = reader(p["attn"], h, cache["self"], cfg, ctx["cur"],
                       ctx["feed_mask"], cfg.window_for(kind),
                       theta=_theta(cfg, kind), pages=ctx.get("pages"))
    return _ffn(cfg, kind, p, x + y), {"self": sc}


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
                      device=None, pages: tuple[int, int] | None = None) -> list:
    """Empty caches, one dict per layer, on ``device`` (default cuda):
    rings (batch, max_len, ...), or with ``pages`` = (n_pages, page_size)
    page-major pools (n_pages, page_size, ...) shared by all slots through
    a page table (page 0 is the null page: pos -1, never written)."""
    check_supported(cfg)
    dev = resolve_device(device)
    b, ml = (batch, max_len) if pages is None else pages
    return [KC.init_block_cache(cfg, k, b, ml, dev, layer_idx=i)
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
                active: torch.Tensor | None = None, pages=None):
    """One decode step.  tokens (B,), cur (B,) absolute positions;
    ``active`` (B,) bool masks cache writes for idle rows; ``pages`` =
    (ptab (B, n_sp) int32, page_size) reads and writes page-major pools.
    The caches are updated in place after the layer loop.  Returns
    (logits (B, V), caches)."""
    x = embed_tokens(cfg, params, tokens[:, None])
    ctx = {"cur": cur, "pages": pages}
    x, updates = run_stack(cfg, params, x, ctx, caches, decode=True)
    KC.apply_decode_writes(caches, updates, cur, active, pages=pages)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(cfg, params, x)[:, 0], caches


def verify_step(cfg: ModelConfig, params: Params, caches: list,
                tokens: torch.Tensor, cur: torch.Tensor,
                feed_mask: torch.Tensor, pages=None):
    """Speculative-decoding target pass: logits for S fed tokens in one
    pass.  tokens (B, S) — column 0 is the slot's next sequential feed,
    columns 1.. are draft proposals (-1 pads embed as token 0); cur (B,)
    the position of column 0; feed_mask (B, S) marks candidate columns;
    ``pages`` as for :func:`decode_step`.  Cache writes are NOT applied:
    the deferred (B, S, ...) updates are returned for
    :func:`commit_verify_writes`.  Returns (logits (B, S, V) float32,
    updates)."""
    x = embed_tokens(cfg, params, tokens.clamp(min=0))
    ctx = {"cur": cur, "feed_mask": feed_mask, "pages": pages}
    x, updates = run_stack(cfg, params, x, ctx, caches, verify=True)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(cfg, params, x), updates


def commit_verify_writes(caches: list, updates: list, cur: torch.Tensor,
                         mask: torch.Tensor, pages=None) -> list:
    """Write a verify step's deferred entries for the accepted prefix
    (``mask`` (B, S) bool), in place."""
    return KC.apply_verify_writes(caches, updates, cur, mask, pages=pages)


def _self_leaves(caches: list) -> list:
    return [leaf for c in caches for leaf in c["self"].values()]


def install_table(caches: list, stage: list):
    """The table :func:`swap_cache_slot`'s kernel reads on a card, built
    once over a ring and its stage cache (``None`` on the CPU, where the
    plain version runs).  The caller holds it as long as both caches and
    any graph captured over them live."""
    if not caches[0]["self"]["pos"].is_cuda:
        return None
    return InstallTable(_self_leaves(caches), _self_leaves(stage))


def swap_cache_slot(caches: list, stage: list, slot: torch.Tensor,
                    q: torch.Tensor, table=None) -> list:
    """Install row ``q`` of a stage cache (the same layers and leaves as the
    ring, see :func:`init_decode_cache`) into serving slot ``slot`` of the
    ring, in place: continuous batching's mid-window install.  ``slot`` /
    ``q`` are 0-d int64 device tensors; a ``slot`` outside the batch
    copies nothing (JAX's ``mode="drop"``), which is how the window says
    "no install this iteration" without a branch.  On a card ``table`` is
    :func:`install_table` of these two caches.  Ring layout only: a
    paged install copies the page-table row alone (the staged pages were
    scattered into the pool at stage time)."""
    stage_install_rows(_self_leaves(caches), _self_leaves(stage), slot, q, table)
    return caches


def wipe_pages(caches: list, pages: torch.Tensor) -> list:
    """Reset the ``pos`` of physical ``pages`` (1-D) of page-major pools
    to -1 (empty), in place.  Positions are the pool's only validity
    mark: a recycled page keeps its last holder's positions, which a new
    holder's mask would read as valid, so every page mapped without a
    prefill scatter over it is wiped first.  Content leaves stay: latents
    under pos = -1 are never read.  The null page 0 may appear (its pos
    is -1 already)."""
    for cache in caches:
        # a fill, not ``pos[pages] = -1``: assigning a Python scalar through
        # an index copies it from the host and waits for the device
        cache["self"]["pos"].index_fill_(0, pages.long(), -1)
    return caches


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
