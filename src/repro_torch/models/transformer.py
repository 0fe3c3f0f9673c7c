"""Transformer stack: prefill / decode / speculative verify (port of the
serving half of ``repro.models.transformer``), over a dense, a latent or
an MLA KV cache, and the recurrent state of the Mamba and RG-LRU mixers.

The JAX package scans over stacked layer params; here ``run_stack`` is a
Python loop over ``params["layers"]`` (see :mod:`.weights` for the layout)
and caches are a list with one ``{"self": {...}}`` dict per layer (a
``cross`` layer holds ``{"cross": {...}}`` instead, an ``attn_cross``
layer both, a ``mamba`` or ``rglru`` layer ``{"state": {"h", "conv"}}``).
With ``pages = (ptab, page_size)`` the caches are page-major pools read
and written through the page table (see :mod:`.kv_cache`).

Cross-attention layers read a ``source`` (B, S_src, d): the stub
frontend's embeddings, run through :func:`encode` first when the model is
an encoder-decoder.  Prefill writes the source's keys and values (or
latents) into the layer's cross cache, which decode and verify read and
never write.

On a mesh (``ctx["mesh"]``, see ``launch.mesh``) the decode and verify
steps take this rank's cache shards and its slot rows: the attention
readers, kernel or einsum, self or cross, score their sequence slice and
merge (``kernels.ops``), a recurrent block reads its state gathered over
"model", the writes land where the column (or channel) lives
(``kv_cache``); a layer whose self ring or pool the rules keep whole
over "model" reads it whole on every rank (``ctx["self_mesh"]``, the
mesh's view for that layer, ``launch.mesh.Mesh.layer``), and, with more than
one "data" rank, an MoE FFN runs on every data rank's tokens, gathered,
so its expert capacity and drops are the single-device ones.  Params
read through ``sharding.place.MeshParams`` arrive gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.stage_install import InstallTable, stage_install_rows
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models.config import RECURRENT_KINDS, ModelConfig, check_supported

Params = dict[str, Any]


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind in ("attn", "attn_dense") and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _ffn(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
         with_aux: bool = False, mesh=None):
    """The block's FFN on its residual: dense on ``attn_dense``, the
    cross-attention kinds and ``rglru``.  Returns (x, the MoE's aux loss
    term with ``with_aux``, else None).  With a ``mesh`` of more than one
    "data" rank an MoE FFN runs on the gathered slot rows of every data
    rank and keeps its own (under autograd the gather's backward sums the
    rows' gradient over "data": the training forward on a mesh)."""
    dense = kind in ("attn_dense", "cross", "attn_cross", "rglru")
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    split = (mesh is not None and mesh.axis_size("data") > 1
             and cfg.moe is not None and not dense)
    if split:
        b = h.shape[0]
        h = (mesh.all_gather_grad(h, "data") if torch.is_grad_enabled()
             else mesh.all_gather(h, "data"))
    y, aux = L.ffn(p["mlp"], h, cfg, dense=dense, with_aux=with_aux)
    if split:
        y = y[mesh.axis_index("data") * b:(mesh.axis_index("data") + 1) * b]
    return x + y, aux


def _mixer_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 state: Params | None):
    """A recurrent block over (B, T, d) from ``state`` (None: zeros):
    Mamba alone, or RG-LRU then the dense FFN.  Returns (x, new state).
    Prefill runs it over the whole right-padded bucket, as the JAX
    package does, so the state a prefill leaves is the state after the
    pad tokens."""
    if kind == "mamba":
        y, new = L.mamba_mixer(p["mixer"], L.rmsnorm(x, p["ln"], cfg.norm_eps), cfg, state)
        return x + y, new
    y, new = L.rglru_mixer(p["mixer"], L.rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, state)
    return _ffn(cfg, kind, p, x + y)[0], new


def _cross_full(cfg: ModelConfig, p: Params, h: torch.Tensor, ctx: dict):
    """A cross half over a full sequence: (y, the layer's cross cache
    leaves) from the source's keys and values (dense) or latents."""
    source = ctx.get("source")
    if source is None:
        raise ValueError(f"{cfg.name}: cross-attention layers need a source "
                         f"(B, {cfg.cross_source_len}, {cfg.d_model})")
    if cfg.recalkv is None:
        k, v = L.make_cross_source_dense(p, source, cfg)
        return L.cross_attention_dense(p, h, (k, v), cfg), {"k": k, "v": v}
    zk, zv = L.make_cross_source_latent(p, source, cfg)
    return L.cross_attention_latent(p, h, (zk, zv), cfg), {"zk": zk, "zv": zv}


def _cross_step(cfg: ModelConfig, p: Params, h: torch.Tensor,
                cache: Params, mesh=None) -> torch.Tensor:
    """A cross half of a decode or verify step, over the static cache."""
    reader = (KC.decode_cross_dense if cfg.recalkv is None
              else KC.decode_cross_latent)
    return reader(p, h, cache, cfg, mesh=mesh)


def _cross_residual(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                    cache: Params, mesh=None) -> torch.Tensor:
    """An ``attn_cross`` block's cross half on the residual of a decode or
    verify step (the other kinds pass ``x`` through)."""
    if kind != "attn_cross":
        return x
    return x + _cross_step(cfg, p["cross"], L.rmsnorm(x, p["lnx"], cfg.norm_eps),
                           cache["cross"], mesh)


def block_full(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
               ctx: dict, want_cache: bool = True, with_aux: bool = False):
    """One block over a full (B, T, d) sequence.  Returns (x, cache, aux)
    with the block's freshly written caches — its ring (dense, latent or
    MLA) and, for a cross-attention kind, its cross cache — or (x, None,
    aux) without ``want_cache``: the calibration and training forwards and
    the encoder, which keep the einsum path under the kernel backend, as
    the JAX package does.  ``aux`` is an MoE block's load-balance and
    z-loss term with ``with_aux`` (the training forward), else None.
    ``ctx["causal"]`` False (the encoder) lets a dense block attend every
    position.  A recurrent block's cache is its state after the last
    (padded) position."""
    if kind in RECURRENT_KINDS:
        x, state = _mixer_block(cfg, kind, p, x, None)
        return x, ({"state": state} if want_cache else None), None
    if kind == "cross":
        y, cross = _cross_full(cfg, p["cross"], L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                               ctx)
        x, _ = _ffn(cfg, kind, p, x + y)
        return x, ({"cross": cross} if want_cache else None), None
    window = cfg.window_for(kind)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        y, (ckv, krope) = L.mla_attention(p["attn"], h, cfg, ctx["positions"])
        values = {"ckv": ckv, "krope": krope}
    elif cfg.recalkv is None:
        y, (a, b) = L.self_attention_dense(
            p["attn"], h, cfg, ctx["positions"], window, theta=_theta(cfg, kind),
            causal=ctx.get("causal", True), use_kernel=want_cache)
        values = {"k": a, "v": b}
    else:
        y, (a, b) = L.self_attention_latent(p["attn"], h, cfg, ctx["positions"],
                                            window, theta=_theta(cfg, kind),
                                            use_kernel=want_cache)
        values = KC.latent_cache_entry(cfg, a, b)
    x = x + y
    cross = None
    if kind == "attn_cross":
        y, cross = _cross_full(cfg, p["cross"],
                               L.rmsnorm(x, p["lnx"], cfg.norm_eps), ctx)
        x = x + y
    x, aux = _ffn(cfg, kind, p, x, with_aux, mesh=ctx.get("mesh"))
    if not want_cache:
        return x, None, aux
    cache = {"self": _prefill_self_cache(cfg, kind, ctx, values)}
    if cross is not None:
        cache["cross"] = cross
    return x, cache, aux


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
    """One block for a (B, 1, d) decode step.  Returns (x, deferred
    updates) — written by ``kv_cache.apply_decode_writes`` after the layer
    loop; a cross half reads its static cache and defers nothing; a
    recurrent block defers its whole new state (on a mesh it reads its
    state gathered over "model", ``kv_cache.read_state``)."""
    mesh = ctx.get("mesh")
    if kind in RECURRENT_KINDS:
        x, state = _mixer_block(cfg, kind, p, x,
                                KC.read_state(cfg, kind, cache["state"], mesh))
        return x, {"state": state}
    if kind == "cross":
        y = _cross_step(cfg, p["cross"], L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                        cache["cross"], mesh)
        return _ffn(cfg, kind, p, x + y)[0], {}
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    smesh = ctx.get("self_mesh", mesh)
    if cfg.mla is not None:
        y, sc = KC.decode_attn_mla(p["attn"], h, cache["self"], cfg, ctx["cur"],
                                   pages=ctx.get("pages"), mesh=smesh)
    else:
        reader = (KC.decode_attn_dense if cfg.recalkv is None
                  else KC.decode_attn_latent)
        y, sc = reader(p["attn"], h, cache["self"], cfg, ctx["cur"],
                       cfg.window_for(kind), theta=_theta(cfg, kind),
                       pages=ctx.get("pages"), mesh=smesh)
    x, _ = _ffn(cfg, kind, p, _cross_residual(cfg, kind, p, x + y, cache, mesh),
                mesh=mesh)
    return x, {"self": sc}


def block_verify(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 cache: Params, ctx: dict):
    """One block for a (B, S, d) verify step over S fed tokens at
    positions cur..cur+S-1.  Returns (x, deferred (B, S, ...) entries) —
    the caller commits only the accepted prefix
    (``kv_cache.apply_verify_writes``); a cross half reads its static
    cache with the S tokens as queries.  Recurrent blocks raise: their
    state is not position-addressed, so a rejected token could not be
    rolled back by masking its write."""
    if kind in RECURRENT_KINDS:
        raise NotImplementedError(
            f"speculative verify is unsupported for recurrent {kind!r} blocks")
    mesh = ctx.get("mesh")
    if kind == "cross":
        y = _cross_step(cfg, p["cross"], L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                        cache["cross"], mesh)
        return _ffn(cfg, kind, p, x + y)[0], {}
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    smesh = ctx.get("self_mesh", mesh)
    if cfg.mla is not None:
        y, sc = KC.verify_attn_mla(p["attn"], h, cache["self"], cfg, ctx["cur"],
                                   ctx["feed_mask"], pages=ctx.get("pages"), mesh=smesh)
    else:
        reader = (KC.verify_attn_dense if cfg.recalkv is None
                  else KC.verify_attn_latent)
        y, sc = reader(p["attn"], h, cache["self"], cfg, ctx["cur"],
                       ctx["feed_mask"], cfg.window_for(kind),
                       theta=_theta(cfg, kind), pages=ctx.get("pages"),
                       mesh=smesh)
    x, _ = _ffn(cfg, kind, p, _cross_residual(cfg, kind, p, x + y, cache, mesh),
                mesh=mesh)
    return x, {"self": sc}


def run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, ctx: dict,
              caches: list | None = None, *, decode: bool = False,
              verify: bool = False, want_cache: bool = True):
    """Apply every layer in order.  Prefill returns (x, new caches);
    decode and verify return (x, deferred updates); the full pass without
    ``want_cache`` (the training forward) returns (x, aux), the float32
    sum of the MoE blocks' loss terms in layer order.  There, with
    ``cfg.remat`` while autograd records, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, not kept (JAX's ``jax.checkpoint``
    of the scanned body); the numbers are the same."""
    if not (want_cache or decode or verify):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for kind, p in zip(cfg.expanded_layers(), params["layers"], strict=True):
            def one(x, kind=kind, p=p):
                y, _, a = block_full(cfg, kind, p, x, ctx, want_cache=False,
                                     with_aux=True)
                return y, a
            x, a = (torch.utils.checkpoint.checkpoint(one, x, use_reentrant=False)
                    if remat else one(x))
            if a is not None:
                aux = aux + a
        return x, aux
    outs = []
    mesh = ctx.get("mesh")
    for i, kind in enumerate(cfg.expanded_layers()):
        p = params["layers"][i]
        if verify or decode:
            lctx = {**ctx, "self_mesh": None if mesh is None else mesh.layer(i)}
            block = block_verify if verify else block_decode
            x, o = block(cfg, kind, p, x, caches[i], lctx)
        else:
            x, o, _ = block_full(cfg, kind, p, x, ctx, want_cache)
        outs.append(o)
    return x, outs


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def _encoder_cfg(cfg: ModelConfig, block: Params) -> ModelConfig:
    """The config an encoder block runs under: dense attention where the
    block holds dense weights, whatever the decoder caches.  Compression
    leaves the encoder dense (it caches nothing), so a compressed
    encoder-decoder keeps ``cfg.recalkv`` for its decoder only; the JAX
    package's ``encode`` runs such a block under the decoder's latent
    config and fails on its missing ``l_k``.  A block that holds latents
    (a latent config's random init, as the JAX package draws it) runs
    latent attention, which, as in the JAX package, is causal."""
    if cfg.recalkv is None or "l_k" in block["attn"]:
        return cfg
    return dataclasses.replace(cfg, recalkv=None, cache_quant_bits=None)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """The encoder of an encoder-decoder model: frames (B, S, d), the stub
    frontend's embeddings, through non-causal ``attn_dense`` blocks (the
    einsum path under either backend, as in the JAX package) and the
    encoder's final norm."""
    enc = params["encoder"]
    B, S, _ = frames.shape
    ctx = {"positions": torch.arange(S, device=frames.device).expand(B, S),
           "causal": False,
           "lengths": torch.full((B,), S, dtype=torch.int64, device=frames.device),
           "max_len": S}
    x = frames.to(cfg.dtype)
    for blk in enc["layers"]:
        x, _, _ = block_full(_encoder_cfg(cfg, blk), "attn_dense", blk, x, ctx,
                             want_cache=False)
    return L.rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def cross_source(cfg: ModelConfig, params: Params, source: torch.Tensor | None):
    """The source the cross layers read: ``source`` encoded when the model
    is an encoder-decoder, else as given (None where there is none)."""
    if cfg.encoder_decoder and source is not None:
        return encode(cfg, params, source)
    return source


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   source: torch.Tensor | None = None, mesh=None):
    """The training forward: tokens (B, T) -> (hidden (B, T, d) after the
    final norm, aux), ``aux`` the float32 sum of the MoE blocks'
    load-balance and router z-loss terms (0 without MoE blocks).  Every
    layer takes the einsum path, as in the JAX package; under autograd
    with ``cfg.remat`` each block is recomputed in the backward pass.
    With a ``mesh`` of more than one "data" rank, ``tokens`` are this
    rank's rows and an MoE block runs on every data rank's rows, so its
    capacity, drops and aux are those of the whole batch."""
    check_supported(cfg)
    B, T_ = tokens.shape
    dev = tokens.device
    ctx = {"positions": torch.arange(T_, device=dev).expand(B, T_),
           "lengths": torch.full((B,), T_, dtype=torch.int64, device=dev),
           "source": cross_source(cfg, params, source), "max_len": T_, "mesh": mesh}
    x = embed_tokens(cfg, params, tokens)
    x, aux = run_stack(cfg, params, x, ctx, want_cache=False)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def _lm_head_weight(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def chunked_xent(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512):
    """Summed cross-entropy and the count of counted labels (labels -1
    are masked), both float32, without (B, T, V) logits at once: per
    ``chunk`` positions, summed in order; a T at most ``chunk`` or not a
    multiple of it runs in one pass (the JAX package's rule)."""
    B, T_, _ = hidden.shape
    W = _lm_head_weight(cfg, params)
    labels = labels.long()

    def one(h, lab):
        logits = (h @ W).float()
        mask = (lab >= 0).float()
        gold = torch.gather(logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        return (torch.sum((torch.logsumexp(logits, dim=-1) - gold) * mask),
                torch.sum(mask))

    if T_ <= chunk or T_ % chunk:
        return one(hidden, labels)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T_, chunk):
        s, c = one(hidden[:, i:i + chunk], labels[:, i:i + chunk])
        tot, cnt = tot + s, cnt + c
    return tot, cnt


def loss_fn(cfg: ModelConfig, params: Params, batch: dict):
    """Causal LM loss.  batch: "tokens" (B, T), "labels" (B, T) (-1 =
    pad), optionally "source" (B, S, d) frontend embeddings; numpy or
    tensors (moved to the params' device).  Returns (loss + aux, {"xent",
    "aux", "tokens"})."""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    source = batch.get("source")
    if source is not None:
        source = torch.as_tensor(source, device=dev)
    hidden, aux = forward_hidden(cfg, params, tokens, source)
    tot, cnt = chunked_xent(cfg, params, hidden,
                            torch.as_tensor(batch["labels"], device=dev))
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux, {"xent": loss, "aux": aux, "tokens": cnt}


def logits_for(cfg: ModelConfig, params: Params,
               hidden: torch.Tensor) -> torch.Tensor:
    return (hidden @ _lm_head_weight(cfg, params)).float()


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
            lengths: torch.Tensor, max_len: int,
            source: torch.Tensor | None = None):
    """Aligned right-padded prefill.  tokens (B, T); lengths (B,);
    ``source`` (B, S_src, d) for a model with cross-attention layers
    (encoded first for an encoder-decoder).  Returns (last-token logits
    (B, V) float32, caches)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    ctx = {"positions": positions, "lengths": lengths.to(torch.int64),
           "max_len": max_len, "source": cross_source(cfg, params, source)}
    x = embed_tokens(cfg, params, tokens)
    x, caches = run_stack(cfg, params, x, ctx)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    idx = (lengths.to(torch.int64) - 1).clamp(min=0)
    last = x[torch.arange(B, device=x.device), idx]
    return logits_for(cfg, params, last[:, None, :])[:, 0], caches


def decode_step(cfg: ModelConfig, params: Params, caches: list,
                tokens: torch.Tensor, cur: torch.Tensor,
                active: torch.Tensor | None = None, pages=None, mesh=None):
    """One decode step.  tokens (B,), cur (B,) absolute positions;
    ``active`` (B,) bool masks cache writes for idle rows; ``pages`` =
    (ptab (B, n_sp) int32, page_size) reads and writes page-major pools
    (page_size the full page's); ``mesh``: the caches and rows are this
    rank's shards (module docstring).  The caches are updated in place
    after the layer loop.  Returns (logits (B, V), caches)."""
    x = embed_tokens(cfg, params, tokens[:, None])
    ctx = {"cur": cur, "pages": pages, "mesh": mesh}
    x, updates = run_stack(cfg, params, x, ctx, caches, decode=True)
    KC.apply_decode_writes(caches, updates, cur, active, pages=pages, mesh=mesh)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(cfg, params, x)[:, 0], caches


def verify_step(cfg: ModelConfig, params: Params, caches: list,
                tokens: torch.Tensor, cur: torch.Tensor,
                feed_mask: torch.Tensor, pages=None, mesh=None):
    """Speculative-decoding target pass: logits for S fed tokens in one
    pass.  tokens (B, S) — column 0 is the slot's next sequential feed,
    columns 1.. are draft proposals (-1 pads embed as token 0); cur (B,)
    the position of column 0; feed_mask (B, S) marks candidate columns;
    ``pages`` and ``mesh`` as for :func:`decode_step`.  Cache writes are NOT applied:
    the deferred (B, S, ...) updates are returned for
    :func:`commit_verify_writes`.  Returns (logits (B, S, V) float32,
    updates)."""
    x = embed_tokens(cfg, params, tokens.clamp(min=0))
    ctx = {"cur": cur, "feed_mask": feed_mask, "pages": pages, "mesh": mesh}
    x, updates = run_stack(cfg, params, x, ctx, caches, verify=True)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(cfg, params, x), updates


def commit_verify_writes(caches: list, updates: list, cur: torch.Tensor,
                         mask: torch.Tensor, pages=None, mesh=None) -> list:
    """Write a verify step's deferred entries for the accepted prefix
    (``mask`` (B, S) bool), in place."""
    return KC.apply_verify_writes(caches, updates, cur, mask, pages=pages, mesh=mesh)


CACHE_PARTS = ("self", "cross", "state")


def cache_leaves(caches: list) -> list:
    """Every leaf of every layer's caches, the self ring's, the cross
    cache's and the recurrent state's, in a fixed order: what a slot's
    state is made of."""
    return [leaf for c in caches for part in CACHE_PARTS if part in c
            for leaf in c[part].values()]


def install_table(caches: list, stage: list):
    """The table :func:`swap_cache_slot`'s kernel reads on a card, built
    once over a ring and its stage cache (``None`` on the CPU, where the
    plain version runs).  The caller holds it as long as both caches and
    any graph captured over them live."""
    leaves = cache_leaves(caches)
    if not leaves[0].is_cuda:
        return None
    return InstallTable(leaves, cache_leaves(stage))


def swap_cache_slot(caches: list, stage: list, slot: torch.Tensor,
                    q: torch.Tensor, table=None) -> list:
    """Install row ``q`` of a stage cache (the same layers and leaves as the
    ring, see :func:`init_decode_cache`) into serving slot ``slot`` of the
    ring, in place, its cross cache and recurrent state too: continuous
    batching's mid-window install.  ``slot`` /
    ``q`` are 0-d int64 device tensors; a ``slot`` outside the batch
    copies nothing (JAX's ``mode="drop"``), which is how the window says
    "no install this iteration" without a branch.  On a card ``table`` is
    :func:`install_table` of these two caches.  Ring layout only: a
    paged install copies the page-table row alone (the staged pages were
    scattered into the pool at stage time)."""
    stage_install_rows(cache_leaves(caches), cache_leaves(stage), slot, q, table)
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
        if "self" in cache:
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
