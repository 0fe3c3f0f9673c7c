"""Latent ring KV cache with its decode and verify readers (port of the
ring subset of ``repro.models.kv_cache``).

Per layer the cache is ``{"zk": (B, L, G, r_k), "zv": (B, L, G, r_v),
"pos": (B, L) int64}`` with pre-RoPE latents, or, with
``cfg.cache_quant_bits``, the int8 ring ``{"zk_q", "zv_q": int8 (B, L, G,
r), "zk_s", "zv_s": float32 (B, L, G), "pos"}`` (one scale per token and
group).  ``pos`` holds the absolute position in each slot (-1 = empty);
masking and RoPE read it, so ring wraparound needs no other bookkeeping.
Writes go to slot ``cur % L``.

Deferred writes: the decode reader scores the current token as an extra
self column and returns its entry; :func:`apply_decode_writes` writes all
layers' entries once, after the layer loop.  The verify reader (S tokens,
speculative decoding) returns (B, S, ...) entries, and
:func:`apply_verify_writes` commits only the accepted prefix.  Unlike the
JAX package (whose arrays are immutable) these writes update the ring
tensors IN PLACE.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.quant import dequantize, quantize

Params = dict[str, Any]
NEG_INF = L.NEG_INF


def init_self_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    device, layer_idx: int | None = None) -> Params:
    rt = cfg.recalkv
    Lr = cfg.cache_len(kind, max_len)
    G = rt.num_groups(cfg.num_kv_heads)
    rk, rv = rt.ranks_for(layer_idx)
    pos = torch.full((batch, Lr), -1, dtype=torch.int64, device=device)
    if cfg.cache_quant_bits is not None:
        z = lambda *sh, dt: torch.zeros(sh, dtype=dt, device=device)
        return {"zk_q": z(batch, Lr, G, rk, dt=torch.int8),
                "zk_s": z(batch, Lr, G, dt=torch.float32),
                "zv_q": z(batch, Lr, G, rv, dt=torch.int8),
                "zv_s": z(batch, Lr, G, dt=torch.float32),
                "pos": pos}
    return {
        "zk": torch.zeros((batch, Lr, G, rk), dtype=cfg.dtype, device=device),
        "zv": torch.zeros((batch, Lr, G, rv), dtype=cfg.dtype, device=device),
        "pos": pos,
    }


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device, layer_idx: int | None = None) -> Params:
    return {"self": init_self_cache(cfg, kind, batch, max_len, device,
                                    layer_idx=layer_idx)}


def write_prefill(cache_arr: torch.Tensor, values: torch.Tensor,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Bulk-write prefill values (B, T, ...) into ring slots (pos % L).

    T <= L is a plain aligned write.  T > L wraps per row, last write
    wins: each row keeps its own last min(length, L) positions, and padded
    columns (index >= ``lengths``) never write."""
    B, T = values.shape[:2]
    Lr = cache_arr.shape[1]
    out = cache_arr.clone()
    if T <= Lr:
        out[:, :T] = values.to(out.dtype)
        return out
    dev = values.device
    eff = (torch.full((B,), T, dtype=torch.int64, device=dev) if lengths is None
           else lengths.clamp(max=T).to(torch.int64))
    s = torch.arange(Lr, device=dev)[None, :]
    wraps = torch.div(eff[:, None] - 1 - s, Lr, rounding_mode="floor")
    t_last = s + wraps * Lr
    valid = wraps >= 0
    shape = (B, Lr) + (1,) * (values.ndim - 2)
    idx = t_last.clamp(0, T - 1).reshape(shape).expand((B, Lr) + values.shape[2:])
    gathered = torch.gather(values, 1, idx)
    return torch.where(valid.reshape(shape), gathered.to(out.dtype), out)


def prefill_pos(lengths: torch.Tensor, T: int, Lr: int) -> torch.Tensor:
    """Position array after an aligned right-padded prefill of length T —
    the same slot mapping as :func:`write_prefill`."""
    B = lengths.shape[0]
    idx = torch.arange(T, device=lengths.device)
    vals = torch.where(idx[None, :] < lengths[:, None], idx[None, :], -1)
    cache = torch.full((B, Lr), -1, dtype=torch.int64, device=lengths.device)
    return write_prefill(cache, vals.to(torch.int64), lengths)


def latent_cache_entry(cfg: ModelConfig, zk: torch.Tensor,
                       zv: torch.Tensor) -> Params:
    """Ring-cache leaves for latents at any leading shape (..., G, r):
    model-dtype latents, or int8 plus a per-token scale when
    ``cfg.cache_quant_bits`` is set."""
    if cfg.cache_quant_bits is None:
        return {"zk": zk, "zv": zv}
    zk_q, zk_s = quantize(zk, cfg.cache_quant_bits)
    zv_q, zv_s = quantize(zv, cfg.cache_quant_bits)
    return {"zk_q": zk_q, "zk_s": zk_s[..., 0],
            "zv_q": zv_q, "zv_s": zv_s[..., 0]}


def latent_cache_arrays(cache: Params, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(zk, zv) from a float or int8 latent cache dict, dequantized."""
    if "zk_q" in cache:
        return (dequantize(cache["zk_q"], cache["zk_s"][..., None], dtype),
                dequantize(cache["zv_q"], cache["zv_s"][..., None], dtype))
    return cache["zk"].to(dtype), cache["zv"].to(dtype)


def _decode_mask(pos: torch.Tensor, cur: torch.Tensor,
                 window: int | None) -> torch.Tensor:
    """(B, S) validity mask for cache slots at decode time."""
    m = (pos >= 0) & (pos <= cur[:, None])
    if window is not None:
        m &= pos > (cur[:, None] - window)
    return m


def _two_part_softmax(logits_c: torch.Tensor, logits_s: torch.Tensor):
    """Softmax over [cache columns | self column] without concatenating.
    logits_c: (..., S); logits_s: (..., 1).  Returns (w_c, w_s)."""
    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True), logits_s)
    e_c = torch.exp(logits_c - m)
    e_s = torch.exp(logits_s - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s
    return e_c / denom, e_s / denom


def decode_attn_latent(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cur: torch.Tensor,
                       window: int | None, theta: float | None = None):
    """ReCalKV decode: reconstruct keys from the latent ring, RoPE by stored
    positions, keep values latent, project through the fused W~_o.
    Returns (y (B, 1, d), deferred update {"zk", "zv", "pos"})."""
    theta = theta or cfg.rope_theta
    B = x.shape[0]
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    s = cfg.recalkv.slots(Hkv)
    G = Hkv // s
    g = H // Hkv
    q = (x @ p["wq"]).reshape(B, 1, H, dh)
    q = L.maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    cos_q, sin_q = L.rope_tables(cur[:, None], dh, theta)
    q = L.apply_rope(q, cos_q, sin_q)

    zk_new = torch.einsum("bd,gdr->bgr", x[:, 0], p["l_k"]).to(x.dtype)
    zv_new = torch.einsum("bd,gdr->bgr", x[:, 0], p["l_v"]).to(x.dtype)
    scale = dh ** -0.5
    entry = latent_cache_entry(cfg, zk_new, zv_new)
    updates = {**entry, "pos": cur.to(torch.int64)}
    if cfg.attn_backend == "kernel":
        # One kernel call scores [ring | self]; qk-norm is applied to the
        # reconstructed keys in-kernel.
        o_lat = kops.latent_decode(
            q[:, 0], cache, p["r_k"], cur, theta=theta, window=window,
            scale=scale, self_entry=entry, k_norm=p.get("k_norm"),
            norm_eps=cfg.norm_eps)
        o_lat = o_lat.to(x.dtype).reshape(B, 1, H, -1)
        return torch.einsum("bthr,hrd->btd", o_lat, p["wo_fused"]), updates

    qr = q[:, 0].reshape(B, Hkv, g, dh)
    # With an int8 ring, attention (and the self column) reads the
    # dequantized latents — the same values the kernel path sees.
    zk_c, zv_c = latent_cache_arrays(cache, x.dtype)
    zk_self, zv_self = latent_cache_arrays(entry, x.dtype)
    k = L.reconstruct_keys(zk_c, p["r_k"], Hkv, dh)
    k = L.maybe_head_norm(k, p.get("k_norm"), cfg.norm_eps)
    cos_k, sin_k = L.rope_tables(cache["pos"].clamp(min=0), dh, theta)
    k = L.apply_rope(k, cos_k, sin_k)
    k_self = L.reconstruct_keys(zk_self[:, None], p["r_k"], Hkv, dh)
    k_self = L.maybe_head_norm(k_self, p.get("k_norm"), cfg.norm_eps)
    k_self = L.apply_rope(k_self, cos_q, sin_q)[:, 0]       # (B, Hkv, dh)

    logits_c = torch.einsum("bkgd,bskd->bkgs", qr, k).float() * scale
    mask = _decode_mask(cache["pos"], cur, window)[:, None, None, :]
    logits_c = torch.where(mask, logits_c, torch.full_like(logits_c, NEG_INF))
    logits_s = (torch.einsum("bkgd,bkd->bkg", qr, k_self).float() * scale)[..., None]
    w_c, w_s = _two_part_softmax(logits_c, logits_s)
    w_c = w_c.to(x.dtype).reshape(B, G, s * g, -1)
    w_s = w_s.to(x.dtype).reshape(B, G, s * g, 1)
    o_lat = (torch.einsum("bGhs,bsGr->bGhr", w_c, zv_c)
             + w_s * zv_self[:, :, None, :])
    o_lat = o_lat.reshape(B, 1, H, -1)
    return torch.einsum("bthr,hrd->btd", o_lat, p["wo_fused"]), updates


def _merge_leaf(cache_leaf: torch.Tensor, upd: torch.Tensor,
                cur: torch.Tensor, active: torch.Tensor | None) -> None:
    """Write one slot entry per row at ``cur % L``, in place; rows with
    ``active`` False are left untouched."""
    B, Lr = cache_leaf.shape[:2]
    rows = torch.arange(B, device=cache_leaf.device)
    slot = cur.to(torch.int64) % Lr
    new = upd.to(cache_leaf.dtype)
    if active is not None:
        new = torch.where(active.reshape((B,) + (1,) * (new.ndim - 1)),
                          new, cache_leaf[rows, slot])
    cache_leaf[rows, slot] = new


def apply_decode_writes(caches: list, updates: list, cur: torch.Tensor,
                        active: torch.Tensor | None = None) -> list:
    """Merge the deferred per-layer decode entries into the rings, in
    place (one pass after the layer loop).  ``active`` (B,) bool freezes
    the rows of inactive sequences entirely."""
    for cache, upd in zip(caches, updates):
        for name, leaf in cache["self"].items():
            _merge_leaf(leaf, upd["self"][name], cur, active)
    return caches


# ---------------------------------------------------------------------------
# Verify reader (speculative decoding: S fed tokens per step, x: (B, S, d))
# ---------------------------------------------------------------------------
#
# Query j (position cur + j) attends the ring (entries with pos <= cur+j,
# window-limited) plus a causal block over the S fresh latents.  Ring
# writes stay deferred: the (B, S, ...) entries go back to the caller,
# which commits only the accepted prefix (apply_verify_writes), so a
# rejected draft token never touches a ring.


def _joint_softmax(logits_c: torch.Tensor, logits_s: torch.Tensor):
    """Softmax over [ring columns | S self columns] without concatenating.
    logits_c: (..., S_ring); logits_s: (..., S_new)."""
    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True),
                      logits_s.amax(dim=-1, keepdim=True))
    e_c = torch.exp(logits_c - m)
    e_s = torch.exp(logits_s - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s.sum(dim=-1, keepdim=True)
    return e_c / denom, e_s / denom


def _verify_masks(cache_pos: torch.Tensor, cur: torch.Tensor, S: int,
                  feed_mask: torch.Tensor, window: int | None):
    """(pos_q, ring (B, S, L), self (B, S, S)) masks for an S-token verify
    step: query j sees ring entries with 0 <= pos <= cur+j and fresh
    columns n <= j that are feed candidates (``feed_mask``)."""
    j = torch.arange(S, device=cur.device)
    pos_q = cur[:, None] + j.to(cur.dtype)[None, :]
    cp = cache_pos[:, None, :]
    ring = (cp >= 0) & (cp <= pos_q[:, :, None])
    self_m = (j[None, :, None] >= j[None, None, :]) & feed_mask[:, None, :]
    if window is not None:
        ring &= cp > pos_q[:, :, None] - window
        self_m &= j[None, None, :] > j[None, :, None] - window
    return pos_q, ring, self_m


def verify_attn_latent(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cur: torch.Tensor,
                       feed_mask: torch.Tensor, window: int | None,
                       theta: float | None = None):
    """ReCalKV S-token verify: cached keys reconstructed and rotated by
    stored position, fresh latents as a causal self block, values latent
    through the fused W~_o.  Returns (y (B, S, d), deferred entries with
    (B, S, ...) leaves and "pos" (B, S))."""
    theta = theta or cfg.rope_theta
    B, S = x.shape[:2]
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    s = cfg.recalkv.slots(Hkv)
    G = Hkv // s
    g = H // Hkv
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    q = L.maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    pos_q = cur[:, None] + torch.arange(S, dtype=cur.dtype, device=cur.device)
    cos_q, sin_q = L.rope_tables(pos_q, dh, theta)
    q = L.apply_rope(q, cos_q, sin_q)

    zk_new = torch.einsum("bjd,gdr->bjgr", x, p["l_k"]).to(x.dtype)
    zv_new = torch.einsum("bjd,gdr->bjgr", x, p["l_v"]).to(x.dtype)
    entry = latent_cache_entry(cfg, zk_new, zv_new)
    updates = {**entry, "pos": pos_q.to(torch.int64)}
    scale = dh ** -0.5
    if cfg.attn_backend == "kernel":
        # One multi-query kernel call: the S fresh latents are its own
        # self-column operands (int8 round trip included), rotated at pos_q.
        o_lat = kops.latent_decode_mq(
            q, cache, p["r_k"], cur, feed_mask, entry, theta=theta,
            window=window, scale=scale, k_norm=p.get("k_norm"),
            norm_eps=cfg.norm_eps)
        o_lat = o_lat.to(x.dtype).reshape(B, S, H, -1)
        return torch.einsum("bjhr,hrd->bjd", o_lat, p["wo_fused"]), updates

    qr = q.reshape(B, S, Hkv, g, dh)
    _, ring_m, self_m = _verify_masks(cache["pos"], cur, S, feed_mask, window)
    zk_c, zv_c = latent_cache_arrays(cache, x.dtype)
    zk_self, zv_self = latent_cache_arrays(entry, x.dtype)
    k = L.reconstruct_keys(zk_c, p["r_k"], Hkv, dh)
    k = L.maybe_head_norm(k, p.get("k_norm"), cfg.norm_eps)
    cos_k, sin_k = L.rope_tables(cache["pos"].clamp(min=0), dh, theta)
    k = L.apply_rope(k, cos_k, sin_k)
    k_self = L.reconstruct_keys(zk_self, p["r_k"], Hkv, dh)
    k_self = L.maybe_head_norm(k_self, p.get("k_norm"), cfg.norm_eps)
    k_self = L.apply_rope(k_self, cos_q, sin_q)              # (B, S, Hkv, dh)

    logits_c = torch.einsum("bjkgd,bskd->bkgjs", qr, k).float() * scale
    logits_c = torch.where(ring_m[:, None, None], logits_c,
                           torch.full_like(logits_c, NEG_INF))
    logits_s = torch.einsum("bjkgd,bnkd->bkgjn", qr, k_self).float() * scale
    logits_s = torch.where(self_m[:, None, None], logits_s,
                           torch.full_like(logits_s, NEG_INF))
    w_c, w_s = _joint_softmax(logits_c, logits_s)
    Lr = zk_c.shape[1]
    w_cg = w_c.to(x.dtype).reshape(B, G, s * g, S, Lr)
    w_sg = w_s.to(x.dtype).reshape(B, G, s * g, S, S)
    o_lat = (torch.einsum("bGhjs,bsGr->bjGhr", w_cg, zv_c)
             + torch.einsum("bGhjn,bnGr->bjGhr", w_sg, zv_self))
    o_lat = o_lat.reshape(B, S, H, -1)
    return torch.einsum("bjhr,hrd->bjd", o_lat, p["wo_fused"]), updates


def apply_verify_writes(caches: list, updates: list, cur: torch.Tensor,
                        mask: torch.Tensor) -> list:
    """Commit an S-position verify step's deferred entries for the
    accepted prefix only, in place: column j writes at position cur + j
    where ``mask[:, j]``, so the ring after a speculative round equals
    sequential decode of the accepted tokens.  With S <= L a row's S
    columns land on distinct slots and go in one write per leaf; a longer
    window writes column by column in ascending j (last write wins, as S
    sequential decode writes would)."""
    S = mask.shape[1]
    cols = torch.arange(S, device=cur.device)
    for cache, upd in zip(caches, updates):
        for name, leaf in cache["self"].items():
            new = upd["self"][name]
            B, Lr = leaf.shape[:2]
            if S > Lr:
                for j in range(S):
                    _merge_leaf(leaf, new[:, j], cur + j, mask[:, j])
                continue
            rows = torch.arange(B, device=leaf.device)[:, None]
            slots = (cur.to(torch.int64)[:, None] + cols) % Lr          # (B, S)
            m = mask.reshape(mask.shape + (1,) * (new.ndim - 2))
            leaf[rows, slots] = torch.where(m, new.to(leaf.dtype), leaf[rows, slots])
    return caches


def invalidate_positions(caches: list, cur: torch.Tensor,
                         mask: torch.Tensor) -> list:
    """Mark the ring entry at position ``cur`` empty (pos = -1) in every
    layer, in place, for rows where ``mask``: retires a draft model's
    entries for rejected proposals, which it wrote as it proposed."""
    for cache in caches:
        pos = cache["self"]["pos"]
        rows = torch.arange(pos.shape[0], device=pos.device)
        slot = cur.to(torch.int64) % pos.shape[1]
        pos[rows, slot] = torch.where(mask, -1, pos[rows, slot])
    return caches
