"""Float-latent ring KV cache and the single-step decode reader
(port of the ring subset of ``repro.models.kv_cache``).

Per layer the cache is ``{"zk": (B, L, G, r_k), "zv": (B, L, G, r_v),
"pos": (B, L) int64}`` with pre-RoPE latents.  ``pos`` holds the absolute
position in each slot (-1 = empty); masking and RoPE read it, so ring
wraparound needs no other bookkeeping.  Writes go to slot ``cur % L``.

Deferred writes: the decode reader scores the current token as an extra
self column and returns its entry; :func:`apply_decode_writes` writes all
layers' entries once, after the layer loop.  Unlike the JAX package (whose
arrays are immutable) that write updates the ring tensors IN PLACE.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]
NEG_INF = L.NEG_INF


def init_self_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    device, layer_idx: int | None = None) -> Params:
    rt = cfg.recalkv
    Lr = cfg.cache_len(kind, max_len)
    G = rt.num_groups(cfg.num_kv_heads)
    rk, rv = rt.ranks_for(layer_idx)
    return {
        "zk": torch.zeros((batch, Lr, G, rk), dtype=cfg.dtype, device=device),
        "zv": torch.zeros((batch, Lr, G, rv), dtype=cfg.dtype, device=device),
        "pos": torch.full((batch, Lr), -1, dtype=torch.int64, device=device),
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
    """Ring-cache leaves for float latents at any leading shape (..., G, r)."""
    return {"zk": zk, "zv": zv}


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
    zk_c, zv_c = cache["zk"].to(x.dtype), cache["zv"].to(x.dtype)
    k = L.reconstruct_keys(zk_c, p["r_k"], Hkv, dh)
    k = L.maybe_head_norm(k, p.get("k_norm"), cfg.norm_eps)
    cos_k, sin_k = L.rope_tables(cache["pos"].clamp(min=0), dh, theta)
    k = L.apply_rope(k, cos_k, sin_k)
    k_self = L.reconstruct_keys(zk_new[:, None], p["r_k"], Hkv, dh)
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
             + w_s * zv_new[:, :, None, :])
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
