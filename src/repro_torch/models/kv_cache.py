"""Dense, latent and MLA KV caches — ring or paged pool — with their
decode and verify readers (port of the dense, latent and MLA subset of
``repro.models.kv_cache``).

Per layer the cache is the dense ``{"k", "v": (B, L, Hkv, dh), "pos": (B,
L) int64}`` with post-RoPE keys (``cfg.recalkv is None``), or the latent
``{"zk": (B, L, G, r_k), "zv": (B, L, G, r_v), "pos"}`` with pre-RoPE
latents, or, with ``cfg.cache_quant_bits``, the int8 ring ``{"zk_q",
"zv_q": int8 (B, L, G, r), "zk_s", "zv_s": float32 (B, L, G), "pos"}``
(one scale per token and group).  An MLA model (``cfg.mla``) caches
``{"ckv": (B, L, r_kv), "krope": (B, L, dr), "pos"}``: the normalised
latent and the post-RoPE key columns all heads share, in the model dtype
(as in the JAX package).  ``pos`` holds the absolute position in each
slot (-1 = empty); masking and RoPE read it, so ring wraparound needs no
other bookkeeping.  Writes go to slot ``cur % L``.

Deferred writes: the decode reader scores the current token as an extra
self column and returns its entry; :func:`apply_decode_writes` writes all
layers' entries once, after the layer loop.  The verify reader (S tokens,
speculative decoding) returns (B, S, ...) entries, and
:func:`apply_verify_writes` commits only the accepted prefix.  Unlike the
JAX package (whose arrays are immutable) these writes update the ring
tensors IN PLACE.

Paged layout: the same leaves live page-major in a pool shared by all
slots — ``(n_pages, page_size, ...)`` instead of ``(B, max_len, ...)``
(int8 scales stay page-local) — and a ``(B, n_sp)`` int32 page table maps
slot page j of row b to a physical page.  Page 0 is the null page: its
``pos`` stays -1 and it is never written, so an unmapped slot page reads
as empty.  ``pages = (ptab, page_size)`` switches the readers and writers
below to the pool; ``None`` means the ring.
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
    """Empty ring leaves (batch, max_len, ...), or a page-major pool when
    called with (n_pages, page_size) in their place."""
    rt = cfg.recalkv
    Lr = cfg.cache_len(kind, max_len)
    pos = torch.full((batch, Lr), -1, dtype=torch.int64, device=device)
    if cfg.mla is not None:
        a = cfg.mla
        return {"ckv": torch.zeros((batch, Lr, a.kv_lora_rank), dtype=cfg.dtype,
                                   device=device),
                "krope": torch.zeros((batch, Lr, a.qk_rope_dim), dtype=cfg.dtype,
                                     device=device),
                "pos": pos}
    if rt is None:
        shape = (batch, Lr, cfg.num_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "pos": pos}
    G = rt.num_groups(cfg.num_kv_heads)
    rk, rv = rt.ranks_for(layer_idx)
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


def paged_view(cache: Params, ptab: torch.Tensor) -> Params:
    """Slot-major view of a page-major cache dict: each leaf's pages are
    gathered through the table into a (B, n_sp * page_size, ...) ring —
    the arrays the ring layout would hold, so every ring reader runs on
    it unchanged."""
    return {k: kops.gather_pages(v, ptab) for k, v in cache.items()}


def _paged_targets(ptab: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor | None,
                   ps: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(page, offset, writes) of entries (B, n) at positions ``pos`` (B, n)
    written through the page table as the JAX package writes them
    (``_paged_merge_leaf`` and ``apply_verify_writes`` there): column j
    after column j - 1, so a later column wins, and each column a decode
    write, page ptab[b, pos // ps] with the index clipped to the table's
    last page, offset pos % ps, the null page 0 never written, and of the
    rows whose entries of one column hit one page only the first writes
    (JAX's argmax over its hit matrix).  Entries that write nothing target
    the null page at their offset, so a write of the pool's own values
    there leaves one index put free of duplicate targets with different
    values."""
    B, n = pos.shape
    n_sp = ptab.shape[1]
    page = ptab.long().gather(1, torch.div(pos, ps, rounding_mode="floor").clamp(0, n_sp - 1))
    off = pos % ps
    ok = page != 0
    if mask is not None:
        ok = ok & mask
    rows = torch.arange(B, device=pos.device)
    earlier = rows[None, :] < rows[:, None]                        # (b, b'): b' < b
    first = ~((page[:, None] == page[None, :]) & ok[None, :]
              & earlier[..., None]).any(1)                         # (B, n)
    ok = ok & first
    if n > 1:   # a later column's entry at the same (page, offset) wins
        key, col = (page * ps + off).reshape(-1), torch.arange(n, device=pos.device)
        col = col.expand(B, n).reshape(-1)
        later = ((key[:, None] == key[None, :]) & ok.reshape(-1)[None, :]
                 & (col[None, :] > col[:, None])).any(1)
        ok = ok & ~later.reshape(B, n)
    return torch.where(ok, page, 0), off, ok


def _paged_merge_leaf(pool: torch.Tensor, new: torch.Tensor, targets) -> None:
    """Write entries (B, n, ...) through ``_paged_targets``' (page,
    offset, writes), in place."""
    page, off, ok = targets
    shape = ok.shape + (1,) * (new.ndim - 2)
    pool[page, off] = torch.where(ok.reshape(shape), new.to(pool.dtype),
                                  pool[page, off])


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


def kernel_fallback_kinds(cfg: ModelConfig) -> list[str]:
    """Layer kinds that take the einsum path even under
    ``attn_backend="kernel"`` (JAX's ``pallas_fallback_kinds``, for the
    kinds the port serves): the absorbed-MLA readers score in the c_kv
    latent space, with no kernel, so an MLA model lists every kind it has.
    The engine warns once when this list is non-empty, so a requested
    kernel backend never degrades silently."""
    return sorted(set(cfg.expanded_layers())) if cfg.mla is not None else []


def _pool_route(cfg: ModelConfig, cache: Params, pages):
    """(cache, ptab) for a dense or latent reader: the float pool under the
    kernel backend stays page-major for K4 / K7; every other reader
    (einsum, and the int8 kernels) reads the gathered slot-major view, as
    in the JAX package.  The MLA readers take no kernel and always read
    the view (:func:`decode_attn_mla`)."""
    if pages is None:
        return cache, None
    if cfg.attn_backend == "kernel" and cfg.cache_quant_bits is None:
        return cache, pages[0]
    return paged_view(cache, pages[0]), None


def decode_attn_dense(p: Params, x: torch.Tensor, cache: Params,
                      cfg: ModelConfig, cur: torch.Tensor,
                      window: int | None, theta: float | None = None,
                      pages: tuple | None = None):
    """Dense decode: the new token's post-RoPE key and value enter the
    softmax as a self column and come back as the deferred update.
    ``pages`` = (ptab, page_size) reads a page-major pool.  Returns
    (y (B, 1, d), deferred update {"k", "v", "pos"})."""
    cache, ptab = _pool_route(cfg, cache, pages)
    B = x.shape[0]
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    g = H // Hkv
    q = (x @ p["wq"]).reshape(B, 1, H, dh)
    k_new = (x @ p["wk"]).reshape(B, Hkv, dh)
    v_new = (x @ p["wv"]).reshape(B, Hkv, dh)
    q = L.maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    k_new = L.maybe_head_norm(k_new, p.get("k_norm"), cfg.norm_eps)
    cos, sin = L.rope_tables(cur[:, None], dh, theta or cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k_new = L.apply_rope(k_new[:, None], cos, sin)[:, 0]

    scale = dh ** -0.5
    updates = {"k": k_new, "v": v_new, "pos": cur.to(torch.int64)}
    if cfg.attn_backend == "kernel":
        # K1 / K4's dense core (csrc/dense_decode.cu): one call scores
        # [ring | self].
        kw = dict(window=window, scale=scale,
                  self_entry={"k": k_new, "v": v_new})
        o = (kops.dense_decode(q[:, 0], cache, cur, **kw) if ptab is None
             else kops.dense_decode_paged(q[:, 0], cache, ptab, cur, **kw))
        return o.to(x.dtype).reshape(B, 1, H * dh) @ p["wo"], updates

    qr = q[:, 0].reshape(B, Hkv, g, dh)
    k_c = cache["k"].to(x.dtype)
    logits_c = torch.einsum("bkgd,bskd->bkgs", qr, k_c).float() * scale
    mask = _decode_mask(cache["pos"], cur, window)[:, None, None, :]
    logits_c = torch.where(mask, logits_c, torch.full_like(logits_c, NEG_INF))
    logits_s = (torch.einsum("bkgd,bkd->bkg", qr, k_new).float() * scale)[..., None]
    w_c, w_s = _two_part_softmax(logits_c, logits_s)
    w_c, w_s = w_c.to(x.dtype), w_s.to(x.dtype)
    o = (torch.einsum("bkgs,bskd->bkgd", w_c, cache["v"].to(x.dtype))
         + w_s * v_new[:, :, None, :])
    return o.reshape(B, 1, H * dh) @ p["wo"], updates


def decode_attn_latent(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cur: torch.Tensor,
                       window: int | None, theta: float | None = None,
                       pages: tuple | None = None):
    """ReCalKV decode: reconstruct keys from the latent ring, RoPE by stored
    positions, keep values latent, project through the fused W~_o.
    ``pages`` = (ptab, page_size) reads a page-major pool.  Returns
    (y (B, 1, d), deferred update {"zk", "zv", "pos"})."""
    cache, ptab = _pool_route(cfg, cache, pages)
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
        kw = dict(theta=theta, window=window, scale=scale, self_entry=entry,
                  k_norm=p.get("k_norm"), norm_eps=cfg.norm_eps)
        o_lat = (kops.latent_decode(q[:, 0], cache, p["r_k"], cur, **kw)
                 if ptab is None else
                 kops.latent_decode_paged(q[:, 0], cache, ptab, p["r_k"], cur,
                                          **kw))
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


def _mla_inputs(p: Params, x: torch.Tensor, cfg: ModelConfig,
                pos_q: torch.Tensor):
    """The absorbed-MLA reader's operands for tokens x (B, S, d) at
    positions pos_q (B, S): the query's latent-space half q_abs (B, S, H,
    r_kv) = q_nope through ``wkv_b``'s key columns, its post-RoPE half q_pe
    (B, S, H, dr), the fresh cache entries ckv (B, S, r_kv) and krope (B,
    S, dr), and ``wkv_b``'s value columns w_v (r_kv, H, dv)."""
    a = cfg.mla
    B, S = x.shape[:2]
    H = cfg.num_heads
    dn, dr, dv = a.qk_nope_dim, a.qk_rope_dim, a.v_head_dim
    q_lat = L.rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(B, S, H, dn + dr)
    cos, sin = L.rope_tables(pos_q, dr, cfg.rope_theta)
    q_pe = L.apply_rope(q[..., dn:], cos, sin)
    kv_a = x @ p["wkv_a"]
    ckv = L.rmsnorm(kv_a[..., :a.kv_lora_rank], p["kv_a_norm"],
                    cfg.norm_eps).to(x.dtype)
    krope = L.apply_rope(kv_a[..., a.kv_lora_rank:][:, :, None, :], cos,
                         sin)[:, :, 0].to(x.dtype)
    wkv_b = p["wkv_b"].reshape(a.kv_lora_rank, H, dn + dv)
    q_abs = torch.einsum("bjhd,rhd->bjhr", q[..., :dn], wkv_b[..., :dn])
    return q_abs, q_pe, ckv, krope, wkv_b[..., dn:]


def decode_attn_mla(p: Params, x: torch.Tensor, cache: Params,
                    cfg: ModelConfig, cur: torch.Tensor,
                    pages: tuple | None = None):
    """Absorbed MLA decode: scores and outputs are computed in the c_kv
    latent space (q_nope through ``wkv_b``'s key columns, the output through
    its value columns), so no per-head key or value is ever built.  The
    new token's entry is a self column and comes back as the deferred
    update.  No kernel: a pool is read through its gathered view, as in
    the JAX package (never page-major, whatever the backend).  Returns
    (y (B, 1, d), deferred update {"ckv", "krope", "pos"})."""
    if pages is not None:
        cache = paged_view(cache, pages[0])
    a = cfg.mla
    B = x.shape[0]
    H, dv = cfg.num_heads, a.v_head_dim
    q_abs, q_pe, ckv_new, kr_new, w_v = _mla_inputs(p, x, cfg, cur[:, None])
    q_abs, q_pe, ckv_new, kr_new = q_abs[:, 0], q_pe[:, 0], ckv_new[:, 0], kr_new[:, 0]
    ckv, krope = cache["ckv"].to(x.dtype), cache["krope"].to(x.dtype)
    scale = (a.qk_nope_dim + a.qk_rope_dim) ** -0.5
    logits_c = (torch.einsum("bhr,bsr->bhs", q_abs, ckv)
                + torch.einsum("bhd,bsd->bhs", q_pe, krope)).float() * scale
    mask = _decode_mask(cache["pos"], cur, None)[:, None, :]
    logits_c = torch.where(mask, logits_c, torch.full_like(logits_c, NEG_INF))
    logits_s = ((torch.einsum("bhr,br->bh", q_abs, ckv_new)
                 + torch.einsum("bhd,bd->bh", q_pe, kr_new)).float() * scale)[..., None]
    w_c, w_s = _two_part_softmax(logits_c, logits_s)
    w_c, w_s = w_c.to(x.dtype), w_s.to(x.dtype)
    o_lat = torch.einsum("bhs,bsr->bhr", w_c, ckv) + w_s * ckv_new[:, None, :]
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_v)
    y = o.reshape(B, 1, H * dv) @ p["wo"]
    return y, {"ckv": ckv_new, "krope": kr_new, "pos": cur.to(torch.int64)}


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
                        active: torch.Tensor | None = None,
                        pages: tuple | None = None) -> list:
    """Merge the deferred per-layer decode entries into the rings (or,
    with ``pages``, the pools), in place (one pass after the layer loop).
    ``active`` (B,) bool freezes the rows of inactive sequences entirely."""
    targets = None if pages is None else _paged_targets(
        pages[0], cur.to(torch.int64)[:, None], None if active is None else active[:, None],
        pages[1])
    for cache, upd in zip(caches, updates):
        for name, leaf in cache["self"].items():
            if pages is None:
                _merge_leaf(leaf, upd["self"][name], cur, active)
            else:
                _paged_merge_leaf(leaf, upd["self"][name][:, None], targets)
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


def verify_attn_dense(p: Params, x: torch.Tensor, cache: Params,
                      cfg: ModelConfig, cur: torch.Tensor,
                      feed_mask: torch.Tensor, window: int | None,
                      theta: float | None = None,
                      pages: tuple | None = None):
    """Dense S-token verify: the S fresh post-RoPE keys and values are a
    causal self block.  Returns (y (B, S, d), deferred entries with (B,
    S, ...) leaves and "pos" (B, S))."""
    cache, ptab = _pool_route(cfg, cache, pages)
    B, S = x.shape[:2]
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    g = H // Hkv
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k_new = (x @ p["wk"]).reshape(B, S, Hkv, dh)
    v_new = (x @ p["wv"]).reshape(B, S, Hkv, dh)
    q = L.maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    k_new = L.maybe_head_norm(k_new, p.get("k_norm"), cfg.norm_eps)
    pos_q = cur[:, None] + torch.arange(S, dtype=cur.dtype, device=cur.device)
    cos, sin = L.rope_tables(pos_q, dh, theta or cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k_new = L.apply_rope(k_new, cos, sin)

    scale = dh ** -0.5
    updates = {"k": k_new, "v": v_new, "pos": pos_q.to(torch.int64)}
    if cfg.attn_backend == "kernel":
        # K5 / K7's dense core (csrc/dense_verify.cu): q and the fresh keys
        # arrive post-RoPE.
        entries = {"k": k_new, "v": v_new}
        kw = dict(window=window, scale=scale)
        o = (kops.dense_decode_mq(q, cache, cur, feed_mask, entries, **kw)
             if ptab is None else
             kops.dense_decode_mq_paged(q, cache, ptab, cur, feed_mask,
                                        entries, **kw))
        return o.to(x.dtype).reshape(B, S, H * dh) @ p["wo"], updates

    qr = q.reshape(B, S, Hkv, g, dh)
    _, ring_m, self_m = _verify_masks(cache["pos"], cur, S, feed_mask, window)
    k_c = cache["k"].to(x.dtype)
    logits_c = torch.einsum("bjkgd,bskd->bkgjs", qr, k_c).float() * scale
    logits_c = torch.where(ring_m[:, None, None], logits_c,
                           torch.full_like(logits_c, NEG_INF))
    logits_s = torch.einsum("bjkgd,bnkd->bkgjn", qr, k_new).float() * scale
    logits_s = torch.where(self_m[:, None, None], logits_s,
                           torch.full_like(logits_s, NEG_INF))
    w_c, w_s = _joint_softmax(logits_c, logits_s)
    w_c, w_s = w_c.to(x.dtype), w_s.to(x.dtype)
    o = (torch.einsum("bkgjs,bskd->bjkgd", w_c, cache["v"].to(x.dtype))
         + torch.einsum("bkgjn,bnkd->bjkgd", w_s, v_new))
    return o.reshape(B, S, H * dh) @ p["wo"], updates


def verify_attn_latent(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cur: torch.Tensor,
                       feed_mask: torch.Tensor, window: int | None,
                       theta: float | None = None,
                       pages: tuple | None = None):
    """ReCalKV S-token verify: cached keys reconstructed and rotated by
    stored position, fresh latents as a causal self block, values latent
    through the fused W~_o.  ``pages`` as for :func:`decode_attn_latent`.
    Returns (y (B, S, d), deferred entries with (B, S, ...) leaves and
    "pos" (B, S))."""
    cache, ptab = _pool_route(cfg, cache, pages)
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
        kw = dict(theta=theta, window=window, scale=scale,
                  k_norm=p.get("k_norm"), norm_eps=cfg.norm_eps)
        o_lat = (kops.latent_decode_mq(q, cache, p["r_k"], cur, feed_mask,
                                       entry, **kw)
                 if ptab is None else
                 kops.latent_decode_mq_paged(q, cache, ptab, p["r_k"], cur,
                                             feed_mask, entry, **kw))
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


def verify_attn_mla(p: Params, x: torch.Tensor, cache: Params,
                    cfg: ModelConfig, cur: torch.Tensor,
                    feed_mask: torch.Tensor, pages: tuple | None = None):
    """Absorbed-MLA S-token verify: :func:`decode_attn_mla`'s latent-space
    scores over the ring plus a causal block over the S fresh entries.
    Returns (y (B, S, d), deferred entries with (B, S, ...) leaves and
    "pos" (B, S))."""
    if pages is not None:
        cache = paged_view(cache, pages[0])
    a = cfg.mla
    B, S = x.shape[:2]
    H, dv = cfg.num_heads, a.v_head_dim
    pos_q, ring_m, self_m = _verify_masks(cache["pos"], cur, S, feed_mask, None)
    q_abs, q_pe, ckv_new, kr_new, w_v = _mla_inputs(p, x, cfg, pos_q)
    ckv, krope = cache["ckv"].to(x.dtype), cache["krope"].to(x.dtype)
    scale = (a.qk_nope_dim + a.qk_rope_dim) ** -0.5
    logits_c = (torch.einsum("bjhr,bsr->bhjs", q_abs, ckv)
                + torch.einsum("bjhd,bsd->bhjs", q_pe, krope)).float() * scale
    logits_c = torch.where(ring_m[:, None], logits_c, torch.full_like(logits_c, NEG_INF))
    logits_s = (torch.einsum("bjhr,bnr->bhjn", q_abs, ckv_new)
                + torch.einsum("bjhd,bnd->bhjn", q_pe, kr_new)).float() * scale
    logits_s = torch.where(self_m[:, None], logits_s, torch.full_like(logits_s, NEG_INF))
    w_c, w_s = _joint_softmax(logits_c, logits_s)
    w_c, w_s = w_c.to(x.dtype), w_s.to(x.dtype)
    o_lat = (torch.einsum("bhjs,bsr->bjhr", w_c, ckv)
             + torch.einsum("bhjn,bnr->bjhr", w_s, ckv_new))
    o = torch.einsum("bjhr,rhd->bjhd", o_lat, w_v)
    y = o.reshape(B, S, H * dv) @ p["wo"]
    return y, {"ckv": ckv_new, "krope": kr_new, "pos": pos_q.to(torch.int64)}


def apply_verify_writes(caches: list, updates: list, cur: torch.Tensor,
                        mask: torch.Tensor, pages: tuple | None = None) -> list:
    """Commit an S-position verify step's deferred entries for the
    accepted prefix only, in place: column j writes at position cur + j
    where ``mask[:, j]``, so the ring after a speculative round equals
    sequential decode of the accepted tokens.  With S <= L a row's S
    columns land on distinct slots and go in one write per leaf; a longer
    window writes column by column in ascending j (last write wins, as S
    sequential decode writes would).  With ``pages`` one write per leaf
    always does: ``_paged_targets`` keeps, of the entries that JAX's
    column-by-column writes would overwrite, only the last."""
    S = mask.shape[1]
    cols = torch.arange(S, device=cur.device)
    targets = None if pages is None else _paged_targets(
        pages[0], cur.to(torch.int64)[:, None] + cols, mask, pages[1])
    for cache, upd in zip(caches, updates):
        for name, leaf in cache["self"].items():
            new = upd["self"][name]
            if pages is not None:
                _paged_merge_leaf(leaf, new, targets)
                continue
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
