"""Dense, latent and MLA KV caches — ring or paged pool — with their
decode and verify readers, and the recurrent state of the mixers (port of
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

A cross-attention layer also holds ``{"cross": ...}``: the source's keys
and values ``{"k", "v": (B, S_src, Hkv, dh)}`` (dense) or latents ``{"zk",
"zv": (B, S_src, G, r)}``, written once by prefill and static after it
(every writer below leaves it as it is; always ``cfg.dtype``, never
int8).  A ``cross`` layer has no ``"self"``; an ``attn_cross`` layer has
both.

A recurrent layer holds ``{"state": {"h", "conv"}}``: Mamba's ``h`` (B,
d_inner, d_state) and RG-LRU's ``h`` (B, W) in float32, and the last K-1
conv inputs ``conv`` (B, K-1, width) in ``cfg.dtype`` (float under
``cache_quant_bits`` too), as in the JAX package.  A decode step replaces
the state whole (:func:`apply_decode_writes`); it has no positions, so
it takes neither the pool nor speculation.

Deferred writes: the decode reader scores the current token as an extra
self column and returns its entry; :func:`apply_decode_writes` writes all
layers' entries once, after the layer loop.  The verify reader (S tokens,
speculative decoding) returns (B, S, ...) entries, and
:func:`apply_verify_writes` commits only the accepted prefix.  Unlike the
JAX package (whose arrays are immutable) these writes update the ring
tensors IN PLACE.

On a mesh (``mesh`` with more than one "model" rank) every leaf is this
rank's slice by ``sharding.rules.CACHE_RULES``: a ring's or a cross
source's positions, a pool page's offsets, a recurrent state's channels.
The kernel readers merge in ``kernels.ops``; the einsum readers here
(MLA's, the cross readers, the einsum backend's) do the same in einsum
form: each scores its columns, the self and verify-window columns on the
last "model" rank only, and the partial softmaxes merge by log-sum-exp
(``kops.softmax_merge``).  A recurrent state is
gathered whole over "model" where it is read and each rank keeps its
channels of the new one.

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
from repro_torch.models.config import RECURRENT_KINDS, ModelConfig
from repro_torch.quant import dequantize, quantize
from repro_torch.sharding import rules as R

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


def init_cross_cache(cfg: ModelConfig, batch: int, device) -> Params:
    """Empty cross leaves (batch, cross_source_len, ...) in ``cfg.dtype``:
    the source's keys and values, or their latents at the uniform ranks."""
    S = cfg.cross_source_len
    rt = cfg.recalkv
    z = lambda *sh: torch.zeros(sh, dtype=cfg.dtype, device=device)
    if rt is None:
        return {"k": z(batch, S, cfg.num_kv_heads, cfg.d_head),
                "v": z(batch, S, cfg.num_kv_heads, cfg.d_head)}
    G = rt.num_groups(cfg.num_kv_heads)
    return {"zk": z(batch, S, G, rt.rank_k), "zv": z(batch, S, G, rt.rank_v)}


def init_state_cache(cfg: ModelConfig, kind: str, batch: int, device) -> Params:
    """A recurrent layer's empty state (zeros), ``batch`` rows."""
    if kind == "mamba":
        di, ds, K = cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba.d_conv
    elif kind == "rglru":
        di, ds, K = cfg.lru_width, None, cfg.rglru.conv_width
    else:
        raise ValueError(kind)
    h_shape = (batch, di) if ds is None else (batch, di, ds)
    return {"h": torch.zeros(h_shape, dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, K - 1, di), dtype=cfg.dtype, device=device)}


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device, layer_idx: int | None = None) -> Params:
    if kind in RECURRENT_KINDS:
        return {"state": init_state_cache(cfg, kind, batch, device)}
    if kind == "cross":
        return {"cross": init_cross_cache(cfg, batch, device)}
    out = {"self": init_self_cache(cfg, kind, batch, max_len, device,
                                   layer_idx=layer_idx)}
    if kind == "attn_cross":
        out["cross"] = init_cross_cache(cfg, batch, device)
    return out


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


def _seq_shard(mesh) -> tuple[int, int]:
    """(this rank's "model" index, "model" ranks): a mesh's rings hold
    columns [m * L, (m + 1) * L) of the full ring, its pools the same
    slice of each page's offsets (``sharding.rules.CACHE_RULES``)."""
    if mesh is None:
        return 0, 1
    return mesh.axis_index("model"), mesh.axis_size("model")


def _own_targets(targets, ps_local: int, mesh):
    """``_paged_targets``' (page, offset, writes) of the full page size,
    cut to this rank's offsets: entries at another rank's offsets write
    nothing (they target the null page at their local offset)."""
    page, off, ok = targets
    m, n = _seq_shard(mesh)
    if n == 1:
        return targets
    ok = ok & (torch.div(off, ps_local, rounding_mode="floor") == m)
    return torch.where(ok, page, 0), off % ps_local, ok


def _leaf_mesh(name: str, mesh):
    """The mesh a ring or pool leaf's writes are sharded by: ``mesh`` for
    a leaf ``CACHE_RULES`` split by position over "model" (the engine
    refuses ring lengths and page sizes that do not split), None for one
    they keep whole on every "model" rank (the int8 ring's, see
    ``kernels.ops.seq_local``), which every rank writes in full."""
    if mesh is None or ("model", 1) not in R.CACHE_RULES.get(name, ()):
        return None
    return mesh


def model_slice(full: torch.Tensor, name: str, mesh) -> torch.Tensor:
    """This rank's slice of a FULL cache leaf ``name`` (a prefill's ring,
    pool tiles or cross source, a recurrent state) along the dim
    ``CACHE_RULES`` split over "model"; ``full`` itself off a mesh or
    where the rules keep the leaf whole."""
    if not kops.seq_sharded(mesh):
        return full
    d = R.cache_model_dim(name, full.shape, full.dtype, mesh)
    if d is None:
        return full
    n = full.shape[d] // mesh.axis_size("model")
    return full.narrow(d, mesh.axis_index("model") * n, n)


def read_state(cfg: ModelConfig, kind: str, state: Params, mesh) -> Params:
    """A recurrent layer's state as its mixer reads it: whole; on a mesh
    each leaf this rank holds is its channel slice, gathered over "model"
    along the dim ``CACHE_RULES`` split (the write keeps this rank's
    slice of the new state, :func:`apply_decode_writes`)."""
    if not kops.seq_sharded(mesh):
        return state
    full = init_state_cache(cfg, kind, 1, "meta")
    out = {}
    for name, leaf in state.items():
        d = R.cache_model_dim(name, full[name].shape, full[name].dtype, mesh)
        out[name] = leaf if d is None else mesh.all_gather(leaf, "model", dim=d)
    return out


def _pool_writes_of_all_slots(mesh, pages, cur, mask, updates):
    """A pool is whole on every "data" rank, so each takes every data
    rank's writes: (pages, cur, mask, updates) with the slot rows of every
    data rank, gathered over "data" in slot order; unchanged off a mesh
    of more than one data rank or on the ring."""
    if pages is None or mesh is None or mesh.axis_size("data") == 1:
        return pages, cur, mask, updates
    cur, mask, ptab = (None if t is None else mesh.all_gather(t, "data")
                       for t in (cur, mask, pages[0]))
    updates = [{part: {k: mesh.all_gather(v, "data") for k, v in leaves.items()}
                for part, leaves in u.items()} for u in updates]
    return (ptab, pages[1]), cur, mask, updates


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


def _joint_softmax(logits_c: torch.Tensor, logits_s: torch.Tensor, dtype, mesh=None):
    """Softmax over [ring columns | self columns]: logits_c (..., S_ring),
    logits_s (..., S_new).  Returns (w_c, w_s, finish): the weights, and
    ``finish(o)`` the merge of the output they weight, as
    ``kops.softmax_merge`` gives them.  Off a mesh without concatenating,
    the weights in ``dtype`` and ``finish`` the identity; on one, this
    rank's partial softmax, the self columns scoring on the last "model"
    rank only (``kops.self_on``)."""
    if kops.seq_sharded(mesh):
        if not kops.self_on(mesh):
            logits_s = torch.full_like(logits_s, NEG_INF)
        n = logits_c.shape[-1]
        w, finish = kops.softmax_merge(torch.cat([logits_c, logits_s], dim=-1), dtype, mesh)
        return w[..., :n], w[..., n:], finish
    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True),
                      logits_s.amax(dim=-1, keepdim=True))
    e_c = torch.exp(logits_c - m)
    e_s = torch.exp(logits_s - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s.sum(dim=-1, keepdim=True)
    return (e_c / denom).to(dtype), (e_s / denom).to(dtype), lambda o: o


def kernel_fallback_kinds(cfg: ModelConfig) -> list[str]:
    """Layer kinds that take the einsum path even under
    ``attn_backend="kernel"`` (JAX's ``pallas_fallback_kinds``, for the
    kinds the port serves): the absorbed-MLA readers score in the c_kv
    latent space, with no kernel, so an MLA model lists every kind it has;
    cross-attention reads a static source cache through einsum (an
    ``attn_cross`` layer for its cross half).  The engine warns once when
    this list is non-empty, so a requested kernel backend never degrades
    silently.  Mixer kinds (mamba / rglru) have no attention and do not
    count."""
    kinds = sorted(set(cfg.expanded_layers()) - set(RECURRENT_KINDS))
    if cfg.mla is not None:
        return kinds
    return [k for k in kinds if k in ("cross", "attn_cross")]


def _pool_route(cfg: ModelConfig, cache: Params, pages, mesh=None):
    """(cache, ptab) for a dense or latent reader: the float pool under the
    kernel backend stays page-major for K4 / K7; every other reader
    (einsum, and the int8 kernels) reads the gathered slot-major view, as
    in the JAX package.  The MLA readers take no kernel and always read
    the view (:func:`decode_attn_mla`)."""
    if pages is None:
        return cache, None
    if cfg.attn_backend == "kernel" and cfg.cache_quant_bits is None:
        return cache, pages[0]
    return paged_view(kops.seq_local(cache, mesh), pages[0]), None


def decode_attn_dense(p: Params, x: torch.Tensor, cache: Params,
                      cfg: ModelConfig, cur: torch.Tensor,
                      window: int | None, theta: float | None = None,
                      pages: tuple | None = None, mesh=None):
    """Dense decode: the new token's post-RoPE key and value enter the
    softmax as a self column and come back as the deferred update.
    ``pages`` = (ptab, page_size) reads a page-major pool.  Returns
    (y (B, 1, d), deferred update {"k", "v", "pos"})."""
    cache, ptab = _pool_route(cfg, cache, pages, mesh)
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
                  self_entry={"k": k_new, "v": v_new}, mesh=mesh)
        o = (kops.dense_decode(q[:, 0], cache, cur, **kw) if ptab is None
             else kops.dense_decode_paged(q[:, 0], cache, ptab, cur, **kw))
        return o.to(x.dtype).reshape(B, 1, H * dh) @ p["wo"], updates

    qr = q[:, 0].reshape(B, Hkv, g, dh)
    k_c = cache["k"].to(x.dtype)
    logits_c = torch.einsum("bkgd,bskd->bkgs", qr, k_c).float() * scale
    mask = _decode_mask(cache["pos"], cur, window)[:, None, None, :]
    logits_c = torch.where(mask, logits_c, torch.full_like(logits_c, NEG_INF))
    logits_s = (torch.einsum("bkgd,bkd->bkg", qr, k_new).float() * scale)[..., None]
    w_c, w_s, finish = _joint_softmax(logits_c, logits_s, x.dtype, mesh)
    o = finish(torch.einsum("bkgs,bskd->bkgd", w_c, cache["v"].to(w_c.dtype))
               + w_s * v_new[:, :, None, :])
    return o.reshape(B, 1, H * dh) @ p["wo"], updates


def decode_attn_latent(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cur: torch.Tensor,
                       window: int | None, theta: float | None = None,
                       pages: tuple | None = None, mesh=None):
    """ReCalKV decode: reconstruct keys from the latent ring, RoPE by stored
    positions, keep values latent, project through the fused W~_o.
    ``pages`` = (ptab, page_size) reads a page-major pool.  Returns
    (y (B, 1, d), deferred update {"zk", "zv", "pos"})."""
    cache, ptab = _pool_route(cfg, cache, pages, mesh)
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
                  k_norm=p.get("k_norm"), norm_eps=cfg.norm_eps, mesh=mesh)
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
    w_c, w_s, finish = _joint_softmax(logits_c, logits_s, x.dtype, mesh)
    w_c = w_c.reshape(B, G, s * g, -1)
    w_s = w_s.reshape(B, G, s * g, 1)
    o_lat = finish(torch.einsum("bGhs,bsGr->bGhr", w_c, zv_c.to(w_c.dtype))
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
                    pages: tuple | None = None, mesh=None):
    """Absorbed MLA decode: scores and outputs are computed in the c_kv
    latent space (q_nope through ``wkv_b``'s key columns, the output through
    its value columns), so no per-head key or value is ever built.  The
    new token's entry is a self column and comes back as the deferred
    update.  No kernel: a pool is read through its gathered view, as in
    the JAX package (never page-major, whatever the backend).  On a
    ``mesh`` the latent output merges over "model" before the value
    columns' product (r_kv floats a row, not H * dv).  Returns (y (B, 1,
    d), deferred update {"ckv", "krope", "pos"})."""
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
    w_c, w_s, finish = _joint_softmax(logits_c, logits_s, x.dtype, mesh)
    o_lat = finish(torch.einsum("bhs,bsr->bhr", w_c, ckv.to(w_c.dtype))
                   + w_s * ckv_new[:, None, :])
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_v)
    y = o.reshape(B, 1, H * dv) @ p["wo"]
    return y, {"ckv": ckv_new, "krope": kr_new, "pos": cur.to(torch.int64)}


def _merge_leaf(cache_leaf: torch.Tensor, upd: torch.Tensor,
                cur: torch.Tensor, active: torch.Tensor | None, mesh=None) -> None:
    """Write one slot entry per row at ``cur % L``, in place; rows with
    ``active`` False are left untouched.  On a mesh the leaf holds this
    rank's ring columns (``_seq_shard``): a row writes only where it owns
    the column."""
    B, Lr = cache_leaf.shape[:2]
    rows = torch.arange(B, device=cache_leaf.device)
    slot = cur.to(torch.int64) % Lr
    m, n = _seq_shard(mesh)
    if n > 1:
        slot = cur.to(torch.int64) % (Lr * n)
        own = torch.div(slot, Lr, rounding_mode="floor") == m
        active = own if active is None else active & own
        slot = slot % Lr
    new = upd.to(cache_leaf.dtype)
    if active is not None:
        new = torch.where(active.reshape((B,) + (1,) * (new.ndim - 1)),
                          new, cache_leaf[rows, slot])
    cache_leaf[rows, slot] = new


def apply_decode_writes(caches: list, updates: list, cur: torch.Tensor,
                        active: torch.Tensor | None = None,
                        pages: tuple | None = None, mesh=None) -> list:
    """Merge the deferred per-layer decode entries into the rings (or,
    with ``pages``, the pools), in place (one pass after the layer loop);
    a recurrent layer's new state replaces its state whole (on a mesh,
    its channel slice).  ``active`` (B,) bool freezes the rows of
    inactive sequences entirely.  On a
    ``mesh`` each rank writes the entries whose column (or page offset)
    it holds; a pool, whole on every "data" rank, takes every data
    rank's slots' entries (gathered over "data")."""
    pages, cur, active, updates = _pool_writes_of_all_slots(mesh, pages, cur, active,
                                                            updates)
    targets = None if pages is None else _paged_targets(
        pages[0], cur.to(torch.int64)[:, None], None if active is None else active[:, None],
        pages[1])
    for cache, upd in zip(caches, updates):
        for name, leaf in cache.get("state", {}).items():
            new = model_slice(upd["state"][name], name, mesh).to(leaf.dtype)
            if active is not None:
                new = torch.where(active.reshape((-1,) + (1,) * (leaf.dim() - 1)), new, leaf)
            leaf.copy_(new)
        for name, leaf in cache.get("self", {}).items():
            lmesh = _leaf_mesh(name, mesh)
            if pages is None:
                _merge_leaf(leaf, upd["self"][name], cur, active, lmesh)
            else:
                _paged_merge_leaf(leaf, upd["self"][name][:, None],
                                  _own_targets(targets, leaf.shape[1], lmesh))
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
                      pages: tuple | None = None, mesh=None):
    """Dense S-token verify: the S fresh post-RoPE keys and values are a
    causal self block.  Returns (y (B, S, d), deferred entries with (B,
    S, ...) leaves and "pos" (B, S))."""
    cache, ptab = _pool_route(cfg, cache, pages, mesh)
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
        kw = dict(window=window, scale=scale, mesh=mesh)
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
    w_c, w_s, finish = _joint_softmax(logits_c, logits_s, x.dtype, mesh)
    o = finish(torch.einsum("bkgjs,bskd->bkgjd", w_c, cache["v"].to(w_c.dtype))
               + torch.einsum("bkgjn,bnkd->bkgjd", w_s, v_new.to(w_s.dtype)))
    o = o.permute(0, 3, 1, 2, 4)
    return o.reshape(B, S, H * dh) @ p["wo"], updates


def verify_attn_latent(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cur: torch.Tensor,
                       feed_mask: torch.Tensor, window: int | None,
                       theta: float | None = None,
                       pages: tuple | None = None, mesh=None):
    """ReCalKV S-token verify: cached keys reconstructed and rotated by
    stored position, fresh latents as a causal self block, values latent
    through the fused W~_o.  ``pages`` as for :func:`decode_attn_latent`.
    Returns (y (B, S, d), deferred entries with (B, S, ...) leaves and
    "pos" (B, S))."""
    cache, ptab = _pool_route(cfg, cache, pages, mesh)
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
                  k_norm=p.get("k_norm"), norm_eps=cfg.norm_eps, mesh=mesh)
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
    w_c, w_s, finish = _joint_softmax(logits_c, logits_s, x.dtype, mesh)
    Lr = zk_c.shape[1]
    w_cg = w_c.reshape(B, G, s * g, S, Lr)
    w_sg = w_s.reshape(B, G, s * g, S, S)
    o_lat = finish(torch.einsum("bGhjs,bsGr->bGhjr", w_cg, zv_c.to(w_cg.dtype))
                   + torch.einsum("bGhjn,bnGr->bGhjr", w_sg, zv_self.to(w_sg.dtype)))
    o_lat = o_lat.permute(0, 3, 1, 2, 4).reshape(B, S, H, -1)
    return torch.einsum("bjhr,hrd->bjd", o_lat, p["wo_fused"]), updates


def verify_attn_mla(p: Params, x: torch.Tensor, cache: Params,
                    cfg: ModelConfig, cur: torch.Tensor,
                    feed_mask: torch.Tensor, pages: tuple | None = None,
                    mesh=None):
    """Absorbed-MLA S-token verify: :func:`decode_attn_mla`'s latent-space
    scores over the ring plus a causal block over the S fresh entries
    (``mesh`` as there).  Returns (y (B, S, d), deferred entries with (B,
    S, ...) leaves and "pos" (B, S))."""
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
    w_c, w_s, finish = _joint_softmax(logits_c, logits_s, x.dtype, mesh)
    o_lat = finish(torch.einsum("bhjs,bsr->bhjr", w_c, ckv.to(w_c.dtype))
                   + torch.einsum("bhjn,bnr->bhjr", w_s, ckv_new.to(w_s.dtype)))
    o_lat = o_lat.transpose(1, 2)
    o = torch.einsum("bjhr,rhd->bjhd", o_lat, w_v)
    y = o.reshape(B, S, H * dv) @ p["wo"]
    return y, {"ckv": ckv_new, "krope": kr_new, "pos": pos_q.to(torch.int64)}


def apply_verify_writes(caches: list, updates: list, cur: torch.Tensor,
                        mask: torch.Tensor, pages: tuple | None = None,
                        mesh=None) -> list:
    """Commit an S-position verify step's deferred entries for the
    accepted prefix only, in place: column j writes at position cur + j
    where ``mask[:, j]``, so the ring after a speculative round equals
    sequential decode of the accepted tokens.  With S <= L a row's S
    columns land on distinct slots and go in one write per leaf; a longer
    window writes column by column in ascending j (last write wins, as S
    sequential decode writes would).  With ``pages`` one write per leaf
    always does: ``_paged_targets`` keeps, of the entries that JAX's
    column-by-column writes would overwrite, only the last.  On a
    ``mesh`` as :func:`apply_decode_writes`; a ring writes column by
    column there (a row's columns on different ranks may share a local
    index)."""
    pages, cur, mask, updates = _pool_writes_of_all_slots(mesh, pages, cur, mask, updates)
    S = mask.shape[1]
    cols = torch.arange(S, device=cur.device)
    targets = None if pages is None else _paged_targets(
        pages[0], cur.to(torch.int64)[:, None] + cols, mask, pages[1])
    for cache, upd in zip(caches, updates):
        for name, leaf in cache.get("self", {}).items():
            new = upd["self"][name]
            lmesh = _leaf_mesh(name, mesh)
            if pages is not None:
                _paged_merge_leaf(leaf, new, _own_targets(targets, leaf.shape[1], lmesh))
                continue
            B, Lr = leaf.shape[:2]
            if S > Lr or _seq_shard(lmesh)[1] > 1:
                for j in range(S):
                    _merge_leaf(leaf, new[:, j], cur + j, mask[:, j], lmesh)
                continue
            rows = torch.arange(B, device=leaf.device)[:, None]
            slots = (cur.to(torch.int64)[:, None] + cols) % Lr          # (B, S)
            m = mask.reshape(mask.shape + (1,) * (new.ndim - 2))
            leaf[rows, slots] = torch.where(m, new.to(leaf.dtype), leaf[rows, slots])
    return caches


def invalidate_positions(caches: list, cur: torch.Tensor,
                         mask: torch.Tensor, mesh=None) -> list:
    """Mark the ring entry at position ``cur`` empty (pos = -1) in every
    layer, in place, for rows where ``mask``: retires a draft model's
    entries for rejected proposals, which it wrote as it proposed.  On a
    ``mesh`` the rank holding the column marks it."""
    for cache in caches:
        if "self" not in cache:
            continue
        pos = cache["self"]["pos"]
        _merge_leaf(pos, torch.full_like(cur, -1, dtype=pos.dtype), cur, mask,
                    _leaf_mesh("pos", mesh))
    return caches


# ---------------------------------------------------------------------------
# Cross-attention readers (the static source cache; einsum, as in JAX)
# ---------------------------------------------------------------------------

def _cross_mesh(cache: Params, cfg: ModelConfig, mesh):
    """``mesh`` where ``CACHE_RULES`` split the cross source's positions
    over "model" (:func:`model_slice` cut each rank's slice), else None:
    every rank holds the whole source."""
    if not kops.seq_sharded(mesh):
        return None
    name, leaf = next(iter(cache.items()))
    full = (leaf.shape[0], cfg.cross_source_len) + tuple(leaf.shape[2:])
    return None if R.cache_model_dim(name, full, leaf.dtype, mesh) is None else mesh


def decode_cross_dense(p: Params, x: torch.Tensor, cache: Params,
                       cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Cross-attention of a decode (x (B, 1, d)) or verify (x (B, S, d))
    step over the dense cross cache: the source is static, so the token
    axis is just a query axis and nothing is written.  On a ``mesh`` each
    rank scores its source slice and the softmaxes merge over "model"
    (no self column, no mask)."""
    return L.cross_attention_dense(
        p, x, (cache["k"].to(x.dtype), cache["v"].to(x.dtype)), cfg,
        mesh=_cross_mesh(cache, cfg, mesh))


def decode_cross_latent(p: Params, x: torch.Tensor, cache: Params,
                        cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """As :func:`decode_cross_dense` over the latent cross cache (key
    absorption, values through ``wo_fused``)."""
    return L.cross_attention_latent(
        p, x, (cache["zk"].to(x.dtype), cache["zv"].to(x.dtype)), cfg,
        mesh=_cross_mesh(cache, cfg, mesh))
