"""Glue between the model's tensors and the kernels (port of the ring and
paged-pool paths of ``repro.kernels.ops``).

These adapt model-layer tensors (cache dicts, position arrays) to the
kernels' calling conventions.  Each kernel wrapper picks its own version
from the tensor's device: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor — so the CPU tests run all of this glue.

The decode wrapper takes the deferred-write ``self_entry`` (the current
token's latents) as the kernel's own self-column operands, at bias 0 and
rotated for position ``cur``; the verify wrapper takes the nq verify-window
entries the same way, rotated at ``cur + j``.  The JAX wrappers append them
to a copy of the ring instead (``_extend_ring``, ``_extend_ring_mq``); the
function computed is the same.  A cache dict with ``zk_q`` is the int8
ring: it routes to K3 / K6 with its scales, a float ring to K1 / K5.

The paged wrappers take a page-major float pool {"zk", "zv", "pos"}
(n_pages, page_size, ...) and a (B, n_sp) page table: the positions are
gathered through the table (int32-cheap) to build slot-major bias and
rotation tables, while the latents stay page-major and are read by K4 / K7
through the table.  The int8 pool does not come here: the model reads it
through the gathered view (``kv_cache.paged_view``) with K3 / K6, as the
JAX package does.

The dense cache {"k", "v", "pos"} has kernels of its own, the dense cores
of K1 / K4 (decode, ``dense_decode`` / ``dense_decode_paged`` ->
``csrc/dense_decode.cu``, or ``csrc/dense_verify.cu``'s m16 tensor-core
body at 8-16 query rows a kv head) and of K5 / K7 (verify, ``dense_decode_mq`` /
``dense_decode_mq_paged`` -> ``csrc/dense_verify.cu``): keys stored after
RoPE, so no key rebuild, no rotation tables and no k-norm.  The JAX
package's ``_dense_*_core*`` run K1 / K4 / K5 / K7 at an identity ``R_k``
instead; the function computed is the same.

On a mesh (``mesh`` with more than one "model" rank; see
``launch.mesh``) the cache a wrapper gets is this rank's sequence slice:
ring columns, or each pool page's in-page offsets (the page table stays
global), as ``sharding.rules.CACHE_RULES`` lays it out.  Each rank calls
its kernel on its slice with ``return_lse`` and the full (replicated)
queries; the self columns score on the last "model" rank only (JAX's
``_mask_self_cols``); and the partial softmaxes merge by log-sum-exp over
"model" in two all-reduces, a max and a sum (JAX's
``_merge_partial_softmax``).  A rank whose rows see no column has l = 0
and drops out.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dense_decode import (
    dense_decode_attention, dense_decode_attention_mq,
    dense_decode_attention_mq_paged, dense_decode_attention_paged)
from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.kernels.latent_decode import (
    NEG_INF, gather_pages, latent_decode_attention, latent_decode_attention_mq,
    latent_decode_attention_mq_paged, latent_decode_attention_paged, softmax_state)
from repro_torch.kernels.latent_decode_q import (
    latent_decode_attention_mq_quant, latent_decode_attention_quant)


def merge_partial_softmax(o, m, l, combine):
    """Log-sum-exp merge of partial flash outputs: each part's o = acc / l
    at running max m (o (..., rows, r), m and l (..., rows) float32);
    reweight by l * exp(m - max m) and renormalise, flooring the sum at
    1e-30 as JAX does.  ``combine(t, op)`` reduces ``t`` over the parts
    with op "max" or "sum": two all-reduces over a mesh axis, or a
    reduction over a stacked dim."""
    mg = combine(m, "max")
    w = l * torch.exp(m - mg)
    both = combine(torch.cat([o.float() * w[..., None], w[..., None]], dim=-1), "sum")
    num, den = both[..., :-1], both[..., -1:]
    return (num / den.clamp(min=1e-30)).to(o.dtype)


def merge_over_mesh(parts, mesh):
    """Merge this rank's (o, m, l) with the other "model" ranks'."""
    return merge_partial_softmax(*parts, lambda t, op: mesh.all_reduce(t, "model", op))


def merge_stacked(o, m, l):
    """Merge partials stacked along dim 0 (the shards of one process):
    the mesh's merge with its collectives as reductions over dim 0."""
    def combine(t, op):
        return t.amax(dim=0) if op == "max" else t.sum(dim=0)
    return merge_partial_softmax(o, m, l, combine)


def merge_einsum(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, mesh):
    """An einsum reader's float32 partial output ``o`` (..., rows, r),
    weighted by its :func:`softmax_merge` weights, merged over "model"."""
    return merge_over_mesh((o, m, l), mesh)


def softmax_merge(logits: torch.Tensor, dtype, mesh):
    """An einsum reader's softmax over the last axis of float32 ``logits``
    (masked with NEG_INF) and the merge of the output it weights:
    (weights, finish), ``finish(o)`` taking o (..., rows, r) whose rows
    are the logits' leading dims in their order.  Off a sequence-sharded
    mesh: the softmax in ``dtype``, ``finish`` the identity.  On one:
    this rank's partial softmax over its columns in the kernels'
    ``return_lse`` contract (a row masked everywhere has weights 0, m =
    NEG_INF and l = 0, so it drops out of the merge), in float32; the
    reader casts its values to the weights' dtype, so its partial output
    stays float32 through :func:`merge_einsum` and ``finish`` rounds the
    merged output to ``dtype`` once (no rank's part is rounded before
    the parts are summed)."""
    if not seq_sharded(mesh):
        return torch.softmax(logits, dim=-1).to(dtype), lambda o: o
    w, m, l = softmax_state(logits, logits.amax(dim=-1) <= 0.5 * NEG_INF)

    def finish(o):
        rows = o.shape[:-1]
        return merge_einsum(o, m.reshape(rows), l.reshape(rows), mesh).to(dtype)
    return w, finish


def seq_sharded(mesh) -> bool:
    """Whether the cache is sequence-sharded over more than one "model"
    rank."""
    return mesh is not None and mesh.shape.get("model", 1) > 1


def seq_local(cache: dict, mesh) -> dict:
    """This rank's sequence slice of every leaf of a ring (or pool) dict.
    ``CACHE_RULES`` shard ``pos`` and the float latents over "model" but
    leave the int8 ring's latents and scales whole on every rank (JAX's
    kernel call reshards them to its ring slice); each leaf wider than
    ``pos`` is cut here to the same columns (or page offsets)."""
    if not seq_sharded(mesh):
        return cache
    w, m = cache["pos"].shape[1], mesh.axis_index("model")
    return {k: v if v.shape[1] == w else v.narrow(1, m * w, w) for k, v in cache.items()}


def self_on(mesh) -> bool:
    """The self columns score on the last "model" rank only."""
    return mesh.axis_index("model") == mesh.shape["model"] - 1


def decode_bias(pos: torch.Tensor, cur: torch.Tensor,
                window: int | None) -> torch.Tensor:
    """Additive (B, S) float32 mask from stored slot positions and the
    current position."""
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window is not None:
        valid &= pos > (cur[:, None] - window)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def rope_tables_for(pos: torch.Tensor, dh: int, theta: float):
    """cos/sin (..., dh/2) float32 for stored (clamped) positions."""
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=pos.device) / half)
    ang = pos.clamp(min=0).to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def group_queries(q: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(B, H, dh) -> (B, G, Hg, dh) in kernel head order (kv-major)."""
    B, H, dh = q.shape
    return q.reshape(B, num_groups, H // num_groups, dh)


def ungroup_outputs(o: torch.Tensor) -> torch.Tensor:
    """(B, G, Hg, rv) -> (B, H, rv)."""
    B, G, Hg, rv = o.shape
    return o.reshape(B, G * Hg, rv)


def group_queries_mq(q: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(B, nq, H, dh) -> (B, G, nq*Hg, dh), rows ordered (query, head) —
    the multi-query kernels' row layout."""
    B, nq, H, dh = q.shape
    hg = H // num_groups
    q = q.reshape(B, nq, num_groups, hg, dh)
    return q.transpose(1, 2).reshape(B, num_groups, nq * hg, dh)


def ungroup_outputs_mq(o: torch.Tensor, nq: int) -> torch.Tensor:
    """(B, G, nq*Hg, rv) -> (B, nq, H, rv)."""
    B, G, QHg, rv = o.shape
    hg = QHg // nq
    o = o.reshape(B, G, nq, hg, rv)
    return o.transpose(1, 2).reshape(B, nq, G * hg, rv)


def verify_bias(pos_ext: torch.Tensor, pos_q: torch.Tensor,
                feed_mask: torch.Tensor, window: int | None,
                self_start: int) -> torch.Tensor:
    """Additive (B, nq, S_ext) mask for nq verify queries over the columns
    [ring | self].  The self columns store pos_q, so causality and the
    window fall out of the stored-position compare; ``feed_mask`` is then
    AND'd onto the nq self columns at ``self_start``."""
    nq = pos_q.shape[1]
    valid = (pos_ext[:, None, :] >= 0) & (pos_ext[:, None, :] <= pos_q[:, :, None])
    if window is not None:
        valid &= pos_ext[:, None, :] > (pos_q[:, :, None] - window)
    sl = slice(self_start, self_start + nq)
    valid[:, :, sl] &= feed_mask[:, None, :].to(torch.bool)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def rotation_tables(pos: torch.Tensor, dh: int, theta: float | None):
    """Rotation tables for stored positions: RoPE at ``theta``, or the
    identity (cos 1, sin 0) for ``theta=None`` — dense keys are stored
    after RoPE, so the kernel must not rotate them again."""
    if theta is not None:
        return rope_tables_for(pos, dh, theta)
    cos = torch.ones(tuple(pos.shape) + (dh // 2,), dtype=torch.float32,
                     device=pos.device)
    return cos, torch.zeros_like(cos)


def _ring_operands(cache: dict, entry: dict | None):
    """(ring latents, self latents, quantized) keyword split for a float
    or int8 latent ring; ``entry`` holds the self latents in the ring's
    layout."""
    e = entry or {}
    if "zk_q" in cache:
        ring = (cache["zk_q"], cache["zk_s"], cache["zv_q"], cache["zv_s"])
        selfs = dict(self_zk_q=e.get("zk_q"), self_zk_s=e.get("zk_s"),
                     self_zv_q=e.get("zv_q"), self_zv_s=e.get("zv_s"))
        return ring, selfs, True
    return (cache["zk"], cache["zv"]), dict(self_zk=e.get("zk"),
                                            self_zv=e.get("zv")), False


def _decode(q, cache, r_k, cur, ptab, *, theta, window, scale, self_entry,
            k_norm, norm_eps, mesh=None):
    sharded = seq_sharded(mesh)
    if sharded and not self_on(mesh):
        self_entry = None
    cache = seq_local(cache, mesh)
    ring, selfs, quant = _ring_operands(cache, self_entry)
    if quant and ptab is not None:
        raise ValueError("an int8 pool is read through kv_cache.paged_view")
    G = ring[0].shape[2]
    dh = q.shape[-1]
    pos = cache["pos"] if ptab is None else gather_pages(cache["pos"], ptab)
    cos, sin = rotation_tables(pos, dh, theta)
    bias = decode_bias(pos, cur, window)
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, return_lse=sharded)
    if self_entry is not None:
        cos_s, sin_s = rotation_tables(cur, dh, theta)
        kw.update(selfs, self_cos=cos_s, self_sin=sin_s)
    qg = group_queries(q, G)
    if ptab is not None:
        o = latent_decode_attention_paged(ptab, qg, *ring, r_k, cos, sin, bias,
                                          **kw)
    elif quant:
        o = latent_decode_attention_quant(qg, *ring, r_k, cos, sin, bias, **kw)
    else:
        o = latent_decode_attention(qg, *ring, r_k, cos, sin, bias, **kw)
    return ungroup_outputs(merge_over_mesh(o, mesh) if sharded else o)


def latent_decode(q, cache, r_k, cur, *, theta: float, window: int | None,
                  scale: float, self_entry: dict | None = None,
                  k_norm: torch.Tensor | None = None, norm_eps: float = 1e-6,
                  mesh=None):
    """Latent decode over a ring cache dict — float {"zk", "zv", "pos"} or
    int8 {"zk_q", "zk_s", "zv_q", "zv_s", "pos"}.

    q: (B, H, dh) post-RoPE queries; ``self_entry`` the current token's
    latents in the ring's layout, scored as one extra column at position
    ``cur``.  ``mesh``: the ring is this rank's sequence slice (module
    docstring).  Returns (B, H, r_v)."""
    return _decode(q, cache, r_k, cur, None, theta=theta, window=window,
                   scale=scale, self_entry=self_entry, k_norm=k_norm,
                   norm_eps=norm_eps, mesh=mesh)


def latent_decode_paged(q, cache, ptab, r_k, cur, *, theta: float,
                        window: int | None, scale: float,
                        self_entry: dict | None = None,
                        k_norm: torch.Tensor | None = None,
                        norm_eps: float = 1e-6, mesh=None):
    """Latent decode over a page-major float pool {"zk", "zv", "pos"}
    (n_pages, page_size, ...) through ``ptab`` (B, n_sp) int32, with K4.
    Arguments otherwise as :func:`latent_decode`.  Returns (B, H, r_v)."""
    return _decode(q, cache, r_k, cur, ptab, theta=theta, window=window,
                   scale=scale, self_entry=self_entry, k_norm=k_norm,
                   norm_eps=norm_eps, mesh=mesh)


def _mask_self_cols(bias: torch.Tensor, mesh, start: int) -> torch.Tensor:
    """Mask the self columns (from ``start``) off on every "model" rank but
    the last, so each scores once across the mesh."""
    if seq_sharded(mesh) and not self_on(mesh):
        bias = bias.clone()
        bias[..., start:] = NEG_INF
    return bias


def _decode_mq(q, cache, r_k, cur, feed_mask, self_entries, ptab, *, theta,
               window, scale, k_norm, norm_eps, mesh=None):
    B, nq = feed_mask.shape
    cache = seq_local(cache, mesh)
    ring, selfs, quant = _ring_operands(cache, self_entries)
    if quant and ptab is not None:
        raise ValueError("an int8 pool is read through kv_cache.paged_view")
    G = ring[0].shape[2]
    dh = q.shape[-1]
    pos = cache["pos"] if ptab is None else gather_pages(cache["pos"], ptab)
    pos_q = cur[:, None] + torch.arange(nq, dtype=cur.dtype, device=cur.device)
    cos, sin = rotation_tables(pos, dh, theta)
    cos_s, sin_s = rotation_tables(pos_q, dh, theta)
    bias = verify_bias(torch.cat([pos, pos_q.to(pos.dtype)], dim=1), pos_q,
                       feed_mask, window, pos.shape[1])
    bias = _mask_self_cols(bias, mesh, pos.shape[1])
    sharded = seq_sharded(mesh)
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_cos=cos_s,
              self_sin=sin_s, return_lse=sharded, **selfs)
    qg = group_queries_mq(q, G)
    if ptab is not None:
        o = latent_decode_attention_mq_paged(ptab, qg, *ring, r_k, cos, sin,
                                             bias, **kw)
    elif quant:
        o = latent_decode_attention_mq_quant(qg, *ring, r_k, cos, sin, bias, **kw)
    else:
        o = latent_decode_attention_mq(qg, *ring, r_k, cos, sin, bias, **kw)
    return ungroup_outputs_mq(merge_over_mesh(o, mesh) if sharded else o, nq)


def latent_decode_mq(q, cache, r_k, cur, feed_mask, self_entries, *,
                     theta: float, window: int | None, scale: float,
                     k_norm: torch.Tensor | None = None,
                     norm_eps: float = 1e-6, mesh=None):
    """Multi-query (verify-step) latent decode over a float or int8 ring.

    q: (B, nq, H, dh) queries rotated at positions cur..cur+nq-1;
    feed_mask: (B, nq) bool, which candidate tokens were fed;
    self_entries: the nq verify-window latents in the ring's layout at
    leading shape (B, nq, ...), scored as nq self columns.  One kernel
    call scores all nq queries.  Returns (B, nq, H, r_v)."""
    return _decode_mq(q, cache, r_k, cur, feed_mask, self_entries, None,
                      theta=theta, window=window, scale=scale, k_norm=k_norm,
                      norm_eps=norm_eps, mesh=mesh)


def latent_decode_mq_paged(q, cache, ptab, r_k, cur, feed_mask, self_entries,
                           *, theta: float, window: int | None, scale: float,
                           k_norm: torch.Tensor | None = None,
                           norm_eps: float = 1e-6, mesh=None):
    """Multi-query latent decode over a page-major float pool through
    ``ptab``, with K7.  Arguments otherwise as :func:`latent_decode_mq`.
    Returns (B, nq, H, r_v)."""
    return _decode_mq(q, cache, r_k, cur, feed_mask, self_entries, ptab,
                      theta=theta, window=window, scale=scale, k_norm=k_norm,
                      norm_eps=norm_eps, mesh=mesh)


def _dense(q, cache, ptab, cur, *, window, scale, self_entry, mesh):
    sharded = seq_sharded(mesh)
    e = {} if self_entry is None or (sharded and not self_on(mesh)) else self_entry
    pos = cache["pos"] if ptab is None else gather_pages(cache["pos"], ptab)
    kw = dict(scale=scale, self_k=e.get("k"), self_v=e.get("v"), return_lse=sharded)
    qg = group_queries(q, cache["k"].shape[2])
    bias = decode_bias(pos, cur, window)
    o = (dense_decode_attention(qg, cache["k"], cache["v"], bias, **kw) if ptab is None
         else dense_decode_attention_paged(ptab, qg, cache["k"], cache["v"], bias, **kw))
    return ungroup_outputs(merge_over_mesh(o, mesh) if sharded else o)


def dense_decode(q, cache, cur, *, window: int | None, scale: float,
                 self_entry: dict | None = None, mesh=None):
    """Dense ring decode through K1's dense core (``kernels.dense_decode``:
    ``csrc/dense_decode.cu``, or ``csrc/dense_verify.cu`` from 8 rows).
    q: (B, H, dh) post-RoPE; cache {"k", "v": (B, S, Hkv, dh), "pos"};
    ``self_entry`` {"k", "v": (B, Hkv, dh)}, the current token post-RoPE
    (and k-norm), scored as one extra column at position ``cur``.
    ``mesh`` as for :func:`latent_decode`.  Returns (B, H, dh)."""
    return _dense(q, cache, None, cur, window=window, scale=scale,
                  self_entry=self_entry, mesh=mesh)


def dense_decode_paged(q, cache, ptab, cur, *, window: int | None,
                       scale: float, self_entry: dict | None = None, mesh=None):
    """Dense decode over page-major {"k", "v", "pos"} pools through
    ``ptab``, with K4's dense core (the ring's kernel through the page
    table; the bias is slot-major, from the gathered positions).  Returns
    (B, H, dh)."""
    return _dense(q, cache, ptab, cur, window=window, scale=scale,
                  self_entry=self_entry, mesh=mesh)


def _dense_mq(q, cache, ptab, cur, feed_mask, self_entries, *, window, scale,
              mesh=None):
    nq = feed_mask.shape[1]
    pos = cache["pos"] if ptab is None else gather_pages(cache["pos"], ptab)
    pos_q = cur[:, None] + torch.arange(nq, dtype=cur.dtype, device=cur.device)
    bias = verify_bias(torch.cat([pos, pos_q.to(pos.dtype)], dim=1), pos_q,
                       feed_mask, window, pos.shape[1])
    bias = _mask_self_cols(bias, mesh, pos.shape[1])
    sharded = seq_sharded(mesh)
    qg = group_queries_mq(q, cache["k"].shape[2])
    kw = dict(scale=scale, self_k=self_entries["k"], self_v=self_entries["v"],
              return_lse=sharded)
    if ptab is None:
        o = dense_decode_attention_mq(qg, cache["k"], cache["v"], bias, **kw)
    else:
        o = dense_decode_attention_mq_paged(ptab, qg, cache["k"], cache["v"], bias,
                                            **kw)
    return ungroup_outputs_mq(merge_over_mesh(o, mesh) if sharded else o, nq)


def dense_decode_mq(q, cache, cur, feed_mask, self_entries, *,
                    window: int | None, scale: float, mesh=None):
    """Multi-query dense verify over the ring with K5's dense core
    (``csrc/dense_verify.cu``).  q (B, nq, H, dh) and
    ``self_entries["k"]`` (B, nq, Hkv, dh) arrive rotated at
    cur..cur+nq-1; ``feed_mask`` (B, nq) says which candidates were fed.
    Returns (B, nq, H, dh)."""
    return _dense_mq(q, cache, None, cur, feed_mask, self_entries,
                     window=window, scale=scale, mesh=mesh)


def dense_decode_mq_paged(q, cache, ptab, cur, feed_mask, self_entries, *,
                          window: int | None, scale: float, mesh=None):
    """Multi-query dense verify over page-major pools through ``ptab``,
    with K7's dense core (the ring's kernel through the page table; the
    bias is slot-major, from the gathered positions).  Returns (B, nq, H,
    dh)."""
    return _dense_mq(q, cache, ptab, cur, feed_mask, self_entries,
                     window=window, scale=scale, mesh=mesh)


def flash_prefill(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """Full-sequence flash attention for prefill.  q: (B, T, H, dh);
    k: (B, T, Hkv, dh); v: (B, T, Hv, dv) — Hv may be the latent group
    count G.  Arbitrary T (the kernel masks the tail tile)."""
    return flash_prefill_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
