"""Glue between the model's tensors and the kernels (port of the ring
paths of ``repro.kernels.ops``).

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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.kernels.latent_decode import (NEG_INF, latent_decode_attention,
                                               latent_decode_attention_mq)
from repro_torch.kernels.latent_decode_q import (
    latent_decode_attention_mq_quant, latent_decode_attention_quant)


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


def _ring_operands(cache: dict, entry: dict | None):
    """(ring latents, self latents, kernel) keyword split for a float or
    int8 ring; ``entry`` holds the self latents in the ring's layout."""
    e = entry or {}
    if "zk_q" in cache:
        ring = (cache["zk_q"], cache["zk_s"], cache["zv_q"], cache["zv_s"])
        selfs = dict(self_zk_q=e.get("zk_q"), self_zk_s=e.get("zk_s"),
                     self_zv_q=e.get("zv_q"), self_zv_s=e.get("zv_s"))
        return ring, selfs, True
    return (cache["zk"], cache["zv"]), dict(self_zk=e.get("zk"),
                                            self_zv=e.get("zv")), False


def latent_decode(q, cache, r_k, cur, *, theta: float, window: int | None,
                  scale: float, self_entry: dict | None = None,
                  k_norm: torch.Tensor | None = None, norm_eps: float = 1e-6):
    """Latent decode over a ring cache dict — float {"zk", "zv", "pos"} or
    int8 {"zk_q", "zk_s", "zv_q", "zv_s", "pos"}.

    q: (B, H, dh) post-RoPE queries; ``self_entry`` the current token's
    latents in the ring's layout, scored as one extra column at position
    ``cur``.  Returns (B, H, r_v)."""
    ring, selfs, quant = _ring_operands(cache, self_entry)
    G = ring[0].shape[2]
    dh = q.shape[-1]
    pos = cache["pos"]
    cos, sin = rope_tables_for(pos, dh, theta)
    bias = decode_bias(pos, cur, window)
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps)
    if self_entry is not None:
        cos_s, sin_s = rope_tables_for(cur, dh, theta)
        kw.update(selfs, self_cos=cos_s, self_sin=sin_s)
    kernel = latent_decode_attention_quant if quant else latent_decode_attention
    o = kernel(group_queries(q, G), *ring, r_k, cos, sin, bias, **kw)
    return ungroup_outputs(o)


def latent_decode_mq(q, cache, r_k, cur, feed_mask, self_entries, *,
                     theta: float, window: int | None, scale: float,
                     k_norm: torch.Tensor | None = None,
                     norm_eps: float = 1e-6):
    """Multi-query (verify-step) latent decode over a float or int8 ring.

    q: (B, nq, H, dh) queries rotated at positions cur..cur+nq-1;
    feed_mask: (B, nq) bool, which candidate tokens were fed;
    self_entries: the nq verify-window latents in the ring's layout at
    leading shape (B, nq, ...), scored as nq self columns.  One kernel
    call scores all nq queries.  Returns (B, nq, H, r_v)."""
    B, nq = feed_mask.shape
    ring, selfs, quant = _ring_operands(cache, self_entries)
    G = ring[0].shape[2]
    dh = q.shape[-1]
    pos = cache["pos"]
    pos_q = cur[:, None] + torch.arange(nq, dtype=cur.dtype, device=cur.device)
    cos, sin = rope_tables_for(pos, dh, theta)
    cos_s, sin_s = rope_tables_for(pos_q, dh, theta)
    bias = verify_bias(torch.cat([pos, pos_q.to(pos.dtype)], dim=1), pos_q,
                       feed_mask, window, pos.shape[1])
    kernel = (latent_decode_attention_mq_quant if quant
              else latent_decode_attention_mq)
    o = kernel(group_queries_mq(q, G), *ring, r_k, cos, sin, bias, scale=scale,
               k_norm=k_norm, norm_eps=norm_eps, self_cos=cos_s,
               self_sin=sin_s, **selfs)
    return ungroup_outputs_mq(o, nq)


def flash_prefill(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """Full-sequence flash attention for prefill.  q: (B, T, H, dh);
    k: (B, T, Hkv, dh); v: (B, T, Hv, dv) — Hv may be the latent group
    count G.  Arbitrary T (the kernel masks the tail tile)."""
    return flash_prefill_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
