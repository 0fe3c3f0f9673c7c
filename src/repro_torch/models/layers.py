"""Layer primitives of the attention path (port of ``repro.models.layers``).

Plain functions over explicit parameter dicts (row-vector convention,
``y = x @ W``); float32 for softmax and norms, the model dtype for weights
and matmul operands.  ReCalKV attention: key latents are reconstructed
(grouped ``R_k``) before RoPE; value latents are consumed directly through
the fused ``W~_o``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for GPT-NeoX-style rotation.  positions: any shape."""
    half = dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., H, dh) with cos/sin (..., dh/2) broadcast over the H axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def maybe_head_norm(x: torch.Tensor, scale: torch.Tensor | None,
                    eps: float) -> torch.Tensor:
    """Per-head RMSNorm (qk-norm).  x: (..., H, dh), scale: (dh,)."""
    return x if scale is None else rmsnorm(x, scale, eps)


# ---------------------------------------------------------------------------
# Masked softmax attention with latent values (query-chunked)
# ---------------------------------------------------------------------------

def _attend_latent_v(q, k, zv, mask, scale: float, group_size: int):
    """q (B, Tq, Hq, dh), k (B, S, Hkv, dh) reconstructed keys, zv
    (B, S, G, r_v) value latents; mask broadcastable to (B, Hq, Tq, S).
    Returns (B, Tq, Hq, r_v)."""
    B, Tq, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    G = zv.shape[2]
    qr = q.reshape(B, Tq, Hkv, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr, k).float() * scale
    if mask is not None:
        m = torch.broadcast_to(mask, (B, Hq, Tq, S)).reshape(B, Hkv, g, Tq, S)
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(zv.dtype)
    # kv-head (G, s) reads value-group G: fold kv axis -> (G, s*g) query heads
    wg = w.reshape(B, G, group_size * g, Tq, S)
    o = torch.einsum("bGhqs,bsGr->bqGhr", wg, zv)
    return o.reshape(B, Tq, Hq, zv.shape[-1])


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int | None) -> torch.Tensor:
    """(..., Tq, S) boolean mask from absolute positions (-1 = empty slot)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = (kp >= 0) & (kp <= qp)
    if window is not None:
        m &= kp > qp - window
    return m


def chunked_attention(q, k, zv, q_pos, k_pos, *, window, scale, chunk,
                      group_size):
    """Query-chunked latent-value attention: live memory is bounded to
    (B, chunk, S) logits.  A T that ``chunk`` does not divide runs in one
    pass, as in the JAX package."""
    T = q.shape[1]

    def one(qc, qpc):
        m = causal_mask(qpc, k_pos, window)[:, None, :, :]
        return _attend_latent_v(qc, k, zv, m, scale, group_size)

    if T <= chunk or T % chunk:
        return one(q, q_pos)
    return torch.cat([one(q[:, i:i + chunk], q_pos[:, i:i + chunk])
                      for i in range(0, T, chunk)], dim=1)


# ---------------------------------------------------------------------------
# Latent self-attention (full sequence: prefill)
# ---------------------------------------------------------------------------

def reconstruct_keys(zk: torch.Tensor, r_k: torch.Tensor, num_kv_heads: int,
                     d_head: int) -> torch.Tensor:
    """(B, S, G, r_k) x (G, r_k, s*dh) -> (B, S, Hkv, dh)."""
    B, S = zk.shape[:2]
    k = torch.einsum("bsgr,grn->bsgn", zk, r_k)
    return k.reshape(B, S, num_kv_heads, d_head)


def self_attention_latent(p: Params, x: torch.Tensor, cfg: ModelConfig,
                          positions: torch.Tensor, window: int | None,
                          theta: float | None = None):
    """Full-sequence ReCalKV attention.  Returns (y, (zk, zv)) — the latents
    are what prefill writes into the ring cache (pre-RoPE)."""
    B, T, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    s = cfg.recalkv.slots(Hkv)
    q = (x @ p["wq"]).reshape(B, T, H, dh)
    zk = torch.einsum("btd,gdr->btgr", x, p["l_k"])        # (B, T, G, r_k)
    zv = torch.einsum("btd,gdr->btgr", x, p["l_v"])        # (B, T, G, r_v)
    k = torch.einsum("btgr,grn->btgn", zk, p["r_k"]).reshape(B, T, Hkv, dh)
    q = maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    k = maybe_head_norm(k, p.get("k_norm"), cfg.norm_eps)
    cos, sin = rope_tables(positions, dh, theta or cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if cfg.attn_backend == "kernel":
        # Prefill positions are always 0..T-1, the flash kernel's own
        # block-position mask; values stay latent (one group per s kv heads).
        o_lat = kops.flash_prefill(q, k, zv, causal=True, window=window,
                                   scale=dh ** -0.5)
    else:
        o_lat = chunked_attention(q, k, zv, positions, positions,
                                  window=window, scale=dh ** -0.5,
                                  chunk=cfg.attn_chunk, group_size=s)
    return torch.einsum("bthr,hrd->btd", o_lat, p["wo_fused"]), (zk, zv)


# ---------------------------------------------------------------------------
# FFN: dense SwiGLU
# ---------------------------------------------------------------------------

def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
