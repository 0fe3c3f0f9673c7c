"""Glue between the model's tensors and the kernels (port of the ring
paths of ``repro.kernels.ops``).

These adapt model-layer tensors (cache dicts, position arrays) to the
kernels' calling conventions.  Each kernel wrapper picks its own version
from the tensor's device: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor — so the CPU tests run all of this glue.

The decode wrapper takes the deferred-write ``self_entry`` (the current
token's latents) as the kernel's own self-column operands, at bias 0 and
rotated for position ``cur``.  The JAX wrapper appends it to a copy of the
ring instead (``_extend_ring``); the function computed is the same.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.kernels.latent_decode import NEG_INF, latent_decode_attention


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


def latent_decode(q, cache, r_k, cur, *, theta: float, window: int | None,
                  scale: float, self_entry: dict | None = None,
                  k_norm: torch.Tensor | None = None, norm_eps: float = 1e-6):
    """Latent decode over a ring cache dict {"zk", "zv", "pos"}.

    q: (B, H, dh) post-RoPE queries; ``self_entry`` {"zk", "zv"} (B, G, r)
    the current token's latents, scored as one extra column at position
    ``cur``.  Returns (B, H, r_v)."""
    G = cache["zk"].shape[2]
    dh = q.shape[-1]
    pos = cache["pos"]
    cos, sin = rope_tables_for(pos, dh, theta)
    bias = decode_bias(pos, cur, window)
    kw = {}
    if self_entry is not None:
        cos_s, sin_s = rope_tables_for(cur, dh, theta)
        kw = dict(self_zk=self_entry["zk"], self_zv=self_entry["zv"],
                  self_cos=cos_s, self_sin=sin_s)
    o = latent_decode_attention(group_queries(q, G), cache["zk"], cache["zv"],
                                r_k, cos, sin, bias, scale=scale,
                                k_norm=k_norm, norm_eps=norm_eps, **kw)
    return ungroup_outputs(o)


def flash_prefill(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """Full-sequence flash attention for prefill.  q: (B, T, H, dh);
    k: (B, T, Hkv, dh); v: (B, T, Hv, dv) — Hv may be the latent group
    count G.  Arbitrary T (the kernel masks the tail tile)."""
    return flash_prefill_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
