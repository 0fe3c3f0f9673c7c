"""Layer primitives of the attention path and the recurrent mixers (port
of ``repro.models.layers``).

Plain functions over explicit parameter dicts (row-vector convention,
``y = x @ W``); float32 for softmax and norms, the model dtype for weights
and matmul operands.  Two attention data paths: dense (the paper's
uncompressed baseline: post-RoPE keys and values) and ReCalKV latent (key
latents reconstructed with the grouped ``R_k`` before RoPE; value latents
consumed directly through the fused ``W~_o``).  The dense path is the
latent one's degenerate case (one kv head per value group, values as
their own latents), so both share :func:`chunked_attention`, and so does
DeepSeek's MLA at full sequence (:func:`mla_attention`: one value head per
query head, its value width other than its key width).
"""

from __future__ import annotations

import math
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
                      group_size, causal: bool = True):
    """Query-chunked latent-value attention: live memory is bounded to
    (B, chunk, S) logits.  A T that ``chunk`` does not divide runs in one
    pass, as in the JAX package.  ``causal=False`` (the encoder) masks
    only empty key slots (``k_pos`` -1)."""
    T = q.shape[1]

    def one(qc, qpc):
        if causal:
            m = causal_mask(qpc, k_pos, window)[:, None, :, :]
        else:
            m = (k_pos >= 0)[:, None, None, :]
        return _attend_latent_v(qc, k, zv, m, scale, group_size)

    if T <= chunk or T % chunk:
        return one(q, q_pos)
    return torch.cat([one(q[:, i:i + chunk], q_pos[:, i:i + chunk])
                      for i in range(0, T, chunk)], dim=1)


# ---------------------------------------------------------------------------
# Dense and latent self-attention (full sequence: prefill, calibration)
# ---------------------------------------------------------------------------

def self_attention_dense(p: Params, x: torch.Tensor, cfg: ModelConfig,
                         positions: torch.Tensor, window: int | None,
                         theta: float | None = None, causal: bool = True,
                         use_kernel: bool = True):
    """Full-sequence dense attention.  Returns (y, (k_roped, v)) — the
    pair prefill writes into the ring cache.  ``causal=False`` lets every
    position attend every other (the encoder).  ``use_kernel=False`` keeps
    the einsum path under ``attn_backend="kernel"`` (the calibration
    forward and the encoder, as in the JAX package)."""
    B, T, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, T, H, dh)
    k = (x @ p["wk"]).reshape(B, T, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, T, Hkv, dh)
    q = maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    k = maybe_head_norm(k, p.get("k_norm"), cfg.norm_eps)
    cos, sin = rope_tables(positions, dh, theta or cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if use_kernel and cfg.attn_backend == "kernel":
        # K2 with one value head per kv head (Hv = Hkv, dv = dh).
        o = kops.flash_prefill(q, k, v, causal=causal, window=window,
                               scale=dh ** -0.5)
    else:
        o = chunked_attention(q, k, v, positions, positions, window=window,
                              scale=dh ** -0.5, chunk=cfg.attn_chunk,
                              group_size=1, causal=causal)
    return o.reshape(B, T, H * dh) @ p["wo"], (k, v)


def reconstruct_keys(zk: torch.Tensor, r_k: torch.Tensor, num_kv_heads: int,
                     d_head: int) -> torch.Tensor:
    """(B, S, G, r_k) x (G, r_k, s*dh) -> (B, S, Hkv, dh)."""
    B, S = zk.shape[:2]
    k = torch.einsum("bsgr,grn->bsgn", zk, r_k)
    return k.reshape(B, S, num_kv_heads, d_head)


def self_attention_latent(p: Params, x: torch.Tensor, cfg: ModelConfig,
                          positions: torch.Tensor, window: int | None,
                          theta: float | None = None, use_kernel: bool = True):
    """Full-sequence ReCalKV attention.  Returns (y, (zk, zv)) — the latents
    are what prefill writes into the ring cache (pre-RoPE).  ``use_kernel``
    as for :func:`self_attention_dense`."""
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
    if use_kernel and cfg.attn_backend == "kernel":
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
# Cross-attention (VLM / encoder-decoder): static source keys, no RoPE
# ---------------------------------------------------------------------------

def cross_attention_dense(p: Params, x: torch.Tensor,
                          source_kv: tuple[torch.Tensor, torch.Tensor],
                          cfg: ModelConfig) -> torch.Tensor:
    """x (B, T, d) attends every source position; source_kv = (k, v),
    each (B, S, Hkv, dh).  Serves prefill, decode and verify alike: the
    token axis is just a query axis."""
    B, T, _ = x.shape
    H, dh = cfg.num_heads, cfg.d_head
    k, v = source_kv
    q = (x @ p["wq"]).reshape(B, T, H, dh)
    q = maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    o = _attend_latent_v(q, k, v, None, dh ** -0.5, 1)
    return o.reshape(B, T, H * dh) @ p["wo"]


def cross_attention_latent(p: Params, x: torch.Tensor,
                           source_latents: tuple[torch.Tensor, torch.Tensor],
                           cfg: ModelConfig) -> torch.Tensor:
    """Latent cross-attention with key absorption: cross keys carry no
    RoPE, so the reconstruction commutes with the score product and
    ``q' = q R_k^T`` scores against ``zk`` directly (keys are never
    rebuilt); values stay latent through ``wo_fused``.  source_latents =
    (zk (B, S, G, r_k), zv (B, S, G, r_v))."""
    B, T, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    zk, zv = source_latents
    G = zk.shape[2]
    s, g = Hkv // G, H // Hkv
    rank_k, rank_v = zk.shape[-1], zv.shape[-1]
    q = (x @ p["wq"]).reshape(B, T, H, dh)
    q = maybe_head_norm(q, p.get("q_norm"), cfg.norm_eps)
    r_k = p["r_k"].reshape(G, rank_k, s, dh)
    qg = q.reshape(B, T, G, s, g, dh)
    q_abs = torch.einsum("btGsgd,Grsd->btGsgr", qg, r_k)
    logits = torch.einsum("btGsgr,bSGr->bGsgtS", q_abs, zk).float()
    w = torch.softmax(logits * dh ** -0.5, dim=-1).to(zv.dtype)
    o_lat = torch.einsum("bGsgtS,bSGr->btGsgr", w, zv).reshape(B, T, H, rank_v)
    return torch.einsum("bthr,hrd->btd", o_lat, p["wo_fused"])


def make_cross_source_dense(p: Params, source: torch.Tensor, cfg: ModelConfig):
    """The source's cross keys (k-normed, no RoPE) and values, each
    (B, S, Hkv, dh): what a dense cross cache holds."""
    B, S, _ = source.shape
    k = (source @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.d_head)
    v = (source @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.d_head)
    return maybe_head_norm(k, p.get("k_norm"), cfg.norm_eps), v


def make_cross_source_latent(p: Params, source: torch.Tensor, cfg: ModelConfig):
    """The source's key and value latents (B, S, G, r): what a latent
    cross cache holds."""
    zk = torch.einsum("bsd,gdr->bsgr", source, p["l_k"])
    zv = torch.einsum("bsd,gdr->bsgr", source, p["l_v"])
    return zk, zv


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): a trained-from-scratch latent KV cache, served as it is
# ---------------------------------------------------------------------------

def mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor):
    """Full-sequence MLA (prefill), the non-absorbed form: per-head keys
    (dn no-RoPE + dr RoPE columns, the RoPE half shared by all heads) and
    values (dv) rebuilt from the latent ``c_kv``, attended at scale
    (dn + dr)^-0.5.  Returns (y, (c_kv, k_pe)) — the latent and the
    post-RoPE shared key columns the cache holds."""
    a = cfg.mla
    B, T, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = a.qk_nope_dim, a.qk_rope_dim, a.v_head_dim
    q_lat = rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(B, T, H, dn + dr)
    kv_a = x @ p["wkv_a"]                                  # (B, T, r_kv + dr)
    c_kv = rmsnorm(kv_a[..., :a.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = kv_a[..., a.kv_lora_rank:].reshape(B, T, 1, dr)
    kv = (c_kv @ p["wkv_b"]).reshape(B, T, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_pe = apply_rope(q[..., dn:], cos, sin)
    k_pe = apply_rope(k_rope, cos, sin)                    # (B, T, 1, dr)
    q_full = torch.cat([q[..., :dn], q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe.expand(B, T, H, dr)], dim=-1)
    # one value "group" per head: the latent-value core with group_size 1
    o = chunked_attention(q_full, k_full, v, positions, positions, window=None,
                          scale=(dn + dr) ** -0.5, chunk=cfg.attn_chunk,
                          group_size=1)
    return o.reshape(B, T, H * dv) @ p["wo"], (c_kv, k_pe[:, :, 0])


# ---------------------------------------------------------------------------
# FFN: dense SwiGLU & capacity-routed MoE
# ---------------------------------------------------------------------------

def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def _expert_positions(sel: torch.Tensor, num_experts: int) -> torch.Tensor:
    """GShard-style position-in-expert: every first choice before every
    second choice, each in token order.  sel: (N, k) -> pos (N, k) int64.

    The JAX package counts with a cumulative sum over (N, E) one-hots per
    choice; here a stable sort of the choices in that order (choice-major,
    then token) by expert gives the same integers: a choice's position is
    its rank among its expert's choices.  Static shapes, no (N, E)
    tensors."""
    N, k = sel.shape
    flat = sel.t().reshape(-1)                        # choice-major, then token
    by_expert, order = torch.sort(flat, stable=True)
    start = torch.searchsorted(by_expert, torch.arange(num_experts, device=sel.device))
    rank = torch.arange(N * k, device=sel.device) - start[by_expert]
    return torch.empty_like(rank).scatter_(0, order, rank).reshape(k, N).t()


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Capacity-dispatched top-k MoE (port of the JAX ``moe_ffn``).

    Tokens gather into an (E, cap, d) buffer, ``cap`` from this call's own
    N = B * T, and choices past an expert's capacity go to a sink (dropped).
    The expert products are batched matmuls over that buffer, as the JAX
    package leaves its einsums to XLA.  The combine gathers each token's k
    slots and adds them in ascending expert order, the order of XLA's CPU
    scatter-add, in the working dtype: no atomics, so a sync call and a
    replayed CUDA graph give the same bits, and every shape is static (no
    ``nonzero``, masks or ``.item()``), so ``aot=True`` captures it.  The
    load-balance and router z-loss terms are for training (ROADMAP.md
    Queue 1 item 6) and are not computed here."""
    m = cfg.moe
    B, T, d = x.shape
    N = B * T
    E, k = m.num_experts, m.top_k
    cap = max(8, int(math.ceil(N * k / E * m.capacity_factor / 8.0)) * 8)

    xt = x.reshape(N, d)
    logits = xt.float() @ p["router"]                       # (N, E) f32
    probs = torch.softmax(logits, dim=-1)
    w, sel = torch.topk(probs, k, dim=-1)                   # (N, k)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)

    pos = _expert_positions(sel, E)                         # (N, k)
    slot = torch.where(pos < cap, sel * cap + pos, E * cap)  # overflow -> sink
    flat = slot.reshape(-1)
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    # token, fill and weight of each expert slot (row E * cap: the sink)
    token_for_slot = torch.zeros(E * cap + 1, dtype=torch.long, device=x.device)
    token_for_slot.index_put_((flat,), tok)
    filled = torch.zeros(E * cap + 1, dtype=torch.bool, device=x.device)
    filled.index_put_((flat,), torch.ones_like(flat, dtype=torch.bool))
    w_for_slot = torch.zeros(E * cap + 1, dtype=torch.float32, device=x.device)
    w_for_slot.index_put_((flat,), w.reshape(-1))

    buf = xt[token_for_slot[:E * cap]]                       # (E * cap, d)
    buf.masked_fill_(~filled[:E * cap, None], 0)
    buf = buf.reshape(E, cap, d)
    h = torch.bmm(buf, p["wg"])
    hi = torch.bmm(buf, p["wi"])
    del buf
    # expert outputs times their weights, and a zero sink row: what each
    # token's k slots read (a dropped choice reads the sink)
    contrib = torch.empty((E * cap + 1, d), dtype=x.dtype, device=x.device)
    torch.bmm(F.silu(h) * hi, p["wo"], out=contrib[:E * cap].view(E, cap, d))
    contrib[:E * cap] *= (w_for_slot[:E * cap] * filled[:E * cap]).to(x.dtype)[:, None]
    contrib[E * cap] = 0

    order = torch.sort(sel, dim=-1).indices                 # each token's experts, ascending
    slots = torch.gather(slot, 1, order)
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[slots[:, j]]
    if m.num_shared:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(B, T, d)


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
        dense: bool = False) -> torch.Tensor:
    """The block's FFN: the routed MoE where the config has one, unless
    ``dense`` (the ``attn_dense`` blocks: DeepSeek's first-k-dense
    layers), else the dense SwiGLU."""
    if cfg.moe is not None and not dense:
        return moe_ffn(p, x, cfg)
    return swiglu(p, x)


# ---------------------------------------------------------------------------
# Recurrent mixers: Mamba-1 (falcon-mamba) and RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------
#
# Plain PyTorch on every device: the JAX package computes both outside any
# Pallas kernel (``jax.lax.associative_scan``).  The f32 casts sit where
# JAX has them (dt, B, C, A, h and the RG-LRU gates); the rest runs in the
# model dtype.

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor | None = None):
    """Depthwise causal conv.  x (B, T, C), w (K, C), b (C,).  Returns (y,
    new_state): the state carries the last K-1 inputs for streaming
    decode (a copy: a view would hold the whole padded input alive in the
    prefill's cache).  Taps are summed in order, as the JAX package's
    ``sum``."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, T+K-1, C)
    y = xp[:, :T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    return y + b, xp[:, T:].clone()


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1, from h_{-1} = 0, as a
    log-depth doubling over time (k = 1, 2, 4, ...: b[t] += a[t] b[t-k],
    then a[t] *= a[t-k]); every step is a few whole-tensor ops, so a long
    prefill launches O(log T) of them, not O(T).  Returns every h_t, in
    ``b`` (updated in place: the callers pass a fresh tensor)."""
    T = a.shape[1]
    k = 1
    while k < T:
        b[:, k:] += a[:, k:] * b[:, :-k]
        if 2 * k < T:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def _ssm_chunk_scan(decay: torch.Tensor, drive: torch.Tensor, h0: torch.Tensor):
    """The scan of h_t = decay_t * h_{t-1} + drive_t within a chunk.
    decay / drive (B, Tc, d, n) f32, h0 (B, d, n).  The initial state is a
    prepended pseudo-step of decay 1, as in the JAX package.  Returns
    (h_all (B, Tc, d, n), h_last (B, d, n), a copy: it outlives the
    chunk's steps)."""
    a = torch.cat([torch.ones_like(decay[:, :1]), decay], dim=1)
    hh = _linear_scan(a, torch.cat([h0[:, None], drive], dim=1))
    return hh[:, 1:], hh[:, -1].clone()


def mamba_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Params | None = None, chunk: int = 128):
    """Mamba-1 block (port of the JAX ``mamba_mixer``).  x (B, T, d).
    Returns (y, new state {"h": (B, d_inner, d_state) f32, "conv": (B,
    d_conv - 1, d_inner)}).  The selective scan runs over chunks of
    ``chunk`` steps in order when T is a multiple of it past one chunk,
    else over T at once (T 1: one step), the JAX package's rule."""
    B, T, _ = x.shape
    di, ds, dtr = cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba_dt_rank
    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    xc, new_conv = _causal_conv1d(xin, p["conv_w"], p["conv_b"],
                                  None if state is None else state["conv"])
    xc = F.silu(xc)
    dbc = xc @ p["x_proj"]
    dt = _softplus(dbc[..., :dtr] @ p["dt_proj"] + p["dt_bias"]).float()
    Bm = dbc[..., dtr:dtr + ds].float()                     # (B, T, ds)
    Cm = dbc[..., dtr + ds:].float()                        # (B, T, ds)
    A = -torch.exp(p["A_log"].float())                      # (di, ds)
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
         if state is None else state["h"].float())

    def step_chunk(h, xc_c, dt_c, B_c, C_c):
        decay = torch.exp(dt_c[..., None] * A)              # (B, Tc, di, ds)
        drive = (dt_c * xc_c.float())[..., None] * B_c[:, :, None, :]
        h_all, h_new = _ssm_chunk_scan(decay, drive, h)
        return h_new, torch.einsum("btdn,btn->btd", h_all, C_c)

    if T % chunk == 0 and T > chunk:
        ys = []
        for s in range(0, T, chunk):
            c = slice(s, s + chunk)
            h, y_c = step_chunk(h, xc[:, c], dt[:, c], Bm[:, c], Cm[:, c])
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
    else:
        h, y = step_chunk(h, xc, dt, Bm, Cm)
    y = y.to(x.dtype) + xc * p["D"].to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out.to(x.dtype), {"h": h, "conv": new_conv}


_RGLRU_C = 8.0


def rglru_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Params | None = None):
    """Gated linear recurrent unit block (port of the JAX ``rglru_mixer``).
    x (B, T, d).  Returns (y, new state {"h": (B, W) f32, "conv": (B,
    conv_width - 1, W)}).  The gate's GELU is the tanh form, JAX's
    default."""
    B, T, _ = x.shape
    W = cfg.lru_width
    main = x @ p["in_main"]                                 # (B, T, W)
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    main, new_conv = _causal_conv1d(main, p["conv_w"], p["conv_b"],
                                    None if state is None else state["conv"])
    rg = torch.sigmoid(main @ p["w_a"]).float()             # recurrence gate
    ig = torch.sigmoid(main @ p["w_x"]).float()             # input gate
    a = torch.exp(-_RGLRU_C * _softplus(p["a_param"].float()) * rg)
    drive = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (ig * main.float())
    h0 = (torch.zeros((B, W), dtype=torch.float32, device=x.device)
          if state is None else state["h"].float())
    if T == 1:
        hs = (a[:, 0] * h0 + drive[:, 0])[:, None]
    else:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        hs = _linear_scan(a, torch.cat([h0[:, None], drive], dim=1))[:, 1:]
    y = (hs.to(x.dtype) * gate) @ p["out_proj"]
    return y, {"h": hs[:, -1].clone(), "conv": new_conv}
