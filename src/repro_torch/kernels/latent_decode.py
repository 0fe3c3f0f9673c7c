"""K1 and K5 — ReCalKV latent-ring flash decode and its multi-query form:
CUDA kernels, plain versions, wrappers.

K1 replaces ``src/repro/kernels/latent_decode.py::latent_decode_attention``
and K5 ``latent_decode_attention_mq`` (the Pallas TPU kernels).  Both come
from one templated kernel in ``csrc/latent_decode.cu`` (with K3 and K6 of
``latent_decode_q``); its header says what bounds it on an H100 and how
the design answers it (S split into chunks with an LSE merge for
parallelism, R_k streamed per head slot, keys never written to device
memory).

Shapes (as in the JAX kernels):
  q      (B, G, Hg, dh)   post-RoPE grouped queries, Hg = s * q_per_kv;
                          K5: (B, G, nq*Hg, dh), rows ordered (query, head)
  zk     (B, S, G, r_k)   pre-RoPE key latents      zv (B, S, G, r_v)
  r_k    (G, r_k, s*dh)   key reconstruction factors
  cos/sin (B, S, dh/2) f32 rotation tables of the stored positions
  bias   (B, S) f32       additive mask (0 valid / -1e30 masked);
                          K5: (B, nq, S_ext), one row per query
  k_norm (dh,) f32        optional per-head RMSNorm scale (1 + k_norm)
  out    (B, G, Hg, r_v)  latent attention outputs, q's dtype (K5: nq*Hg rows)

Beyond the JAX signatures, the deferred-write tokens may be passed as
their own operands instead of being appended to a copy of the ring:
K1's ``self_zk`` (B, G, r_k), ``self_zv`` (B, G, r_v), ``self_cos`` /
``self_sin`` (B, dh/2) are one extra column at bias 0; K5's (B, nq, G, r)
latents and (B, nq, dh/2) tables are nq extra columns whose bias is the
last nq columns of ``bias`` (S_ext = S + nq).  Either way the function is
that of the appended ring.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_SB = 32                 # key tile of the CUDA kernel (tokens)
_SMEM_LIMIT = 232448     # bytes of shared memory a Hopper block may use


def _rotate(k, cos, sin):
    """k: (..., S, s, dh); cos/sin: (..., S, dh/2) broadcast over s."""
    half = k.shape[-1] // 2
    k1, k2 = k[..., :half], k[..., half:]
    c, s_ = cos[..., None, :], sin[..., None, :]
    return torch.cat([k1 * c - k2 * s_, k2 * c + k1 * s_], dim=-1)


def latent_decode_attention_plain(q, zk, zv, r_k, cos, sin, bias, *, scale,
                                  k_norm=None, norm_eps=1e-6, self_zk=None,
                                  self_zv=None, self_cos=None, self_sin=None):
    """Plain PyTorch version of K1 (port of ``repro.kernels.ref`` plus
    k_norm and the self column), in float32: K5's plain version with one
    query, the self column at bias 0.  Like the kernel, a row whose bias
    is masked everywhere returns exact 0."""
    if self_zk is not None:
        bias = torch.cat([bias, bias.new_zeros(bias.shape[0], 1)], dim=1)
        self_zk, self_zv, self_cos, self_sin = (
            t[:, None] for t in (self_zk, self_zv, self_cos, self_sin))
    return latent_decode_attention_mq_plain(
        q, zk, zv, r_k, cos, sin, bias[:, None], scale=scale, k_norm=k_norm,
        norm_eps=norm_eps, self_zk=self_zk, self_zv=self_zv, self_cos=self_cos,
        self_sin=self_sin)


def latent_decode_attention_mq_plain(q, zk, zv, r_k, cos, sin, bias, *,
                                     scale, k_norm=None, norm_eps=1e-6,
                                     self_zk=None, self_zv=None,
                                     self_cos=None, self_sin=None):
    """Plain PyTorch version of K5, in float32: every one of the nq
    queries scores the same reconstructed keys under its own bias row.  A
    (query, head) row whose bias is masked everywhere returns exact 0."""
    if self_zk is not None:
        zk = torch.cat([zk, self_zk.to(zk.dtype)], dim=1)
        zv = torch.cat([zv, self_zv.to(zv.dtype)], dim=1)
        cos = torch.cat([cos, self_cos], dim=1)
        sin = torch.cat([sin, self_sin], dim=1)
    B, G, QH, dh = q.shape
    nq = bias.shape[1]
    Hg = QH // nq
    S = zk.shape[1]
    s = r_k.shape[-1] // dh
    qpk = Hg // s
    k = torch.einsum("bsgr,grn->bsgn", zk.float(), r_k.float())
    k = k.reshape(B, S, G, s, dh)
    if k_norm is not None:
        ms = (k * k).mean(dim=-1, keepdim=True)
        k = k * torch.rsqrt(ms + norm_eps) * (1.0 + k_norm.float())
    k = _rotate(k.transpose(1, 2), cos.float()[:, None], sin.float()[:, None])
    qg = q.float().reshape(B, G, nq, s, qpk, dh)
    logits = torch.einsum("bgjsqd,bgtsd->bgjsqt", qg, k) * scale
    logits = logits + bias.float()[:, None, :, None, None, :]
    w = torch.softmax(logits, dim=-1)
    dead = bias.max(dim=-1).values <= NEG_INF * 0.5           # (B, nq)
    w = torch.where(dead[:, None, :, None, None, None], torch.zeros_like(w), w)
    o = torch.einsum("bgjsqt,btgr->bgjsqr", w, zv.float())
    return o.reshape(B, G, QH, zv.shape[-1]).to(q.dtype)


_PTR = ctypes.c_void_p
# (is_bf16, dh), 20 pointers, 12 ints, (scale, eps), stream — one argument
# list for all four entry points (see csrc/latent_decode.cu).
_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [_PTR] * 20 + [ctypes.c_int] * 12
             + [ctypes.c_float, ctypes.c_float, _PTR])
ENTRY_POINTS = ("recalkv_latent_decode", "recalkv_latent_decode_quant",
                "recalkv_latent_decode_mq", "recalkv_latent_decode_mq_quant")


def _lib():
    lib = build.load("latent_decode")
    if not lib.recalkv_latent_decode.argtypes:
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.recalkv_latent_decode_smem.argtypes = [ctypes.c_int] * 7
        lib.recalkv_latent_decode_smem.restype = ctypes.c_longlong
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(entry: str, q, zk, zv, r_k, cos, sin, bias, scale, k_norm,
           norm_eps, self_zk, self_zv, self_cos, self_sin, *, nq: int = 1,
           scales=(None, None, None, None)):
    """Check the operands and launch one of the four kernels of
    ``csrc/latent_decode.cu`` (the caller counts the launch).  ``zk``/``zv``
    (and the self latents) are q's dtype, or int8 with ``scales`` =
    (zk_scale, zv_scale, self_zk_scale, self_zv_scale) float32."""
    B, G, QH, dh = q.shape
    S, rk, rv = zk.shape[1], zk.shape[3], zv.shape[3]
    s = r_k.shape[-1] // dh
    Hg = QH // nq
    dt = q.dtype
    quant = scales[0] is not None
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"latent decode kernel takes bf16 or f32, got {dt}")
    lat_dt = torch.int8 if quant else dt
    selfs = [self_zk, self_zv] if self_zk is not None else []
    if any(t.dtype != lat_dt for t in [zk, zv] + selfs) or r_k.dtype != dt:
        raise TypeError(f"zk, zv and the self latents must be {lat_dt}, "
                        f"r_k {dt}")
    f32 = [cos, sin, bias] + [t for t in (k_norm, self_cos, self_sin, *scales)
                              if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("cos, sin, bias, k_norm, scales and the self tables "
                        "must be float32")
    # K1/K3 take one self column as (B, G, r); K5/K6 take (B, n_self, G, r)
    n_self = (0 if self_zk is None
              else 1 if self_zk.dim() == 3 else self_zk.shape[1])
    bias_cols = bias.shape[-1]
    if dh not in (64, 128) or QH % nq or Hg % s or r_k.shape != (G, rk, s * dh):
        raise ValueError(f"unsupported shapes: q {tuple(q.shape)}, "
                         f"r_k {tuple(r_k.shape)} (dh must be 64 or 128)")
    if bias_cols not in (S, S + n_self) or (nq > 1 and bias_cols != S + n_self):
        raise ValueError(f"bias {tuple(bias.shape)} does not cover the ring "
                         f"({S}) and {n_self} self columns")
    lib = _lib()
    is_bf16 = int(dt == torch.bfloat16)
    smem = lib.recalkv_latent_decode_smem(is_bf16, int(quant), dh, QH, nq, rk, rv)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"latent decode tile needs {smem} B of shared memory "
                         f"(limit {_SMEM_LIMIT}) at {QH} rows, r_k={rk}, "
                         f"r_v={rv}")
    dev = q.device
    c = lambda t: None if t is None else t.contiguous()
    ptrs = [c(t) for t in (q, zk, zv, scales[0], scales[1], r_k, cos, sin,
                           bias, k_norm, self_zk, self_zv, scales[2],
                           scales[3], self_cos, self_sin)]
    # Chunk S (+ the self columns) into about 8 blocks per SM: a block's
    # chunk is its serial critical path, and chunks over empty ring
    # regions finish at once, so short chunks keep the SMs busy whatever
    # part of the ring is filled.
    s_ext = S + n_self
    n_tiles = -(-s_ext // _SB)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, min(n_tiles, -(-8 * sms // (B * G))))
    chunk_len = -(-n_tiles // want) * _SB
    n_chunks = -(-s_ext // chunk_len)
    part_acc = torch.empty((B, G, n_chunks, QH, rv), device=dev, dtype=torch.float32)
    part_m = torch.empty((B, G, n_chunks, QH), device=dev, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    out = torch.empty((B, G, QH, rv), device=dev, dtype=dt)
    err = getattr(lib, entry)(
        is_bf16, dh, *[_ptr(t) for t in ptrs],
        _ptr(part_acc), _ptr(part_m), _ptr(part_l), _ptr(out),
        B, S, G, Hg, rk, rv, s, nq, n_self, bias_cols, n_chunks, chunk_len,
        float(scale), float(norm_eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, entry)
    return out


def _on_device(name: str, q) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises — no fallback."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    return True


def latent_decode_attention(q, zk, zv, r_k, cos, sin, bias, *, scale,
                            k_norm=None, norm_eps=1e-6, self_zk=None,
                            self_zv=None, self_cos=None, self_sin=None):
    """K1.  A CPU tensor runs the plain version; a CUDA tensor runs the
    CUDA kernel (built at first use) or raises — there is no fallback.
    ``latent_decode_attention.launches`` counts kernel launches."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_zk=self_zk,
              self_zv=self_zv, self_cos=self_cos, self_sin=self_sin)
    if not _on_device("latent decode", q):
        return latent_decode_attention_plain(q, zk, zv, r_k, cos, sin, bias, **kw)
    out = launch("recalkv_latent_decode", q, zk, zv, r_k, cos, sin, bias, scale,
                 k_norm, norm_eps, self_zk, self_zv, self_cos, self_sin)
    latent_decode_attention.launches += 1
    return out


def latent_decode_attention_mq(q, zk, zv, r_k, cos, sin, bias, *, scale,
                               k_norm=None, norm_eps=1e-6, self_zk=None,
                               self_zv=None, self_cos=None, self_sin=None):
    """K5: nq = bias.shape[1] verify queries per head in one pass (keys
    rebuilt once per tile, scored by every query).  Device rule and
    launch counter as for K1."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_zk=self_zk,
              self_zv=self_zv, self_cos=self_cos, self_sin=self_sin)
    if not _on_device("multi-query latent decode", q):
        return latent_decode_attention_mq_plain(q, zk, zv, r_k, cos, sin, bias,
                                                **kw)
    out = launch("recalkv_latent_decode_mq", q, zk, zv, r_k, cos, sin, bias,
                 scale, k_norm, norm_eps, self_zk, self_zv, self_cos, self_sin,
                 nq=bias.shape[1])
    latent_decode_attention_mq.launches += 1
    return out


latent_decode_attention.launches = 0
latent_decode_attention_mq.launches = 0
