"""K1 — ReCalKV latent-ring flash decode: CUDA kernel, plain version, wrapper.

Replaces ``src/repro/kernels/latent_decode.py::latent_decode_attention``
(the Pallas TPU kernel).  The CUDA source is ``csrc/latent_decode.cu``;
its header says what bounds it on an H100 and how the design answers it
(S split into chunks with an LSE merge for parallelism, R_k streamed per
head slot, keys never written to device memory).

Shapes (as in the JAX kernel):
  q      (B, G, Hg, dh)   post-RoPE grouped queries, Hg = s * q_per_kv
  zk     (B, S, G, r_k)   pre-RoPE key latents      zv (B, S, G, r_v)
  r_k    (G, r_k, s*dh)   key reconstruction factors
  cos/sin (B, S, dh/2) f32 rotation tables of the stored positions
  bias   (B, S) f32       additive mask (0 valid / -1e30 masked)
  k_norm (dh,) f32        optional per-head RMSNorm scale (1 + k_norm)
  out    (B, G, Hg, r_v)  latent attention outputs, q's dtype

Beyond the JAX signature, the deferred-write self token may be passed as
its own operands (``self_zk`` (B, G, r_k), ``self_zv`` (B, G, r_v),
``self_cos``/``self_sin`` (B, dh/2)): one extra column at bias 0, the same
function as appending it to the ring, without the copy.
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
    """Plain PyTorch version (port of ``repro.kernels.ref`` plus k_norm and
    the self column), in float32.  Like the kernel, a row whose bias is
    masked everywhere returns exact 0."""
    if self_zk is not None:
        zk = torch.cat([zk, self_zk[:, None].to(zk.dtype)], dim=1)
        zv = torch.cat([zv, self_zv[:, None].to(zv.dtype)], dim=1)
        cos = torch.cat([cos, self_cos[:, None]], dim=1)
        sin = torch.cat([sin, self_sin[:, None]], dim=1)
        bias = torch.cat([bias, bias.new_zeros(bias.shape[0], 1)], dim=1)
    B, G, Hg, dh = q.shape
    S = zk.shape[1]
    s = r_k.shape[-1] // dh
    qpk = Hg // s
    k = torch.einsum("bsgr,grn->bsgn", zk.float(), r_k.float())
    k = k.reshape(B, S, G, s, dh)
    if k_norm is not None:
        ms = (k * k).mean(dim=-1, keepdim=True)
        k = k * torch.rsqrt(ms + norm_eps) * (1.0 + k_norm.float())
    k = _rotate(k.transpose(1, 2), cos.float()[:, None], sin.float()[:, None])
    qg = q.float().reshape(B, G, s, qpk, dh)
    logits = torch.einsum("bgsjd,bgtsd->bgsjt", qg, k) * scale
    logits = logits + bias.float()[:, None, None, None, :]
    w = torch.softmax(logits, dim=-1)
    dead = bias.max(dim=-1).values <= NEG_INF * 0.5           # (B,)
    w = torch.where(dead[:, None, None, None, None], torch.zeros_like(w), w)
    o = torch.einsum("bgsjt,btgr->bgsjr", w, zv.float())
    return o.reshape(B, G, Hg, zv.shape[-1]).to(q.dtype)


_PTR = ctypes.c_void_p
_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [_PTR] * 16
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float, _PTR])


def _lib():
    lib = build.load("latent_decode")
    if not lib.recalkv_latent_decode.argtypes:
        lib.recalkv_latent_decode.argtypes = _ARGTYPES
        lib.recalkv_latent_decode.restype = ctypes.c_int
        lib.recalkv_latent_decode_smem.argtypes = [ctypes.c_int] * 5
        lib.recalkv_latent_decode_smem.restype = ctypes.c_longlong
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, zk, zv, r_k, cos, sin, bias, scale, k_norm, norm_eps,
            self_zk, self_zv, self_cos, self_sin):
    B, G, Hg, dh = q.shape
    S, rk, rv = zk.shape[1], zk.shape[3], zv.shape[3]
    s = r_k.shape[-1] // dh
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"latent decode kernel takes bf16 or f32, got {dt}")
    lat = [zk, zv, r_k] + ([self_zk, self_zv] if self_zk is not None else [])
    if any(t.dtype != dt for t in lat):
        raise TypeError("q, zk, zv, r_k and the self latents must share a dtype")
    f32 = [cos, sin, bias] + [t for t in (k_norm, self_cos, self_sin) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("cos, sin, bias, k_norm and the self tables must be float32")
    if dh not in (64, 128) or Hg % s or r_k.shape != (G, rk, s * dh):
        raise ValueError(f"unsupported shapes: q {tuple(q.shape)}, "
                         f"r_k {tuple(r_k.shape)} (dh must be 64 or 128)")
    lib = _lib()
    is_bf16 = int(dt == torch.bfloat16)
    smem = lib.recalkv_latent_decode_smem(is_bf16, dh, Hg, rk, rv)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"latent decode tile needs {smem} B of shared memory "
                         f"(limit {_SMEM_LIMIT}) at Hg={Hg}, r_k={rk}, r_v={rv}")
    dev = q.device
    args = [t.contiguous() for t in (q, zk, zv, r_k, cos, sin, bias)]
    opt = [None if t is None else t.contiguous()
           for t in (k_norm, self_zk, self_zv, self_cos, self_sin)]
    # Chunk S (+ the self column) into about 8 blocks per SM (some 4 waves
    # at 2 resident blocks per SM): a block's chunk is its serial critical
    # path, and chunks over empty ring regions finish at once, so short
    # chunks keep the SMs busy whatever part of the ring is filled.
    s_ext = S + (self_zk is not None)
    n_tiles = -(-s_ext // _SB)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, min(n_tiles, -(-8 * sms // (B * G))))
    chunk_len = -(-n_tiles // want) * _SB
    n_chunks = -(-s_ext // chunk_len)
    part_acc = torch.empty((B, G, n_chunks, Hg, rv), device=dev, dtype=torch.float32)
    part_m = torch.empty((B, G, n_chunks, Hg), device=dev, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    out = torch.empty((B, G, Hg, rv), device=dev, dtype=dt)
    err = lib.recalkv_latent_decode(
        is_bf16, dh, *[_ptr(t) for t in args], *[_ptr(t) for t in opt],
        _ptr(part_acc), _ptr(part_m), _ptr(part_l), _ptr(out),
        B, S, G, Hg, rk, rv, s, n_chunks, chunk_len, float(scale), float(norm_eps),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "latent_decode")
    latent_decode_attention.launches += 1
    return out


def latent_decode_attention(q, zk, zv, r_k, cos, sin, bias, *, scale,
                            k_norm=None, norm_eps=1e-6, self_zk=None,
                            self_zv=None, self_cos=None, self_sin=None):
    """K1.  A CPU tensor runs the plain version; a CUDA tensor runs the
    CUDA kernel (built at first use) or raises — there is no fallback.
    ``latent_decode_attention.launches`` counts kernel launches."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_zk=self_zk,
              self_zv=self_zv, self_cos=self_cos, self_sin=self_sin)
    if q.device.type == "cpu":
        return latent_decode_attention_plain(q, zk, zv, r_k, cos, sin, bias, **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"latent decode: no kernel for device {q.device}")
    return _launch(q, zk, zv, r_k, cos, sin, bias, scale, k_norm, norm_eps,
                   self_zk, self_zv, self_cos, self_sin)


latent_decode_attention.launches = 0
