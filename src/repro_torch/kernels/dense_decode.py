"""The dense cores of K1 and K4: flash decode over the dense KV cache, on
the ring and on the paged pool — CUDA kernels, plain versions, wrappers.

``dense_decode_attention`` replaces the Pallas K1
(``src/repro/kernels/latent_decode.py::latent_decode_attention``) as the
JAX package's dense ring core calls it (``repro.kernels.ops.
_dense_ring_core``: an identity R_k and identity rotation tables), and
``dense_decode_attention_paged`` the Pallas K4
(``latent_decode_attention_paged``) as ``_dense_paged_core`` calls it.
Both run ``csrc/dense_decode.cu`` for bf16 and float32 tensors alike: one
CUDA-core body with f32 accumulators whose float32 instantiation is the
parity one and whose bf16 one serves; its header says what bounds it on an
H100 and how the design answers it.  The ring and the pool run the same
chunks in the same order, so the pool equals the ring on the
table-gathered view bit for bit.  A shape outside the body's limits
raises; no CUDA tensor falls back to a plain version or to K1 / K4.

Shapes:
  q       (B, Hkv, qpk, dh)  post-RoPE queries grouped kv-major (K1's
                             grouping at one kv head per group), qpk <= 8,
                             dh 64 or 128
  k, v    (B, S, Hkv, dh)    the ring, keys stored after RoPE; the pool:
                             (n_pages, page_size, Hkv, dh) read through
                             ``ptab`` (B, S / page_size) int32
  bias    (B, S) f32         additive mask over the S ring columns (0 valid
                             / -1e30 masked), slot-major for the pool
  self_k, self_v (B, Hkv, dh) the current token's key (rotated) and value,
                             one extra column at bias 0; optional
  out     (B, Hkv, qpk, dh)  q's dtype
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.latent_decode import NEG_INF, _on_device, gather_pages

_TILE = 32           # ring columns of the kernel's tile (its chunks are multiples)
_CHUNK_MAX = 512     # ring columns of a block, at most


def dense_decode_attention_plain(q, k, v, bias, *, scale, self_k=None,
                                 self_v=None):
    """Plain PyTorch version, a masked softmax in float32.  Like the
    kernel, a row whose bias is masked everywhere (and no self column)
    returns exact 0."""
    if self_k is not None:
        k = torch.cat([k, self_k[:, None].to(k.dtype)], dim=1)
        v = torch.cat([v, self_v[:, None].to(v.dtype)], dim=1)
        bias = torch.cat([bias, bias.new_zeros(bias.shape[0], 1)], dim=1)
    logits = torch.einsum("bhjd,bthd->bhjt", q.float(), k.float()) * scale
    w = torch.softmax(logits + bias.float()[:, None, None, :], dim=-1)
    dead = bias.max(dim=-1).values <= NEG_INF * 0.5
    w = torch.where(dead[:, None, None, None], torch.zeros_like(w), w)
    return torch.einsum("bhjt,bthd->bhjd", w, v.float()).to(q.dtype)


def dense_decode_attention_paged_plain(ptab, q, k_pool, v_pool, bias, **kw):
    """Plain version of the pool: gather through the table, then the
    ring's plain version."""
    return dense_decode_attention_plain(q, gather_pages(k_pool, ptab),
                                        gather_pages(v_pool, ptab), bias, **kw)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# (is_bf16, dh), q, k, v, bias, k_self, v_self, ptab, part_acc, part_m,
# part_l, out, (B, S, Hkv, qpk, n_chunks, chunk_len, page_size, n_pages),
# scale, stream — both entry points of csrc/dense_decode.cu.
_ARGTYPES = [_INT, _INT] + [_PTR] * 11 + [_INT] * 8 + [ctypes.c_float, _PTR]
_ENTRIES = ("recalkv_dense_decode", "recalkv_dense_decode_paged")


def _lib():
    lib = build.load("dense_decode")
    if not lib.recalkv_dense_decode.argtypes:
        for name in _ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def chunk_plan(B: int, Hkv: int, s_ext: int, sms: int) -> tuple[int, int]:
    """(chunk_len, n_chunks): about 8 blocks per SM over B * Hkv heads, in
    whole 32-column tiles, at most 512 columns a block.  The ring and the
    pool take the same plan for the same S, so they sum in the same order."""
    n_tiles = -(-s_ext // _TILE)
    want = max(1, min(n_tiles, -(-8 * sms // (B * Hkv))))
    chunk_len = min(_CHUNK_MAX, -(-n_tiles // want) * _TILE)
    return chunk_len, -(-s_ext // chunk_len)


def _aligned(t):
    """Contiguous, with a 16-byte aligned start (the kernel's loads are
    16 bytes wide)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q, k, v, bias, scale, self_k, self_v, ptab=None):
    """Check the operands and launch the ring (``ptab`` None) or the pool
    entry point of ``csrc/dense_decode.cu`` (the caller counts the launch).
    Raises on a dtype, device or shape the body does not take; nothing is
    routed elsewhere."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Hkv, qpk, dh), got {tuple(q.shape)}")
    B, Hkv, qpk, dh = q.shape
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the dense decode kernel takes bf16 or float32 q, got {dt}")
    has_self = self_k is not None
    if has_self != (self_v is not None):
        raise ValueError("self_k and self_v come together")
    selfs = [self_k, self_v] if has_self else []
    if any(t.dtype != dt for t in [k, v] + selfs) or bias.dtype != torch.float32:
        raise TypeError(f"k, v and the self entries must be {dt}, bias float32")
    if any(t.device != q.device for t in [k, v, bias] + selfs
           + ([ptab] if ptab is not None else [])):
        raise ValueError(f"every operand must be on {q.device}")
    page_size = n_pages = 0
    if ptab is not None:
        if ptab.dtype != torch.int32 or ptab.dim() != 2 or ptab.shape[0] != B:
            raise TypeError(f"ptab must be ({B}, n_sp) int32, got "
                            f"{tuple(ptab.shape)} {ptab.dtype}")
        n_pages, page_size = k.shape[0], k.shape[1]
        S = ptab.shape[1] * page_size
    else:
        S = k.shape[1]
    if (dh not in (64, 128) or not 1 <= qpk <= 8 or k.dim() != 4
            or k.shape != v.shape or tuple(k.shape[2:]) != (Hkv, dh)
            or (ptab is None and k.shape[0] != B) or tuple(bias.shape) != (B, S)
            or any(tuple(t.shape) != (B, Hkv, dh) for t in selfs)
            or S + has_self < 1):
        raise ValueError(
            f"unsupported shapes for the dense decode kernel: q {tuple(q.shape)}, "
            f"k / v {tuple(k.shape)} / {tuple(v.shape)}, bias {tuple(bias.shape)}, "
            f"self {[tuple(t.shape) for t in selfs]} (dh must be 64 or 128, "
            f"q_per_kv 1-8, at least one column)")
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk_len, n_chunks = chunk_plan(B, Hkv, S + has_self, sms)
    arrs = [_aligned(t) for t in (q, k, v, bias)]
    selfs = [_aligned(t) for t in selfs] or [None, None]
    ptab = None if ptab is None else _aligned(ptab)
    part_acc = torch.empty((B, Hkv, n_chunks, qpk, dh), device=dev, dtype=torch.float32)
    part_m = torch.empty((B, Hkv, n_chunks, qpk), device=dev, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    out = torch.empty((B, Hkv, qpk, dh), device=dev, dtype=dt)
    ptr = lambda t: None if t is None else t.data_ptr()
    entry = _ENTRIES[ptab is not None]
    err = getattr(_lib(), entry)(
        int(dt == torch.bfloat16), dh, *[ptr(t) for t in arrs + selfs], ptr(ptab),
        ptr(part_acc), ptr(part_m), ptr(part_l), ptr(out), B, S, Hkv, qpk, n_chunks,
        chunk_len, page_size, n_pages, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, entry)
    return out


def dense_decode_attention(q, k, v, bias, *, scale, self_k=None, self_v=None):
    """K1's dense core over the ring.  A CPU tensor runs the plain
    version; a CUDA tensor runs the kernel (built at first use) or raises.
    ``dense_decode_attention.launches`` counts kernel launches."""
    if not _on_device("dense decode", q):
        return dense_decode_attention_plain(q, k, v, bias, scale=scale,
                                            self_k=self_k, self_v=self_v)
    out = launch(q, k, v, bias, scale, self_k, self_v)
    dense_decode_attention.launches += 1
    return out


def dense_decode_attention_paged(ptab, q, k_pool, v_pool, bias, *, scale,
                                 self_k=None, self_v=None):
    """K4's dense core: the ring's body over a page-major pool through
    ``ptab``.  Device rule and counter as for the ring."""
    if not _on_device("paged dense decode", q):
        return dense_decode_attention_paged_plain(ptab, q, k_pool, v_pool, bias,
                                                  scale=scale, self_k=self_k,
                                                  self_v=self_v)
    out = launch(q, k_pool, v_pool, bias, scale, self_k, self_v, ptab=ptab)
    dense_decode_attention_paged.launches += 1
    return out


dense_decode_attention.launches = 0
dense_decode_attention_paged.launches = 0
