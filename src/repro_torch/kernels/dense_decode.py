"""The dense cores of K1, K4, K5 and K7: flash decode and multi-query
verify over the dense KV cache, on the ring and on the paged pool — CUDA
kernels, plain versions, wrappers.

``dense_decode_attention`` replaces the Pallas K1
(``src/repro/kernels/latent_decode.py::latent_decode_attention``) as the
JAX package's dense ring core calls it (``repro.kernels.ops.
_dense_ring_core``: an identity R_k and identity rotation tables), and
``dense_decode_attention_paged`` the Pallas K4
(``latent_decode_attention_paged``) as ``_dense_paged_core`` calls it.
Both run ``csrc/dense_decode.cu`` for bf16 and float32 tensors alike: one
CUDA-core body with f32 accumulators whose float32 instantiation is the
parity one and whose bf16 one serves.

``dense_decode_attention_mq`` replaces the Pallas K5
(``latent_decode_attention_mq``) as ``_dense_ring_core_mq`` calls it, and
``dense_decode_attention_mq_paged`` the Pallas K7
(``latent_decode_attention_mq_paged``) as ``_dense_paged_core_mq`` does:
``csrc/dense_verify.cu``, whose bf16 body puts the nq * qpk query rows of
a kv head on ``mma.sync`` tensor cores (P as a bf16 hi + lo pair) and
whose float32 instantiation, the parity one, runs the same plan on CUDA
cores.

Each source's header says what bounds it on an H100 and how the design
answers it.  The ring and the pool run the same chunks in the same order,
so the pool equals the ring on the table-gathered view bit for bit.  A
shape outside a body's limits raises; no CUDA tensor falls back to a
plain version or to K1 / K4 / K5 / K7.

Shapes:
  q       (B, Hkv, qpk, dh)  post-RoPE queries grouped kv-major (K1's
                             grouping at one kv head per group), qpk <= 16,
                             dh 64, 80, 128 or 256; verify: (B, Hkv, nq * qpk, dh),
                             rows ordered (query, head), any nq
  k, v    (B, S, Hkv, dh)    the ring, keys stored after RoPE; the pool:
                             (n_pages, page_size, Hkv, dh) read through
                             ``ptab`` (B, S / page_size) int32
  bias    (B, S) f32         additive mask over the S ring columns (0 valid
                             / -1e30 masked), slot-major for the pool;
                             verify: (B, nq, S + nq), a row per query over
                             the ring and the nq self columns
  self_k, self_v (B, Hkv, dh) the current token's key (rotated) and value,
                             one extra column at bias 0; optional.  Verify:
                             (B, nq, Hkv, dh), the nq verify tokens
                             (rotated), required
  out     (B, Hkv, qpk, dh)  q's dtype (verify: nq * qpk rows)
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


def dense_decode_attention_mq_plain(q, k, v, bias, *, scale, self_k, self_v):
    """Plain version of the dense verify, a masked softmax in float32:
    nq = bias.shape[1] queries, rows (query, head), each query under its
    own bias row over [ring | nq self columns].  A row whose bias is
    masked everywhere returns exact 0."""
    nq = bias.shape[1]
    qpk = q.shape[2] // nq
    k = torch.cat([k, self_k.to(k.dtype)], dim=1)
    v = torch.cat([v, self_v.to(v.dtype)], dim=1)
    rb = bias.float().repeat_interleave(qpk, dim=1)             # (B, nq * qpk, S_ext)
    logits = torch.einsum("bhrd,bthd->bhrt", q.float(), k.float()) * scale
    w = torch.softmax(logits + rb[:, None], dim=-1)
    dead = rb.max(dim=-1).values <= NEG_INF * 0.5               # (B, nq * qpk)
    w = torch.where(dead[:, None, :, None], torch.zeros_like(w), w)
    return torch.einsum("bhrt,bthd->bhrd", w, v.float()).to(q.dtype)


def dense_decode_attention_mq_paged_plain(ptab, q, k_pool, v_pool, bias, **kw):
    """Plain version of the pooled dense verify: gather through the table,
    then the ring's plain version."""
    return dense_decode_attention_mq_plain(q, gather_pages(k_pool, ptab),
                                           gather_pages(v_pool, ptab), bias, **kw)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# (is_bf16, dh), q, k, v, bias, k_self, v_self, ptab, part_acc, part_m,
# part_l, out, (B, S, Hkv, qpk, n_chunks, chunk_len, page_size, n_pages),
# scale, stream — both entry points of csrc/dense_decode.cu; those of
# csrc/dense_verify.cu take nq before qpk.
_ARGTYPES = {"dense_decode": [_INT, _INT] + [_PTR] * 11 + [_INT] * 8 + [ctypes.c_float, _PTR],
             "dense_verify": [_INT, _INT] + [_PTR] * 11 + [_INT] * 9 + [ctypes.c_float, _PTR]}
_ENTRIES = ("recalkv_dense_decode", "recalkv_dense_decode_paged")
_MQ_ENTRIES = ("recalkv_dense_decode_mq", "recalkv_dense_decode_mq_paged")
_MQ_ROWS = 16          # query rows of a verify block (one m16 tile)
_MQ_PER_SM = 2         # verify blocks per SM the chunk plan aims at
_MQ_CHUNK_MAX8 = 448   # columns of a verify block past 4 queries (two bf16 blocks an SM)
_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use


def _lib(name):
    lib = build.load(name)
    entries = _ENTRIES if name == "dense_decode" else _MQ_ENTRIES
    if not getattr(lib, entries[0]).argtypes:
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
        if name == "dense_verify":
            lib.recalkv_dense_decode_mq_smem.argtypes = [_INT] * 5
            lib.recalkv_dense_decode_mq_smem.restype = ctypes.c_int
    return lib


def chunk_plan(B: int, heads: int, s_ext: int, sms: int, per_sm: int = 8,
               cap: int = _CHUNK_MAX) -> tuple[int, int]:
    """(chunk_len, n_chunks): about ``per_sm`` blocks per SM over ``heads``
    blocks per chunk (B * Hkv, times the row blocks of the verify kernel),
    in whole 32-column tiles, at most ``cap`` columns a block.  The ring
    and the pool take the same plan for the same S, so they sum in the same
    order."""
    n_tiles = -(-s_ext // _TILE)
    want = max(1, min(n_tiles, -(-per_sm * sms // (B * heads))))
    chunk_len = min(cap, -(-n_tiles // want) * _TILE)
    return chunk_len, -(-s_ext // chunk_len)


def verify_plan(B: int, Hkv: int, rows: int, nq: int, S: int, sms: int,
                fits=None) -> tuple[int, int]:
    """(chunk_len, n_chunks) of the verify kernel: ``chunk_plan`` over the
    S + nq columns for B * Hkv heads times the 16-row blocks of their
    ``rows`` query rows, at most 512 columns a block (448 past 4 queries,
    so two bf16 blocks share an SM), and fewer while ``fits(chunk_len)``
    says a block's shared memory does not fit (dh 256: the bias rows of
    many queries beside 192 KB of rings).  The ring and the pool take the
    same plan."""
    cap = _CHUNK_MAX if nq <= 4 else _MQ_CHUNK_MAX8
    while fits is not None and cap > _TILE and not fits(cap):
        cap -= _TILE
    return chunk_plan(B, Hkv * -(-rows // _MQ_ROWS), S + nq, sms, per_sm=_MQ_PER_SM,
                      cap=cap)


def _aligned(t):
    """Contiguous, with a 16-byte aligned start (the kernel's loads are
    16 bytes wide)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q, k, v, bias, scale, self_k, self_v, ptab=None, nq=None):
    """Check the operands and launch the ring (``ptab`` None) or the pool
    entry point of ``csrc/dense_decode.cu`` (``nq`` None: one query per
    head) or of ``csrc/dense_verify.cu`` (``nq`` verify queries; the caller
    counts the launch).  Raises on a dtype, device or shape the body does
    not take; nothing is routed elsewhere."""
    verify = nq is not None
    what = "dense verify" if verify else "dense decode"
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Hkv, {'nq * ' if verify else ''}qpk, dh), "
                         f"got {tuple(q.shape)}")
    B, Hkv, rows, dh = q.shape
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the {what} kernel takes bf16 or float32 q, got {dt}")
    has_self = self_k is not None
    if has_self != (self_v is not None):
        raise ValueError("self_k and self_v come together")
    if verify and not has_self:
        raise ValueError("the dense verify kernel takes the nq self columns")
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
    n_self = nq if verify else int(has_self)
    qpk = rows // nq if verify else rows
    if (dh not in (64, 80, 128, 256) or not 1 <= qpk <= 16
            or (verify and (nq < 1 or rows != nq * qpk))
            or k.dim() != 4 or k.shape != v.shape or tuple(k.shape[2:]) != (Hkv, dh)
            or (ptab is None and k.shape[0] != B)
            or tuple(bias.shape) != ((B, nq, S + nq) if verify else (B, S))
            or any(tuple(t.shape) != ((B, nq, Hkv, dh) if verify else (B, Hkv, dh))
                   for t in selfs)
            or S + n_self < 1):
        raise ValueError(
            f"unsupported shapes for the {what} kernel: q {tuple(q.shape)}, "
            f"k / v {tuple(k.shape)} / {tuple(v.shape)}, bias {tuple(bias.shape)}, "
            f"self {[tuple(t.shape) for t in selfs]} (dh must be 64, 80, 128 or 256, "
            f"q_per_kv 1-16{', nq >= 1' if verify else ''}, at least one column)")
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if verify:
        lib, entry = _lib("dense_verify"), _MQ_ENTRIES[ptab is not None]
        is_bf16 = int(dt == torch.bfloat16)
        chunk_len, n_chunks = verify_plan(
            B, Hkv, rows, nq, S, sms, fits=lambda cl: lib.recalkv_dense_decode_mq_smem(
                is_bf16, dh, nq, qpk, cl) <= _SMEM_LIMIT)
        sizes = (B, S, Hkv, nq, qpk, n_chunks, chunk_len, page_size, n_pages)
    else:
        chunk_len, n_chunks = chunk_plan(B, Hkv, S + has_self, sms)
        lib, entry = _lib("dense_decode"), _ENTRIES[ptab is not None]
        sizes = (B, S, Hkv, qpk, n_chunks, chunk_len, page_size, n_pages)
    arrs = [_aligned(t) for t in (q, k, v, bias)]
    selfs = [_aligned(t) for t in selfs] or [None, None]
    ptab = None if ptab is None else _aligned(ptab)
    part_acc = torch.empty((B, Hkv, n_chunks, rows, dh), device=dev, dtype=torch.float32)
    part_m = torch.empty((B, Hkv, n_chunks, rows), device=dev, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    out = torch.empty((B, Hkv, rows, dh), device=dev, dtype=dt)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = getattr(lib, entry)(
        int(dt == torch.bfloat16), dh, *[ptr(t) for t in arrs + selfs], ptr(ptab),
        ptr(part_acc), ptr(part_m), ptr(part_l), ptr(out), *sizes, float(scale),
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


def dense_decode_attention_mq(q, k, v, bias, *, scale, self_k, self_v):
    """K5's dense core over the ring: ``bias.shape[1]`` verify queries per
    kv head in one pass.  Device rule as for the decode wrappers;
    ``dense_decode_attention_mq.launches`` counts kernel launches."""
    if not _on_device("dense verify", q):
        return dense_decode_attention_mq_plain(q, k, v, bias, scale=scale,
                                               self_k=self_k, self_v=self_v)
    out = launch(q, k, v, bias, scale, self_k, self_v, nq=bias.shape[1])
    dense_decode_attention_mq.launches += 1
    return out


def dense_decode_attention_mq_paged(ptab, q, k_pool, v_pool, bias, *, scale,
                                    self_k, self_v):
    """K7's dense core: the verify kernel over a page-major pool through
    ``ptab``.  Device rule and counter as for the ring."""
    if not _on_device("paged dense verify", q):
        return dense_decode_attention_mq_paged_plain(ptab, q, k_pool, v_pool, bias,
                                                     scale=scale, self_k=self_k,
                                                     self_v=self_v)
    out = launch(q, k_pool, v_pool, bias, scale, self_k, self_v, ptab=ptab,
                 nq=bias.shape[1])
    dense_decode_attention_mq_paged.launches += 1
    return out


dense_decode_attention_mq.launches = 0
dense_decode_attention_mq_paged.launches = 0
