"""The dense cores of K1, K4, K5 and K7: flash decode and multi-query
verify over the dense KV cache, on the ring and on the paged pool — CUDA
kernels, plain versions, wrappers.

``dense_decode_attention`` replaces the Pallas K1
(``src/repro/kernels/latent_decode.py::latent_decode_attention``) as the
JAX package's dense ring core calls it (``repro.kernels.ops.
_dense_ring_core``: an identity R_k and identity rotation tables), and
``dense_decode_attention_paged`` the Pallas K4
(``latent_decode_attention_paged``) as ``_dense_paged_core`` calls it.
Up to 7 query rows a kv head both run ``csrc/dense_decode.cu`` for bf16
and float32 tensors alike: one CUDA-core body with f32 accumulators whose
float32 instantiation is the parity one and whose bf16 one serves.  8-16
rows (``_TC_DECODE_ROWS``) fill one m16 tile of ``csrc/dense_verify.cu``'s
tensor-core body, which they run through its decode entry points (one bias
row for every query row, an optional self column at bias 0; its float32
instantiation runs the same plan on CUDA cores).

``dense_decode_attention_mq`` replaces the Pallas K5
(``latent_decode_attention_mq``) as ``_dense_ring_core_mq`` calls it, and
``dense_decode_attention_mq_paged`` the Pallas K7
(``latent_decode_attention_mq_paged``) as ``_dense_paged_core_mq`` does:
``csrc/dense_verify.cu``, whose bf16 bodies put the nq * qpk query rows
of a kv head on tensor cores (P as a bf16 hi + lo pair): up to 16 rows in
one ``mma.sync`` m16 tile a block, more in row groups of 64 on ``wgmma``
whose K / V tiles each block loads once.  The float32 instantiations, the
parity ones, run the same plans on CUDA cores.

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
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.latent_decode import NEG_INF, _on_device, gather_pages

_TILE = 32           # ring columns of the kernels' tile (their chunks are multiples)
_CHUNK_MAX = 512     # ring columns of a dense_decode.cu block, at most


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
_TC_ENTRIES = ("recalkv_dense_decode_tc", "recalkv_dense_decode_tc_paged")
_MQ_ROWS = 16          # query rows of a one-tile verify block (one m16 tile)
_MQ_GROUP = 64         # query rows of a row-group block (one warpgroup), past 16
_MQ_CHUNK_MAX = 1024   # columns of a verify block, at most
_MQ_CHUNK_MAX8 = 448   # columns of a one-tile verify block past 4 queries
_MQ_PER_SM = 2         # verify blocks an SM holds, where the card is not asked
_MQ_FIXED = 2          # a block's fixed cost (prologue, first loads), in tile steps
_TC_DECODE_ROWS = 8    # q_per_kv from which the decode runs the tensor-core body
_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use


def _lib(name):
    lib = build.load(name)
    entries = {e: name for e in (_ENTRIES if name == "dense_decode" else _MQ_ENTRIES)}
    if name == "dense_verify":   # its decode entries take dense_decode.cu's arguments
        entries.update({e: "dense_decode" for e in _TC_ENTRIES})
    if not getattr(lib, next(iter(entries))).argtypes:
        for entry, args in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = _ARGTYPES[args]
            fn.restype = ctypes.c_int
        if name == "dense_verify":
            for fn in (lib.recalkv_dense_decode_mq_smem,
                       lib.recalkv_dense_decode_mq_blocks_per_sm):
                fn.argtypes = [_INT] * 5
                fn.restype = ctypes.c_int
    return lib


def chunk_plan(B: int, Hkv: int, s_ext: int, sms: int) -> tuple[int, int]:
    """(chunk_len, n_chunks) of ``csrc/dense_decode.cu``: about 8 blocks
    per SM over B * Hkv blocks per chunk, in whole 32-column tiles, at most
    512 columns a block.  The ring and the pool take the same plan for the
    same S, so they sum in the same order."""
    n_tiles = -(-s_ext // _TILE)
    want = max(1, min(n_tiles, -(-8 * sms // (B * Hkv))))
    chunk_len = min(_CHUNK_MAX, -(-n_tiles // want) * _TILE)
    return chunk_len, -(-s_ext // chunk_len)


def row_blocks(rows: int) -> tuple[int, int]:
    """(query rows a block, blocks a kv head) of ``csrc/dense_verify.cu``:
    one m16 tile up to 16 rows (the one-tile body), else row groups of 64
    (the row-group body: one warpgroup on ``wgmma`` over one K / V ring)."""
    per = _MQ_ROWS if rows <= _MQ_ROWS else _MQ_GROUP
    return per, -(-rows // per)


def verify_plan(B: int, Hkv: int, rows: int, nq: int, S: int, sms: int,
                fits=None, n_self: int | None = None, per_sm=None) -> tuple[int, int]:
    """(chunk_len, n_chunks) of ``csrc/dense_verify.cu`` over the S +
    n_self columns for B * Hkv heads times the ``row_blocks`` of their
    ``rows`` query rows, in whole 32-column tiles whose block
    ``fits(chunk_len)`` in shared memory.  ``n_self`` None is the verify
    (nq self columns), else the decode (0 or 1).

    The verify's one-tile body (up to 16 rows) keeps its plan: about two
    blocks an SM, at most 512 columns a block (448 past 4 queries, so two
    bf16 blocks share an SM).  The decode and the row groups take, of the
    chunk lengths up to 1024, the one with the fewest waves times a
    block's steps, a wave being ``sms`` times ``per_sm(chunk_len)`` blocks
    (the card's occupancy; 2 where it is not asked) and a block's steps its
    tiles over the warps that take them at once (four in the one-tile
    body, one in a row group) plus a fixed cost; ties go to fewer chunks.
    On a ragged pool fewer, longer blocks balance worse, and the one-tile
    verify's pool ran slower on that plan than on its own (PERF.md §6).
    The ring and the pool take the same plan, so they sum in the same
    order."""
    s_ext = S + (nq if n_self is None else n_self)
    heads = B * Hkv * row_blocks(rows)[1]
    n_tiles = -(-s_ext // _TILE)
    if n_self is None and rows <= _MQ_ROWS:
        cap = _CHUNK_MAX if nq <= 4 else _MQ_CHUNK_MAX8
        while fits is not None and cap > _TILE and not fits(cap):
            cap -= _TILE
        want = max(1, min(n_tiles, -(-_MQ_PER_SM * sms // heads)))
        chunk_len = min(cap, -(-n_tiles // want) * _TILE)
        return chunk_len, -(-s_ext // chunk_len)
    at_once = 4 if rows <= _MQ_ROWS else 1
    best, seen = None, set()
    for n in range(1, n_tiles + 1):
        cl = -(-n_tiles // n) * _TILE
        n_chunks = -(-s_ext // cl)
        if cl > _MQ_CHUNK_MAX or n_chunks in seen or (fits is not None and not fits(cl)):
            continue
        seen.add(n_chunks)
        slots = max(1, per_sm(cl) if per_sm is not None else _MQ_PER_SM) * sms
        cost = -(-heads * n_chunks // slots) * (-(-cl // (_TILE * at_once)) + _MQ_FIXED)
        if best is None or cost < best[0]:
            best = (cost, cl, n_chunks)
    if best is None:
        raise ValueError(f"no chunk of the dense verify kernel fits {rows} rows of "
                         f"{nq} queries in shared memory")
    return best[1], best[2]


def _decode_body(qpk: int) -> str:
    return "cuda_core" if qpk < _TC_DECODE_ROWS else "tensor_core"


def decode_plan(B: int, Hkv: int, qpk: int, S: int, n_self: int, sms: int,
                fits=None, per_sm=None) -> tuple[str, int, int]:
    """(body, chunk_len, n_chunks) of the dense decode: up to 7 rows a kv
    head the CUDA-core body of ``csrc/dense_decode.cu`` (``"cuda_core"``,
    ``chunk_plan``), 8-16 one m16 tile of ``csrc/dense_verify.cu``
    (``"tensor_core"``, ``verify_plan`` at nq 1); at 8 rows the tensor-core
    body is the faster (chip_smoke's ``phase_decode_bodies``)."""
    if _decode_body(qpk) == "cuda_core":
        return ("cuda_core",) + chunk_plan(B, Hkv, S + n_self, sms)
    return ("tensor_core",) + verify_plan(B, Hkv, qpk, 1, S, sms, fits, n_self=n_self,
                                          per_sm=per_sm)


@functools.lru_cache(maxsize=4096)
def _mq_plan(lib, is_bf16, dh, B, Hkv, nq, qpk, S, n_self, sms):
    """``verify_plan`` on the card (``n_self`` None: the verify): shared
    memory and blocks an SM from the kernel's own entry points (the ring's
    body, so the pool takes the same plan), once per shape."""
    def per_sm(cl):
        n = lib.recalkv_dense_decode_mq_blocks_per_sm(is_bf16, dh, nq, qpk, cl)
        if n < 0:
            build.check(-n, "recalkv_dense_decode_mq_blocks_per_sm")
        return n
    return verify_plan(B, Hkv, nq * qpk, nq, S, sms, n_self=n_self, per_sm=per_sm,
                       fits=lambda cl: lib.recalkv_dense_decode_mq_smem(
                           is_bf16, dh, nq, qpk, cl) <= _SMEM_LIMIT)


def _aligned(t):
    """Contiguous, with a 16-byte aligned start (the kernel's loads are
    16 bytes wide)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q, k, v, bias, scale, self_k, self_v, ptab=None, nq=None, body=None):
    """Check the operands and launch the ring (``ptab`` None) or the pool
    entry point of the decode (``nq`` None: one query per head; the body
    ``decode_plan`` names, or ``body`` "cuda_core" / "tensor_core" to time
    one against the other) or of ``csrc/dense_verify.cu``'s verify (``nq``
    verify queries).  The caller counts the launch.  Raises on a dtype,
    device or shape the body does not take; nothing is routed elsewhere."""
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
    is_bf16, paged = int(dt == torch.bfloat16), ptab is not None
    if not verify and (body or _decode_body(qpk)) == "cuda_core":
        if qpk > 8:
            raise ValueError(f"the dense decode's CUDA-core body takes q_per_kv 1-8, got {qpk}")
        lib, entry = _lib("dense_decode"), _ENTRIES[paged]
        chunk_len, n_chunks = chunk_plan(B, Hkv, S + has_self, sms)
        sizes = (B, S, Hkv, qpk, n_chunks, chunk_len, page_size, n_pages)
    else:
        lib = _lib("dense_verify")
        chunk_len, n_chunks = _mq_plan(lib, is_bf16, dh, B, Hkv, nq or 1, qpk, S,
                                       None if verify else int(has_self), sms)
        if verify:
            entry = _MQ_ENTRIES[paged]
            sizes = (B, S, Hkv, nq, qpk, n_chunks, chunk_len, page_size, n_pages)
        else:
            entry = _TC_ENTRIES[paged]
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
