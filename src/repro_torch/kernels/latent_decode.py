"""K1, K5, K4 and K7 — ReCalKV latent flash decode over the ring and over
the paged pool, single- and multi-query: CUDA kernels, plain versions,
wrappers.

K1 replaces ``src/repro/kernels/latent_decode.py::latent_decode_attention``,
K5 ``latent_decode_attention_mq``, K4 ``latent_decode_attention_paged`` and
K7 ``latent_decode_attention_mq_paged`` (the Pallas TPU kernels).  Which
CUDA body serves which (kernel, dtype):

  bf16  all of them (and K3, K6 of ``latent_decode_q``): the tensor-core
        body of ``csrc/latent_decode_tc.cu`` (``mma.sync``, 256 ring
        columns per block for one query up to rank 256, 128 for the verify
        bodies and past rank 256, 64 where nothing wider fits and at dh
        256, so every rank up to s * dh at group_size <= 8 (dh 64, 80,
        128) and group_size 4 (dh 256); R_k streamed per head slot
        through a cp.async ring, keys and P as bf16 hi + lo), one
        instantiation per row map: K1 / K5 read ring row b * S + t, K4 /
        K7 the pool row through the page table, so K4 / K7 equal K1 / K5
        on the table-gathered ring bit for bit; K3 / K6 are K1's / K5's
        over int8 latents; K5, K6, K7 score up to 4 query sets per block
        and cover any nq with more blocks; past 16 query rows per group
        (Hg > 16) each body splits the group's head slots over more
        blocks; K1 / K3 / K4 past q_per_kv 8 (up to 16) run the
        multi-query instantiation of their row map at nq = 1;
  f32   all of them: the CUDA-core template of ``csrc/latent_decode.cu``,
        the parity instantiations the 1e-4 checks use (K4 and K7 in f32
        equal K1 and K5 on the gathered ring bit for bit: same tiles, same
        order), at every width the bf16 bodies serve: a plan (column tile
        32 / 16 / 8, head slots and queries per block) fits each shape in
        shared memory (``_f32_plan``).

Each source's header says what bounds it on an H100 and how its design
answers it; keys are never written to device memory.  A shape outside a
body's limits raises; no CUDA tensor falls back to a plain version.

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

K4 / K7 take the latents page-major instead, ``zk`` (n_pages, page_size,
G, r_k) and ``zv`` likewise, plus ``ptab`` (B, n_sp) int32 mapping slot
page j of row b to a physical page (page 0 is the null page, whose
positions read -1).  ``cos``/``sin``/``bias`` stay slot-major over the
S = n_sp * page_size ring columns of the gathered view, as the JAX
wrappers build them.  The self tokens are operands as for K1 / K5 (the
JAX wrappers pass padded self tiles instead).

Beyond the JAX signatures, the deferred-write tokens may be passed as
their own operands instead of being appended to a copy of the ring:
K1's ``self_zk`` (B, G, r_k), ``self_zv`` (B, G, r_v), ``self_cos`` /
``self_sin`` (B, dh/2) are one extra column at bias 0; K5's (B, nq, G, r)
latents and (B, nq, dh/2) tables are nq extra columns whose bias is the
last nq columns of ``bias`` (S_ext = S + nq).  Either way the function is
that of the appended ring.

``return_lse=True`` (every wrapper and plain version) also returns the
rows' raw online-softmax state as two (B, G, rows) float32 tensors, as
the JAX kernels' ``return_lse`` does: ``m``, the running max of the
scaled, biased logits, and ``l``, the sum of exp(logit - m), so that o =
acc / l.  A row masked everywhere has m = NEG_INF (-1e30), l = 0 and o =
0.  The CUDA kernels write them from their merge epilogue; without them
the launch is the one it always was.  A caller merging partial softmaxes
across devices (``kernels.ops`` on a mesh) reweights each part by l *
exp(m - max m).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_SB = (32, 16, 8)        # key tiles of the float32 template (tokens), widest first
_SMEM_LIMIT = 232448     # bytes of shared memory a Hopper block may use


def _rotate(k, cos, sin):
    """k: (..., S, s, dh); cos/sin: (..., S, dh/2) broadcast over s."""
    half = k.shape[-1] // 2
    k1, k2 = k[..., :half], k[..., half:]
    c, s_ = cos[..., None, :], sin[..., None, :]
    return torch.cat([k1 * c - k2 * s_, k2 * c + k1 * s_], dim=-1)


def latent_decode_attention_plain(q, zk, zv, r_k, cos, sin, bias, *, scale,
                                  k_norm=None, norm_eps=1e-6, self_zk=None,
                                  self_zv=None, self_cos=None, self_sin=None,
                                  return_lse=False):
    """Plain PyTorch version of K1 (port of ``repro.kernels.ref`` plus
    k_norm and the self column), in float32: K5's plain version with one
    query, the self column at bias 0.  Like the kernel, a row whose bias
    is masked everywhere returns exact 0.  ``return_lse`` as in the
    module docstring."""
    if self_zk is not None:
        bias = torch.cat([bias, bias.new_zeros(bias.shape[0], 1)], dim=1)
        self_zk, self_zv, self_cos, self_sin = (
            t[:, None] for t in (self_zk, self_zv, self_cos, self_sin))
    return latent_decode_attention_mq_plain(
        q, zk, zv, r_k, cos, sin, bias[:, None], scale=scale, k_norm=k_norm,
        norm_eps=norm_eps, self_zk=self_zk, self_zv=self_zv, self_cos=self_cos,
        self_sin=self_sin, return_lse=return_lse)


def softmax_state(logits: torch.Tensor, dead: torch.Tensor):
    """(weights, m, l) of a masked softmax over the last axis in float32:
    m the max logit, l the sum of exp(logit - m); rows ``dead`` (masked
    everywhere) get weights 0, m = NEG_INF and l = 0."""
    m = logits.amax(dim=-1)
    e = torch.exp(logits - m[..., None])
    l = e.sum(dim=-1)
    w = torch.where(dead[..., None], torch.zeros_like(e), e / l[..., None])
    return (w, torch.where(dead, torch.full_like(m, NEG_INF), m),
            torch.where(dead, torch.zeros_like(l), l))


def latent_decode_attention_mq_plain(q, zk, zv, r_k, cos, sin, bias, *,
                                     scale, k_norm=None, norm_eps=1e-6,
                                     self_zk=None, self_zv=None,
                                     self_cos=None, self_sin=None,
                                     return_lse=False):
    """Plain PyTorch version of K5, in float32: every one of the nq
    queries scores the same reconstructed keys under its own bias row.  A
    (query, head) row whose bias is masked everywhere returns exact 0.
    ``return_lse`` as in the module docstring."""
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
    dead = bias.max(dim=-1).values <= NEG_INF * 0.5           # (B, nq)
    w, m, l = softmax_state(logits, dead[:, None, :, None, None].expand(logits.shape[:-1]))
    o = torch.einsum("bgjsqt,btgr->bgjsqr", w, zv.float())
    o = o.reshape(B, G, QH, zv.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    return o, m.reshape(B, G, QH), l.reshape(B, G, QH)


def gather_pages(pool: torch.Tensor, ptab: torch.Tensor) -> torch.Tensor:
    """Slot-major (B, n_sp * page_size, ...) view of a page-major pool
    leaf (n_pages, page_size, ...) through the page table."""
    B, n_sp = ptab.shape
    v = pool[ptab.reshape(-1).long()]
    return v.reshape((B, n_sp * pool.shape[1]) + tuple(pool.shape[2:]))


def latent_decode_attention_paged_plain(ptab, q, zk, zv, r_k, cos, sin, bias,
                                        **kw):
    """Plain version of K4: gather the pool through the table, then K1's
    plain version."""
    return latent_decode_attention_plain(q, gather_pages(zk, ptab),
                                         gather_pages(zv, ptab), r_k, cos, sin,
                                         bias, **kw)


def latent_decode_attention_mq_paged_plain(ptab, q, zk, zv, r_k, cos, sin,
                                           bias, **kw):
    """Plain version of K7: gather, then K5's plain version."""
    return latent_decode_attention_mq_plain(q, gather_pages(zk, ptab),
                                            gather_pages(zv, ptab), r_k, cos,
                                            sin, bias, **kw)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# (is_bf16, dh), 22 pointers (the last two m_out / l_out), 12 ints, ptab,
# (page_size, n_pages), (scale, eps), stream — the argument list of the six
# entry points of csrc/latent_decode_tc.cu; the six of csrc/latent_decode.cu
# add the plan (sb, sps, qpb).
_ARGTYPES = ([_INT, _INT] + [_PTR] * 22 + [_INT] * 12 + [_PTR, _INT, _INT]
             + [ctypes.c_float, ctypes.c_float, _PTR])
_ARGTYPES_F32 = _ARGTYPES + [_INT] * 3
ENTRY_POINTS = {  # entry point -> its library
    "recalkv_latent_decode": "latent_decode",
    "recalkv_latent_decode_quant": "latent_decode",
    "recalkv_latent_decode_mq": "latent_decode",
    "recalkv_latent_decode_mq_quant": "latent_decode",
    "recalkv_latent_decode_paged": "latent_decode",
    "recalkv_latent_decode_mq_paged": "latent_decode",
    "recalkv_latent_decode_tc": "latent_decode_tc",
    "recalkv_latent_decode_quant_tc": "latent_decode_tc",
    "recalkv_latent_decode_paged_tc": "latent_decode_tc",
    "recalkv_latent_decode_mq_tc": "latent_decode_tc",
    "recalkv_latent_decode_mq_quant_tc": "latent_decode_tc",
    "recalkv_latent_decode_mq_paged_tc": "latent_decode_tc",
}
# The limits of the bf16 tensor-core bodies (csrc/latent_decode_tc.cu::
# shapes_ok): kind, q_per_kv at most, whether nq may exceed 1 (K1 / K3 / K4
# past q_per_kv 8 run the multi-query instantiation at nq = 1, whose block
# plan recalkv_tc_chunk gives with mq = 1).  dh 64, 80, 128 or 256.  Besides,
# r_k, r_v multiples of 8 whose block fits in shared memory
# (recalkv_tc_chunk > 0: at dh 128 every rank up to 1,232 for the verify
# bodies and 1,440 for the others, past the s * dh = 1,024 of group_size
# 8; at dh 256 the 64-column plan, every rank up to s * dh = 1,024 of
# group_size 4).  Any Hg: past 16 query rows a group's head slots split
# over blocks.
_TC_BODIES = {"recalkv_latent_decode_tc": ("ring", 16, False),
              "recalkv_latent_decode_quant_tc": ("int8 ring", 16, False),
              "recalkv_latent_decode_paged_tc": ("paged", 16, False),
              "recalkv_latent_decode_mq_tc": ("multi-query", 16, True),
              "recalkv_latent_decode_mq_quant_tc": ("int8 multi-query", 16, True),
              "recalkv_latent_decode_mq_paged_tc": ("paged multi-query", 16, True)}


def _check_ptab(ptab, q):
    if (ptab.dtype != torch.int32 or ptab.dim() != 2 or ptab.shape[0] != q.shape[0]
            or ptab.device != q.device):
        raise TypeError(f"ptab must be ({q.shape[0]}, n_sp) int32 on {q.device}, "
                        f"got {tuple(ptab.shape)} {ptab.dtype} on {ptab.device}")


def _n_self(self_zk):
    """Self columns: K1 / K3 / K4 take one as (B, G, r), K5 / K6 / K7
    (B, n_self, G, r)."""
    return 0 if self_zk is None else 1 if self_zk.dim() == 3 else self_zk.shape[1]


def _lib(name: str):
    lib = build.load(name)
    first = next(e for e, n in ENTRY_POINTS.items() if n == name)
    if not getattr(lib, first).argtypes:
        for entry, n in ENTRY_POINTS.items():
            if n == name:
                fn = getattr(lib, entry)
                fn.argtypes = (_ARGTYPES_F32 if name == "latent_decode"
                               else _ARGTYPES)
                fn.restype = ctypes.c_int
        if name == "latent_decode":
            lib.recalkv_latent_decode_smem.argtypes = [ctypes.c_int] * 7
            lib.recalkv_latent_decode_smem.restype = ctypes.c_longlong
        else:
            lib.recalkv_tc_chunk.argtypes = [ctypes.c_int] * 5
            lib.recalkv_tc_chunk.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _divisors(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def _f32_plan(lib, quant: bool, dh: int, Hg: int, s: int, nq: int, rk: int,
              rv: int) -> tuple[int, int, int]:
    """(column tile, head slots per block, queries per block) of the
    float32 template: the first plan whose block fits in shared memory,
    all rows first (narrowing the tile before splitting), then fewer head
    slots per block (latent reloads only), then fewer queries per block
    (each query block rebuilds the keys).  Raises if none fits."""
    qpk = Hg // s
    for qpb in _divisors(nq):
        for sps in _divisors(s):
            for sb in _SB:
                smem = lib.recalkv_latent_decode_smem(int(quant), dh, qpb * sps * qpk,
                                                      qpb, rk, rv, sb)
                if 0 < smem <= _SMEM_LIMIT:
                    return sb, sps, qpb
    raise ValueError(f"no float32 latent decode plan fits {_SMEM_LIMIT} B of shared "
                     f"memory at {nq * Hg} rows, r_k={rk}, r_v={rv}")


def launch(entry: str, q, zk, zv, r_k, cos, sin, bias, scale, k_norm,
           norm_eps, self_zk, self_zv, self_cos, self_sin, *, nq: int = 1,
           scales=(None, None, None, None), ptab=None, return_lse=False):
    """Check the operands and launch one entry point (the caller counts the
    launch): a ``*_tc`` one runs the bf16 tensor-core body of
    ``csrc/latent_decode_tc.cu``, the others the float32 CUDA-core
    template of ``csrc/latent_decode.cu``.  ``zk``/``zv`` (and the self
    latents) are q's dtype, or int8 with ``scales`` = (zk_scale, zv_scale,
    self_zk_scale, self_zv_scale) float32.  With ``ptab`` (B, n_sp) int32
    the latents are a page-major pool and the ring has S = n_sp *
    page_size columns; the chunking is the ring's.  A shape outside the
    body's limits raises: nothing is routed to another body.
    ``return_lse`` also returns the rows' merged (m, l), (B, G, nq * Hg)
    float32, from the merge kernel."""
    B, G, QH, dh = q.shape
    S, rk, rv = zk.shape[1], zk.shape[3], zv.shape[3]
    page_size = n_pages = 0
    if ptab is not None:
        n_pages, page_size = zk.shape[0], zk.shape[1]
        S = ptab.shape[1] * page_size
        _check_ptab(ptab, q)
    s = r_k.shape[-1] // dh
    Hg = QH // nq
    dt = q.dtype
    quant = scales[0] is not None
    tc = _TC_BODIES.get(entry)
    name = f"bf16 {tc[0]} kernel" if tc else "latent decode kernel"
    want = torch.bfloat16 if tc else torch.float32
    if dt != want:
        raise TypeError(f"the {name} takes {want} q, got {dt}")
    lat_dt = torch.int8 if quant else dt
    selfs = [self_zk, self_zv] if self_zk is not None else []
    if any(t.dtype != lat_dt for t in [zk, zv] + selfs) or r_k.dtype != dt:
        raise TypeError(f"zk, zv and the self latents must be {lat_dt}, "
                        f"r_k {dt}")
    if any(t.dtype != torch.float32
           for t in (cos, sin, bias, k_norm, self_cos, self_sin, *scales)
           if t is not None):
        raise TypeError("cos, sin, bias, k_norm, scales and the self tables "
                        "must be float32")
    n_self = _n_self(self_zk)
    bias_cols = bias.shape[-1]
    if (dh not in (64, 80, 128, 256) or QH % nq or s < 1 or Hg % s
            or r_k.shape != (G, rk, s * dh)):
        raise ValueError(f"unsupported shapes for the {name}: q {tuple(q.shape)}, "
                         f"r_k {tuple(r_k.shape)} (dh must be 64, 80, 128 or 256)")
    if (zv.shape[:3] != zk.shape[:3] or zk.shape[2] != G
            or (ptab is None and zk.shape[0] != B)
            or tuple(cos.shape[:2]) != (B, S) or bias.numel() != B * nq * bias_cols
            or bias_cols not in (S, S + n_self)
            or (nq > 1 and bias_cols != S + n_self)):
        raise ValueError(f"latents {tuple(zk.shape)} / {tuple(zv.shape)}, tables "
                         f"{tuple(cos.shape)} and bias {tuple(bias.shape)} do "
                         f"not cover the ring ({S}) and {n_self} self columns")
    lib = _lib(ENTRY_POINTS[entry])
    dev = q.device
    s_ext = S + n_self
    if tc:
        _, max_qpk, multi = tc
        body_mq = multi or Hg // s > 8
        chunk_len = lib.recalkv_tc_chunk(int(body_mq), int(quant), dh, rk, rv)
        if ((nq > 1 and not multi) or Hg // s > max_qpk or rk % 8 or rv % 8
                or chunk_len == 0):
            raise ValueError(f"unsupported shapes for the {name}: q "
                             f"{tuple(q.shape)}, nq {nq}, r_k {tuple(r_k.shape)}, "
                             f"r_v {rv} (Hg / s <= {max_qpk}, r_k and r_v "
                             f"multiples of 8 whose block fits in shared "
                             f"memory)")
    else:
        plan = _f32_plan(lib, quant, dh, Hg, s, nq, rk, rv)
        sb, sps, qpb = plan
        # Chunk S (+ the self columns) into about 8 blocks per SM: a block's
        # chunk is its serial critical path, and chunks over empty ring
        # regions finish at once, so short chunks keep the SMs busy whatever
        # part of the ring is filled.
        n_tiles = -(-s_ext // sb)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        row_blocks = (s // sps) * (nq // qpb)
        want = max(1, min(n_tiles, -(-8 * sms // (B * G * row_blocks))))
        chunk_len = -(-n_tiles // want) * sb
    n_chunks = -(-s_ext // chunk_len)
    c = lambda t: None if t is None else t.contiguous()
    ptrs = [c(t) for t in (q, zk, zv, scales[0], scales[1], r_k, cos, sin,
                           bias, k_norm, self_zk, self_zv, scales[2],
                           scales[3], self_cos, self_sin)]
    ptab = c(ptab)
    part_acc = torch.empty((B, G, n_chunks, QH, rv), device=dev, dtype=torch.float32)
    part_m = torch.empty((B, G, n_chunks, QH), device=dev, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    out = torch.empty((B, G, QH, rv), device=dev, dtype=dt)
    m_out = l_out = None
    if return_lse:
        m_out = torch.empty((B, G, QH), device=dev, dtype=torch.float32)
        l_out = torch.empty_like(m_out)
    err = getattr(lib, entry)(
        int(dt == torch.bfloat16), dh, *[_ptr(t) for t in ptrs],
        _ptr(part_acc), _ptr(part_m), _ptr(part_l), _ptr(out), _ptr(m_out),
        _ptr(l_out), B, S, G, Hg, rk, rv, s, nq, n_self, bias_cols, n_chunks,
        chunk_len, _ptr(ptab), page_size, n_pages, float(scale), float(norm_eps),
        torch.cuda.current_stream(dev).cuda_stream, *([] if tc else plan))
    build.check(err, entry)
    return (out, m_out, l_out) if return_lse else out


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
                            self_zv=None, self_cos=None, self_sin=None,
                            return_lse=False):
    """K1.  A CPU tensor runs the plain version; a CUDA tensor runs the
    CUDA kernel (built at first use) or raises — there is no fallback.
    ``latent_decode_attention.launches`` counts kernel launches."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_zk=self_zk,
              self_zv=self_zv, self_cos=self_cos, self_sin=self_sin,
              return_lse=return_lse)
    if not _on_device("latent decode", q):
        return latent_decode_attention_plain(q, zk, zv, r_k, cos, sin, bias, **kw)
    if q.dtype == torch.bfloat16:
        out = launch("recalkv_latent_decode_tc", q, zk, zv, r_k, cos, sin,
                     bias, scale, k_norm, norm_eps, self_zk, self_zv, self_cos,
                     self_sin, return_lse=return_lse)
    else:
        out = launch("recalkv_latent_decode", q, zk, zv, r_k, cos, sin, bias,
                     scale, k_norm, norm_eps, self_zk, self_zv, self_cos,
                     self_sin, return_lse=return_lse)
    latent_decode_attention.launches += 1
    latent_decode_attention.lse_launches += int(return_lse)
    return out


def latent_decode_attention_mq(q, zk, zv, r_k, cos, sin, bias, *, scale,
                               k_norm=None, norm_eps=1e-6, self_zk=None,
                               self_zv=None, self_cos=None, self_sin=None,
                               return_lse=False):
    """K5: nq = bias.shape[1] verify queries per head in one pass (keys
    rebuilt once per tile, scored by every query).  Device rule and
    launch counter as for K1; bf16 runs the tensor-core kernel, float32
    the template's parity instantiation."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_zk=self_zk,
              self_zv=self_zv, self_cos=self_cos, self_sin=self_sin,
              return_lse=return_lse)
    if not _on_device("multi-query latent decode", q):
        return latent_decode_attention_mq_plain(q, zk, zv, r_k, cos, sin, bias,
                                                **kw)
    entry = ("recalkv_latent_decode_mq_tc" if q.dtype == torch.bfloat16
             else "recalkv_latent_decode_mq")
    out = launch(entry, q, zk, zv, r_k, cos, sin, bias, scale, k_norm, norm_eps,
                 self_zk, self_zv, self_cos, self_sin, nq=bias.shape[1],
                 return_lse=return_lse)
    latent_decode_attention_mq.launches += 1
    latent_decode_attention_mq.lse_launches += int(return_lse)
    return out


def latent_decode_attention_paged(ptab, q, zk, zv, r_k, cos, sin, bias, *,
                                  scale, k_norm=None, norm_eps=1e-6,
                                  self_zk=None, self_zv=None, self_cos=None,
                                  self_sin=None, return_lse=False):
    """K4: K1 over a page-major pool through ``ptab``.  Device rule as for
    K1; ``.launches`` counts kernel launches.  bf16 runs the tensor-core
    kernel, float32 the template's parity instantiation."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_zk=self_zk,
              self_zv=self_zv, self_cos=self_cos, self_sin=self_sin,
              return_lse=return_lse)
    if not _on_device("paged latent decode", q):
        return latent_decode_attention_paged_plain(ptab, q, zk, zv, r_k, cos,
                                                   sin, bias, **kw)
    if q.dtype == torch.bfloat16:
        out = launch("recalkv_latent_decode_paged_tc", q, zk, zv, r_k, cos,
                     sin, bias, scale, k_norm, norm_eps, self_zk, self_zv,
                     self_cos, self_sin, ptab=ptab, return_lse=return_lse)
    else:
        out = launch("recalkv_latent_decode_paged", q, zk, zv, r_k, cos, sin,
                     bias, scale, k_norm, norm_eps, self_zk, self_zv, self_cos,
                     self_sin, ptab=ptab, return_lse=return_lse)
    latent_decode_attention_paged.launches += 1
    latent_decode_attention_paged.lse_launches += int(return_lse)
    return out


def latent_decode_attention_mq_paged(ptab, q, zk, zv, r_k, cos, sin, bias, *,
                                     scale, k_norm=None, norm_eps=1e-6,
                                     self_zk=None, self_zv=None, self_cos=None,
                                     self_sin=None, return_lse=False):
    """K7: K5 over a page-major pool through ``ptab``.  Device rule and
    counter as for K5; bf16 runs K5's tensor-core kernel through the page
    table, float32 the template's parity instantiation."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps, self_zk=self_zk,
              self_zv=self_zv, self_cos=self_cos, self_sin=self_sin,
              return_lse=return_lse)
    if not _on_device("paged multi-query latent decode", q):
        return latent_decode_attention_mq_paged_plain(ptab, q, zk, zv, r_k, cos,
                                                      sin, bias, **kw)
    entry = ("recalkv_latent_decode_mq_paged_tc" if q.dtype == torch.bfloat16
             else "recalkv_latent_decode_mq_paged")
    out = launch(entry, q, zk, zv, r_k, cos, sin, bias, scale, k_norm, norm_eps,
                 self_zk, self_zv, self_cos, self_sin, nq=bias.shape[1], ptab=ptab,
                 return_lse=return_lse)
    latent_decode_attention_mq_paged.launches += 1
    latent_decode_attention_mq_paged.lse_launches += int(return_lse)
    return out


latent_decode_attention.launches = 0
latent_decode_attention.lse_launches = 0
latent_decode_attention_paged.launches = 0
latent_decode_attention_paged.lse_launches = 0
latent_decode_attention_mq.launches = 0
latent_decode_attention_mq.lse_launches = 0
latent_decode_attention_mq_paged.launches = 0
latent_decode_attention_mq_paged.lse_launches = 0
