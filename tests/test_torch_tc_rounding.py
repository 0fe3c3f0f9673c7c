"""The precision budget of the bf16 tensor-core kernels, on the CPU.

K2 (``csrc/flash_prefill.cu``) and K1 and K3-K7 (``csrc/latent_decode_tc.cu``)
multiply bf16 operands on tensor cores with f32 accumulation.  This file
emulates, in plain torch, the points where their bf16 bodies round, and
holds each emulation to ``chip_smoke.py``'s bf16 limit of the f32 plain
version, per element: |emulated - plain| <= 2e-2 |plain| + 1e-2 rms(plain).

* K2: S = Q K^T from bf16 operands in f32; an online softmax over 64-key
  tiles in f32; P enters P V as hi = bf16(P) plus lo = bf16(P - hi).  The
  kernel's exponent base may lag the running max by up to 2^8, which scales
  P and l alike and moves no rounding point.  A value width dv off the
  instantiated 64 / 128 / 256 runs in column slices with V zero-padded
  (``k2_sliced``).
* K4: keys rebuilt from bf16 latents and R_k in f32, normed and rotated in
  f32, then split into bf16 hi + lo for the scores; one softmax per
  256-column chunk with P split into bf16 hi + lo for P zv; chunks merged
  by log-sum-exp in f32.  K1 is the same body with the ring's row map
  (``test_k1_body_is_k4_emulated_on_the_ring``).
* K6: K4's rounding points over int8 latents (exact in bf16), the key
  scale on each rebuilt row before k-norm, P times the value scale split
  into bf16 hi + lo, nq queries each with its own bias row over the ring
  and the nq self columns, 128-column chunks.
* K3: K1's body over int8 latents (K6's conversion and scales), one query
  with its self column at bias 0, 256-column chunks up to rank 256.
* K5: K6's body over bf16 latents: nq queries, each with its own bias row
  over the ring and the nq self columns, 128-column chunks.  K7 is K5's
  body through a page table, as K4 is K1's.
* The dense verify kernel (``csrc/dense_verify.cu``, K5's and K7's dense
  cores): S = q K^T from bf16 operands in f32 (exact products, no key
  rebuild); each of four warps runs an online softmax over its 32-column
  tiles of a chunk, P entering P V as bf16 hi + lo; warps and then chunks
  merged by log-sum-exp in f32 (``dense_verify_emulated``).
* The 64-column plan: past the ranks whose 128-column block fits in
  shared memory (the one-query bodies past rank ~700, the verify bodies
  past 544 at dh 128, up to s * dh = 1,024 at group_size 8) every body
  takes 64-column chunks;
  two warps then share a key m-tile, which reorders f32 sums and moves no
  rounding point, so the emulations run with ``chunk=64``.

One bf16 rounding of P (K2, the dense verify kernel), or of the keys and P
(K3-K6), is what a plain
bf16 tensor-core design would do; ``test_one_bf16_rounding_is_measured``
records its error beside the split's.

Each emulation without its rounding must equal the plain version to the
float32 limit (1e-4), which checks its tiling, masks and merge.  Inputs are
made with numpy from fixed seeds, at a narrow shape and at the main path's
widths (dh = 128, r = 256, latent values dv = 256).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.latent_decode import latent_decode_attention_mq as jax_k5
from repro.kernels.latent_decode_q import latent_decode_attention_mq_quant as jax_k6
from repro.kernels.latent_decode_q import latent_decode_attention_quant as jax_k3
from repro_torch.kernels import dense_decode as KD
from repro_torch.kernels import flash_prefill as K2
from repro_torch.kernels import latent_decode as K1
from repro_torch.kernels import latent_decode_q as KQ
from repro_torch.kernels import ops

NEG_INF = -1e30
BF16_REL, BF16_RMS = 2e-2, 1e-2     # chip_smoke.py's bf16 limit
F32_TOL = 1e-4


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """bf16 hi + lo of f32 x, the value two mma.sync products multiply."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _worst(got, want):
    """max |got - want| / (2e-2 |want| + 1e-2 rms(want))."""
    got, want = got.float(), want.float()
    limit = BF16_REL * want.abs() + BF16_RMS * want.square().mean().sqrt()
    return ((got - want).abs() / limit).max().item()


def k2_emulated(q, k, v, *, window=None, rounding="split", bk=64):
    """K2's bf16 body: causal, 64-key tiles in order; P enters P V as bf16
    hi + lo (``rounding="one"``: one bf16 rounding; None: f32 P).  q
    (B,T,H,dh), k (B,T,Hkv,dh), v (B,T,Hv,dv), f32 values of bf16 operands;
    returns (B,T,H,dv) f32 before the output rounding."""
    B, T, H, dh = q.shape
    Hkv, Hv, dv = k.shape[2], v.shape[2], v.shape[3]
    scale = dh ** -0.5
    kk = k.repeat_interleave(H // Hkv, dim=2)
    vv = v.repeat_interleave(H // Hv, dim=2)
    qp = torch.arange(T)[:, None]
    m = torch.full((B, H, T), NEG_INF)
    l = torch.zeros((B, H, T))
    o = torch.zeros((B, H, T, dv))
    for k0 in range(0, T, bk):
        k1 = min(T, k0 + bk)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk[:, k0:k1]) * scale
        kp = torch.arange(k0, k1)[None, :]
        ok = kp <= qp
        if window is not None:
            ok &= kp > qp - window
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        live = m_new > NEG_INF * 0.5
        corr = torch.where(live, torch.exp(m - m_new), torch.ones_like(m))
        p = torch.where(live[..., None], torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * corr + p.sum(dim=-1)
        rnd = {"split": _split, "one": _bf16}.get(rounding, lambda x: x)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", rnd(p),
                                               vv[:, k0:k1])
        m = torch.where(live, m_new, m)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 2, 1, 3)


def k2_sliced(q, k, v, **kw):
    """K2's bf16 body at any value width: the block's slice is the
    narrowest of 64 / 128 / 256 columns that holds dv, and past 256 the
    head's dv splits into slices of 256; V is zero-padded to whole slices,
    each slice runs ``k2_emulated`` (recomputing the scores) and the
    padding columns are dropped."""
    dv = v.shape[-1]
    w = 64 if dv <= 64 else 128 if dv <= 128 else 256
    n_sl = -(-dv // w)
    vp = torch.nn.functional.pad(v, (0, n_sl * w - dv))
    return torch.cat([k2_emulated(q, k, vp[..., i * w:(i + 1) * w], **kw)
                      for i in range(n_sl)], dim=-1)[..., :dv]


def tc_emulated(q, zk, zv, r_k, cos, sin, bias, *, k_norm, ks=None, vs=None,
                eps=1e-6, rounding="split", chunk=256):
    """The bf16 body of ``csrc/latent_decode_tc.cu`` over columns that
    already include the self columns: f32 values of bf16 q (B,G,nq*Hg,dh),
    of bf16 or int8 latents zk/zv (B,S,G,r) with optional key / value
    scales ks/vs (B,S,G), r_k (G,r,s*dh); bias (B,nq,S), one row per query.
    Keys (scaled before k-norm) and P (times the value scale) enter their
    products as bf16 hi + lo (``rounding="one"``: one bf16 rounding each;
    None: f32); one softmax per ``chunk`` columns, merged by log-sum-exp.
    Returns (B,G,nq*Hg,rv) f32 before the output rounding."""
    rnd = {"split": _split, "one": _bf16}.get(rounding, lambda x: x)
    B, G, QH, dh = q.shape
    nq = bias.shape[1]
    s = r_k.shape[-1] // dh
    qpk = QH // nq // s
    S = zk.shape[1]
    keys = torch.einsum("btgr,grn->bgtn", zk, r_k).reshape(B, G, S, s, dh)
    if ks is not None:
        keys = keys * ks.permute(0, 2, 1)[..., None, None]
    if k_norm is not None:
        keys = keys * torch.rsqrt((keys * keys).mean(-1, keepdim=True) + eps)
        keys = keys * (1.0 + k_norm)
    half = dh // 2
    c, sn = cos[:, None, :, None], sin[:, None, :, None]
    k1_, k2_ = keys[..., :half], keys[..., half:]
    keys = rnd(torch.cat([k1_ * c - k2_ * sn, k2_ * c + k1_ * sn], dim=-1))
    qg = q.reshape(B, G, nq, s, qpk, dh)
    sc = torch.einsum("bgjsqd,bgtsd->bgjsqt", qg, keys) * dh ** -0.5
    sc = (sc + bias[:, None, :, None, None, :]).reshape(B, G, QH, S)
    vscale = torch.ones(B, G, 1, S) if vs is None else vs.permute(0, 2, 1)[:, :, None]
    parts = []
    for t0 in range(0, S, chunk):
        x = sc[..., t0:t0 + chunk]
        m = x.max(dim=-1).values
        alive = m > NEG_INF * 0.5
        p = torch.where(alive[..., None], torch.exp(x - m[..., None]),
                        torch.zeros_like(x))
        acc = torch.einsum("bght,btgr->bghr", rnd(p * vscale[..., t0:t0 + chunk]),
                           zv[:, t0:t0 + chunk])
        parts.append((torch.where(alive, m, torch.full_like(m, NEG_INF)),
                      p.sum(-1), acc))
    M = torch.stack([p[0] for p in parts]).max(dim=0).values
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l_, acc in parts:
        w = torch.where(m > NEG_INF * 0.5, torch.exp(m - M), torch.zeros_like(m))
        L = L + l_ * w
        O = O + acc * w[..., None]
    return O / torch.clamp(L, min=1e-30)[..., None]


def k4_emulated(q, zk, zv, r_k, cos, sin, bias, *, k_norm, self_zk, self_zv,
                self_cos, self_sin, eps=1e-6, rounding="split", chunk=256):
    """K4's bf16 body on the table-gathered ring (its result depends only
    on the columns' content): ``tc_emulated`` with one query, an optional
    self column at bias 0 and 256-column chunks.  f32 values of bf16 q
    (B,G,Hg,dh), zk/zv (B,S,G,r), r_k (G,r,s*dh).  Returns (B,G,Hg,rv) f32
    before the output rounding."""
    B = q.shape[0]
    if self_zk is not None:
        zk = torch.cat([zk, self_zk[:, None]], dim=1)
        zv = torch.cat([zv, self_zv[:, None]], dim=1)
        cos = torch.cat([cos, self_cos[:, None]], dim=1)
        sin = torch.cat([sin, self_sin[:, None]], dim=1)
        bias = torch.cat([bias, torch.zeros(B, 1)], dim=1)
    return tc_emulated(q, zk, zv, r_k, cos, sin, bias[:, None], k_norm=k_norm,
                       eps=eps, rounding=rounding, chunk=chunk)


def k6_emulated(q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin, bias, *, k_norm,
                self_zk_q, self_zk_s, self_zv_q, self_zv_s, self_cos, self_sin,
                eps=1e-6, rounding="split", chunk=128):
    """K6's bf16 body: int8 ring latents (B,S,G,r) with f32 scales (B,S,G),
    the nq self columns' latents (B,nq,G,r) and scales appended after the
    ring, bias (B,nq,S+nq) per query; int8 -> bf16 is exact, so the int8
    values enter as they are.  128-column chunks.  Returns (B,G,nq*Hg,rv)
    f32 before the output rounding."""
    cat = lambda a, b: torch.cat([a, b], dim=1)
    return tc_emulated(q, cat(zk_q, self_zk_q).float(), cat(zv_q, self_zv_q).float(),
                       r_k, cat(cos, self_cos), cat(sin, self_sin), bias, k_norm=k_norm,
                       ks=cat(zk_s, self_zk_s), vs=cat(zv_s, self_zv_s), eps=eps,
                       rounding=rounding, chunk=chunk)


def k5_emulated(q, zk, zv, r_k, cos, sin, bias, *, k_norm, self_zk, self_zv, self_cos,
                self_sin, eps=1e-6, rounding="split", chunk=128):
    """K5's bf16 body: bf16 ring latents (B,S,G,r), the nq self columns'
    latents (B,nq,G,r) and rotation tables appended after the ring, bias
    (B,nq,S+nq) per query; 128-column chunks (64 past rank 544 at dh 128).
    Returns (B,G,nq*Hg,rv) f32 before the output rounding."""
    cat = lambda a, b: torch.cat([a, b], dim=1)
    return tc_emulated(q, cat(zk, self_zk), cat(zv, self_zv), r_k, cat(cos, self_cos),
                       cat(sin, self_sin), bias, k_norm=k_norm, eps=eps, rounding=rounding,
                       chunk=chunk)


def k3_emulated(q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin, bias, *, k_norm,
                self_zk_q=None, self_zk_s=None, self_zv_q=None, self_zv_s=None,
                self_cos=None, self_sin=None, eps=1e-6, rounding="split", chunk=256):
    """K3's bf16 body: ``tc_emulated`` with int8 ring latents (B,S,G,r),
    their f32 scales (B,S,G), one query with bias (B,S) and an optional
    self column ((B,G,r) int8, (B,G) scales) at bias 0.  Returns
    (B,G,Hg,rv) f32 before the output rounding."""
    ks, vs = zk_s, zv_s
    if self_zk_q is not None:
        cat = lambda a, b: torch.cat([a, b[:, None]], dim=1)
        zk_q, zv_q = cat(zk_q, self_zk_q), cat(zv_q, self_zv_q)
        ks, vs = cat(ks, self_zk_s), cat(vs, self_zv_s)
        cos, sin = cat(cos, self_cos), cat(sin, self_sin)
        bias = torch.cat([bias, torch.zeros(bias.shape[0], 1)], dim=1)
    return tc_emulated(q, zk_q.float(), zv_q.float(), r_k, cos, sin, bias[:, None],
                       k_norm=k_norm, ks=ks, vs=vs, eps=eps, rounding=rounding,
                       chunk=chunk)


def dense_verify_emulated(q, k, v, bias, *, scale, self_k, self_v, rounding="split",
                          chunk=512, warps=4, tile=32, rows=16):
    """The dense verify kernel's bf16 body: q (B,Hkv,nq*qpk,dh), the ring
    k / v (B,S,Hkv,dh) with the nq self columns (B,nq,Hkv,dh) appended,
    bias (B,nq,S+nq) per query.  Per block (``rows`` query rows, ``chunk``
    columns) the 32-column tiles some of its rows see go to the warps in
    turn; each warp's online softmax rounds P = e^(s - m) (m its running
    maximum) at the split, and its partials merge with the other warps',
    then the chunks', by log-sum-exp.  Returns (B,Hkv,nq*qpk,dh) f32 before
    the output rounding."""
    rnd = {"split": _split, "one": _bf16, None: lambda x: x}[rounding]
    B, Hkv, M, dh = q.shape
    k = torch.cat([k, self_k], 1).float()
    v = torch.cat([v, self_v], 1).float()
    rb = bias.float().repeat_interleave(M // bias.shape[1], dim=1)     # (B, M, S_ext)
    live = rb > NEG_INF * 0.5
    s = torch.einsum("bhrd,bthd->bhrt", q.float(), k) * scale + rb[:, None]
    s = torch.where(live[:, None], s, torch.full_like(s, NEG_INF))
    S_ext = k.shape[1]

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        l, acc = torch.zeros_like(m), torch.zeros(m.shape + (dh,))
        for mw, lw, ow in parts:
            w = torch.where(mw <= NEG_INF * 0.5, 0.0,
                            torch.where(mw == m, 1.0, torch.exp(mw - m)))
            l, acc = l + lw * w, acc + ow * w[..., None]
        return m, l, acc

    out = torch.zeros(B, Hkv, M, dh)
    for b in range(B):
        for r0 in range(0, M, rows):
            rs = slice(r0, min(M, r0 + rows))
            chunks = []
            for c0 in range(0, S_ext, chunk):
                tiles = [t for t in range(c0, min(c0 + chunk, S_ext), tile)
                         if live[b, rs, t:t + tile].any()]
                parts = []
                for w in range(warps):
                    m = torch.full((Hkv, rs.stop - r0), NEG_INF)
                    l, o = torch.zeros_like(m), torch.zeros(m.shape + (dh,))
                    for t in tiles[w::warps]:
                        st = s[b, :, rs, t:t + tile]
                        mx = torch.maximum(m, st.amax(-1))
                        f = torch.where(m == mx, 1.0, torch.exp(m - mx))
                        p = torch.where(st <= NEG_INF * 0.5, 0.0,
                                        torch.where(st == mx[..., None], 1.0,
                                                    torch.exp(st - mx[..., None])))
                        m, l = mx, l * f + p.sum(-1)
                        o = o * f[..., None] + torch.einsum("hrt,thd->hrd", rnd(p),
                                                            v[b, t:t + tile])
                    parts.append((m, l, o))
                chunks.append(merge(parts))
            _, l, acc = merge(chunks)
            out[b, :, rs] = acc / l.clamp(min=1e-30)[..., None]
    return out


DV_CASES = {
    # name: (B, S, Hkv, q_per_kv, nq, dh, tokens per row (None: masked
    #        row), the kernel's chunk at these widths)
    "narrow": (3, 300, 2, 8, 5, 64, (300, 40, None), 96),
    "main_widths": (3, 1024, 8, 4, 4, 128, (1024, 614, None), 512),
}


def _dv_inputs(case):
    """A bf16 dense ring like chip_smoke.py's verify operands, ragged as
    ``_k5_inputs``' (row 0 drops its last fed token, a None row is masked
    everywhere); nq verify queries at positions cur..cur+nq-1 with their
    post-RoPE self columns."""
    B, S, Hkv, qpk, nq, dh, lens, _ = DV_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 9)
    mk = lambda *sh: _bf16(torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)))
    pos = torch.arange(S).repeat(B, 1)
    for b, n in enumerate(lens):
        pos[b, n or 0:] = -1
    cur = torch.tensor([n or S for n in lens])
    pos_q = cur[:, None] + torch.arange(nq)
    feed = torch.ones(B, nq, dtype=torch.bool)
    feed[0, -1] = False
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
    for b, n in enumerate(lens):
        if n is None:
            bias[b] = NEG_INF
    args = (mk(B, Hkv, nq * qpk, dh), mk(B, S, Hkv, dh), mk(B, S, Hkv, dh), bias)
    return args, dict(scale=dh ** -0.5, self_k=mk(B, nq, Hkv, dh), self_v=mk(B, nq, Hkv, dh))


@pytest.mark.parametrize("case", sorted(DV_CASES))
def test_dense_verify_emulation_without_rounding_equals_plain(case):
    args, kw = _dv_inputs(case)
    got = dense_verify_emulated(*args, **kw, rounding=None, chunk=DV_CASES[case][-1])
    torch.testing.assert_close(got, KD.dense_decode_attention_mq_plain(*args, **kw),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(DV_CASES))
def test_dense_verify_tensor_core_rounding_within_bf16_limit(case):
    """The dense verify kernel's rounding point (P as bf16 hi + lo; bf16 q
    and K multiply exactly) keeps the bf16 output within chip_smoke.py's
    limit of the f32 plain version; the masked row stays exact 0."""
    args, kw = _dv_inputs(case)
    got = dense_verify_emulated(*args, **kw, chunk=DV_CASES[case][-1]).to(torch.bfloat16)
    want = KD.dense_decode_attention_mq_plain(*args, **kw).to(torch.bfloat16)
    assert _worst(got, want) <= 1
    assert (got[-1] == 0).all()


K2_CASES = {
    # name: (B, T, H, Hkv, Hv, dh, dv, window)
    "narrow_window": (2, 150, 4, 2, 2, 64, 64, 37),
    "main_widths": (1, 640, 4, 2, 1, 128, 256, None),
    "main_widths_window": (1, 333, 4, 2, 1, 128, 256, 100),
}


def _k2_inputs(case, cases=K2_CASES):
    B, T, H, Hkv, Hv, dh, dv, win = cases[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
    q, k, v = (_bf16(mk(B, T, n, d)) for n, d in ((H, dh), (Hkv, dh), (Hv, dv)))
    return q, k, v, win


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_emulation_without_rounding_equals_plain(case):
    q, k, v, win = _k2_inputs(case)
    got = k2_emulated(q, k, v, window=win, rounding=None)
    want = K2.flash_prefill_attention_plain(q, k, v, window=win)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_tensor_core_rounding_within_bf16_limit(case):
    """K2's rounding points (bf16 operands, P as bf16 hi + lo) keep the
    bf16 output within chip_smoke.py's limit of the f32 plain version."""
    q, k, v, win = _k2_inputs(case)
    got = k2_emulated(q, k, v, window=win).to(torch.bfloat16)
    want = K2.flash_prefill_attention_plain(q, k, v, window=win).to(torch.bfloat16)
    assert _worst(got, want) <= 1


K2_SLICE_CASES = {
    # name: (B, T, H, Hkv, Hv, dh, dv, window); r_v of keep ratio 0.3 (one
    # 256-column slice, 104 columns zero) and of group_size 8 (two slices)
    "dv_152": (1, 200, 4, 2, 1, 128, 152, None),
    "dv_512": (1, 200, 4, 2, 1, 128, 512, 70),
}


@pytest.mark.parametrize("case", sorted(K2_SLICE_CASES))
def test_k2_value_slices_equal_plain(case):
    """K2 at a value width no instantiation has: its column slices with V
    zero-padded equal the plain version to the f32 limit without rounding,
    and stay within the bf16 limit with the kernel's rounding points."""
    q, k, v, win = _k2_inputs(case, K2_SLICE_CASES)
    want = K2.flash_prefill_attention_plain(q, k, v, window=win)
    torch.testing.assert_close(k2_sliced(q, k, v, window=win, rounding=None), want,
                               atol=F32_TOL, rtol=F32_TOL)
    got = k2_sliced(q, k, v, window=win).to(torch.bfloat16)
    assert _worst(got, want.to(torch.bfloat16)) <= 1


K4_CASES = {
    # name: (S, G, Hg, s, dh, r_k, r_v, tokens per row (None: masked row),
    #        the kernel's chunk at these widths)
    "narrow": (300, 2, 8, 4, 64, 32, 48, (300, 180, None), 256),
    "main_widths": (1024, 2, 16, 4, 128, 256, 256, (1024, 614, None), 256),
    "rank_384": (1024, 2, 16, 4, 128, 384, 384, (1024, 614, None), 128),
    # group_size 8 at rank s * dh: 64-column chunks, a short ring
    "group8_rank_1024": (300, 1, 32, 8, 128, 1024, 1024, (300, 180, None), 64),
}


def _k4_inputs(case):
    """A ragged ring view like chip_smoke.py's: row b holds its first
    lens[b] tokens (the tail has pos -1 and is masked), a None row is masked
    everywhere; bf16 latents, q, r_k (scaled by r^-1/2); f32 rotation
    tables and k-norm."""
    S, G, Hg, s, dh, rk, rv, lens, _ = K4_CASES[case]
    B = len(lens)
    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
    pos = torch.arange(S).repeat(B, 1)
    for b, n in enumerate(lens):
        pos[b, n or 0:] = -1
    cur = torch.full((B,), S)
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    bias = ops.decode_bias(pos, cur, None)
    self_cos, self_sin = ops.rope_tables_for(cur, dh, 1e6)
    a = dict(q=_bf16(mk(B, G, Hg, dh)), zk=_bf16(mk(B, S, G, rk)),
             zv=_bf16(mk(B, S, G, rv)), r_k=_bf16(mk(G, rk, s * dh) * rk ** -0.5),
             cos=cos, sin=sin, bias=bias)
    kw = dict(k_norm=0.1 * mk(dh), self_zk=_bf16(mk(B, G, rk)),
              self_zv=_bf16(mk(B, G, rv)), self_cos=self_cos, self_sin=self_sin)
    return a, kw


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_emulation_without_rounding_equals_plain(case):
    a, kw = _k4_inputs(case)
    args = [a[k] for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")]
    got = k4_emulated(*args, **kw, rounding=None, chunk=K4_CASES[case][-1])
    want = K1.latent_decode_attention_plain(*args, scale=a["q"].shape[-1] ** -0.5, **kw)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_tensor_core_rounding_within_bf16_limit(case):
    """K4's rounding points (rebuilt keys and P per 256-column chunk, 128
    past rank 256, as bf16 hi + lo) keep the bf16 output within
    chip_smoke.py's limit of the f32 plain version; the masked row stays
    exact 0 without its self column."""
    a, kw = _k4_inputs(case)
    chunk = K4_CASES[case][-1]
    args = [a[k] for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")]
    got = k4_emulated(*args, **kw, chunk=chunk).to(torch.bfloat16)
    want = K1.latent_decode_attention_plain(
        *args, scale=a["q"].shape[-1] ** -0.5, **kw).to(torch.bfloat16)
    assert _worst(got, want) <= 1
    no_self = {k: None for k in kw if k.startswith("self")}
    dead = k4_emulated(*args, k_norm=kw["k_norm"], **no_self, chunk=chunk)
    assert (dead[-1] == 0).all()


def test_k1_body_is_k4_emulated_on_the_ring():
    """K1's bf16 body is K4's with the ring's row map, so its rounding
    budget is ``k4_emulated``'s: on the ring the emulation stays within
    the bf16 limit of K1's plain version, and it equals itself on a
    shuffled pool's gathered view of the same ring bit for bit, though
    the view holds zeros where the ring's masked columns hold data (the
    kernel zero-fills masked columns; their P is exactly 0)."""
    a, kw = _k4_inputs("main_widths")
    args = [a[k] for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")]
    ring = k4_emulated(*args, **kw)
    want = K1.latent_decode_attention_plain(*args, scale=a["q"].shape[-1] ** -0.5, **kw)
    assert _worst(ring.to(torch.bfloat16), want.to(torch.bfloat16)) <= 1
    B, S = a["zk"].shape[:2]
    ps, live = 16, a["bias"] > NEG_INF * 0.5
    n_sp = S // ps
    used = live.reshape(B, n_sp, ps).any(-1)
    ptab = torch.zeros(B, n_sp, dtype=torch.int32)
    ptab[used] = (torch.randperm(int(used.sum()), generator=torch.Generator()
                                 .manual_seed(5)) + 1).to(torch.int32)
    view = {}
    for k in ("zk", "zv"):
        pool = torch.zeros((int(used.sum()) + 1, ps) + tuple(a[k].shape[2:]))
        pool[ptab[used].long()] = a[k].reshape((B, n_sp, ps) + tuple(a[k].shape[2:]))[used]
        view[k] = K1.gather_pages(pool, ptab)
    assert not torch.equal(view["zk"], a["zk"])
    paged = k4_emulated(a["q"], view["zk"], view["zv"], *args[3:], **kw)
    assert torch.equal(ring, paged)


K6_CASES = {
    # name: (B, S, G, Hg, s, nq, dh, r_k, r_v, tokens per row (None: masked
    #        row), the kernel's chunk at these widths)
    "narrow": (3, 300, 2, 4, 2, 3, 16, 8, 12, (300, 40, None), 128),
    "main_widths": (3, 1024, 2, 16, 4, 4, 128, 256, 256, (1024, 614, None), 128),
    # spec_depth 4 (two query blocks in the kernel) at rank 512
    "nq5_rank_512": (3, 512, 2, 16, 4, 5, 128, 512, 512, (512, 300, None), 128),
    # group_size 8 at rank 768: 64-column chunks, a short ring
    "group8_rank_768": (2, 300, 1, 32, 8, 4, 128, 768, 768, (300, None), 64),
}


def _k6_inputs(case):
    """An int8 ring like chip_smoke.py's K6 operands, ragged: row b holds
    its first lens[b] tokens, a None row is masked everywhere, row 0 drops
    its last fed token; int8 latents and f32 scales straight from numpy;
    bf16 q and r_k (scaled by r^-1/2); nq verify queries at positions
    cur..cur+nq-1 with their self columns.  Returns (ring operands, self
    keyword operands, the same columns appended to the ring)."""
    B, S, G, Hg, s, nq, dh, rk, rv, lens, _ = K6_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 6)
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
    i8 = lambda *sh: torch.from_numpy(rng.integers(-127, 128, sh, dtype=np.int8))
    sc = lambda *sh: torch.from_numpy(rng.uniform(0.005, 0.02, sh).astype(np.float32))
    pos = torch.arange(S).repeat(B, 1)
    for b, n in enumerate(lens):
        pos[b, n or 0:] = -1
    cur = torch.tensor([n or S for n in lens])
    pos_q = cur[:, None] + torch.arange(nq)
    feed = torch.ones(B, nq, dtype=torch.bool)
    feed[0, -1] = False
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    self_cos, self_sin = ops.rope_tables_for(pos_q, dh, 1e6)
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
    for b, n in enumerate(lens):
        if n is None:
            bias[b] = NEG_INF
    ring = dict(q=_bf16(mk(B, G, nq * Hg, dh)), zk_q=i8(B, S, G, rk), zk_s=sc(B, S, G),
                zv_q=i8(B, S, G, rv), zv_s=sc(B, S, G),
                r_k=_bf16(mk(G, rk, s * dh) * rk ** -0.5), cos=cos, sin=sin, bias=bias)
    selfs = dict(self_zk_q=i8(B, nq, G, rk), self_zk_s=sc(B, nq, G),
                 self_zv_q=i8(B, nq, G, rv), self_zv_s=sc(B, nq, G),
                 self_cos=self_cos, self_sin=self_sin)
    kn = 0.1 * mk(dh)
    appended = {k: torch.cat([ring[k], selfs["self_" + k]], 1)
                for k in ("zk_q", "zk_s", "zv_q", "zv_s", "cos", "sin")}
    return ring, selfs, kn, appended


def _k6_call(fn, ring, selfs, kn, **kw):
    order = ("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin", "bias")
    return fn(*[ring[k] for k in order], k_norm=kn, **selfs, **kw)


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_emulation_without_rounding_equals_plain(case):
    ring, selfs, kn, _ = _k6_inputs(case)
    got = _k6_call(k6_emulated, ring, selfs, kn, rounding=None, chunk=K6_CASES[case][-1])
    want = _k6_call(KQ.latent_decode_attention_mq_quant_plain, ring, selfs, kn,
                    scale=ring["q"].shape[-1] ** -0.5)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_k6_emulation_without_rounding_equals_pallas_interpret():
    """The narrow case against the JAX Pallas kernel in interpret mode,
    which takes the self columns appended to the ring (three 128-column
    chunks here, 64-column blocks there)."""
    ring, selfs, kn, app = _k6_inputs("narrow")
    got = _k6_call(k6_emulated, ring, selfs, kn, rounding=None)
    j = lambda t: jnp.asarray(t.numpy())
    want = jax_k6(j(ring["q"]), j(app["zk_q"]), j(app["zk_s"]), j(app["zv_q"]),
                  j(app["zv_s"]), j(ring["r_k"]), j(app["cos"]), j(app["sin"]),
                  j(ring["bias"]), scale=ring["q"].shape[-1] ** -0.5, block_s=64,
                  interpret=True, k_norm=j(kn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_tensor_core_rounding_within_bf16_limit(case):
    """K6's rounding points keep the bf16 output within chip_smoke.py's
    limit of the f32 plain version; the masked row stays exact 0, and so
    does every query row of a row whose bias is masked everywhere."""
    ring, selfs, kn, _ = _k6_inputs(case)
    got = _k6_call(k6_emulated, ring, selfs, kn, chunk=K6_CASES[case][-1]).to(torch.bfloat16)
    want = _k6_call(KQ.latent_decode_attention_mq_quant_plain, ring, selfs, kn,
                    scale=ring["q"].shape[-1] ** -0.5).to(torch.bfloat16)
    assert _worst(got, want) <= 1
    assert (got[-1] == 0).all()


K5_CASES = {
    # name: (B, S, G, Hg, s, nq, dh, r_k, r_v, tokens per row (None: masked
    #        row), the kernel's chunk at these widths)
    "narrow": (3, 300, 2, 4, 2, 3, 16, 8, 12, (300, 40, None), 128),
    "main_widths": (3, 1024, 2, 16, 4, 4, 128, 256, 256, (1024, 614, None), 128),
    # group_size 8 at rank s * dh: 64-column chunks, a short ring
    "group8_rank_1024": (2, 300, 1, 32, 8, 4, 128, 1024, 1024, (300, None), 64),
}


def _k5_inputs(case):
    """A bf16 ring like chip_smoke.py's K5 operands, ragged as in
    ``_k6_inputs`` (row 0 drops its last fed token, a None row is masked
    everywhere); bf16 latents, q and r_k (scaled by r^-1/2); nq verify
    queries at positions cur..cur+nq-1 with their self columns."""
    B, S, G, Hg, s, nq, dh, rk, rv, lens, _ = K5_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 5)
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
    pos = torch.arange(S).repeat(B, 1)
    for b, n in enumerate(lens):
        pos[b, n or 0:] = -1
    cur = torch.tensor([n or S for n in lens])
    pos_q = cur[:, None] + torch.arange(nq)
    feed = torch.ones(B, nq, dtype=torch.bool)
    feed[0, -1] = False
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    self_cos, self_sin = ops.rope_tables_for(pos_q, dh, 1e6)
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
    for b, n in enumerate(lens):
        if n is None:
            bias[b] = NEG_INF
    a = dict(q=_bf16(mk(B, G, nq * Hg, dh)), zk=_bf16(mk(B, S, G, rk)),
             zv=_bf16(mk(B, S, G, rv)), r_k=_bf16(mk(G, rk, s * dh) * rk ** -0.5),
             cos=cos, sin=sin, bias=bias)
    kw = dict(k_norm=0.1 * mk(dh), self_zk=_bf16(mk(B, nq, G, rk)),
              self_zv=_bf16(mk(B, nq, G, rv)), self_cos=self_cos, self_sin=self_sin)
    return a, kw


def _k5_call(fn, a, kw, **extra):
    return fn(*[a[k] for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")], **kw, **extra)


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_emulation_without_rounding_equals_plain(case):
    a, kw = _k5_inputs(case)
    got = _k5_call(k5_emulated, a, kw, rounding=None, chunk=K5_CASES[case][-1])
    want = _k5_call(K1.latent_decode_attention_mq_plain, a, kw,
                    scale=a["q"].shape[-1] ** -0.5)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_k5_emulation_without_rounding_equals_pallas_interpret():
    """The narrow case against the JAX Pallas kernel in interpret mode,
    which takes the self columns appended to the ring (three 128-column
    chunks here, 64-column blocks there)."""
    a, kw = _k5_inputs("narrow")
    got = _k5_call(k5_emulated, a, kw, rounding=None)
    j = lambda t: jnp.asarray(t.numpy())
    cat = lambda k: j(torch.cat([a[k], kw["self_" + k]], 1))
    want = jax_k5(j(a["q"]), cat("zk"), cat("zv"), j(a["r_k"]), cat("cos"), cat("sin"),
                  j(a["bias"]), scale=a["q"].shape[-1] ** -0.5, block_s=64, interpret=True,
                  k_norm=j(kw["k_norm"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_tensor_core_rounding_within_bf16_limit(case):
    """K5's rounding points (K6's, over bf16 latents) keep the bf16 output
    within chip_smoke.py's limit of the f32 plain version; the masked row
    stays exact 0, every query row of it."""
    a, kw = _k5_inputs(case)
    got = _k5_call(k5_emulated, a, kw, chunk=K5_CASES[case][-1]).to(torch.bfloat16)
    want = _k5_call(K1.latent_decode_attention_mq_plain, a, kw,
                    scale=a["q"].shape[-1] ** -0.5).to(torch.bfloat16)
    assert _worst(got, want) <= 1
    assert (got[-1] == 0).all()


K3_CASES = {
    # name: (B, S, G, Hg, s, dh, r_k, r_v, tokens per row (None: masked
    #        row), the kernel's chunk at these widths)
    "narrow": (3, 300, 2, 8, 4, 64, 32, 48, (300, 40, None), 256),
    "main_widths": (3, 1024, 2, 16, 4, 128, 256, 256, (1024, 614, None), 256),
    # group_size 8: one group of 32 query rows, rank 512
    "group8_rank_512": (2, 512, 1, 32, 8, 128, 512, 512, (512, None), 128),
}


def _k3_inputs(case):
    """An int8 ring like chip_smoke.py's K3 operands, ragged as in
    ``_k4_inputs``; int8 latents and f32 scales straight from numpy, bf16
    q and r_k; the self column at position ``lens[b]`` (the row's length,
    S for a masked row)."""
    B, S, G, Hg, s, dh, rk, rv, lens, _ = K3_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 3)
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
    i8 = lambda *sh: torch.from_numpy(rng.integers(-127, 128, sh, dtype=np.int8))
    sc = lambda *sh: torch.from_numpy(rng.uniform(0.005, 0.02, sh).astype(np.float32))
    pos = torch.arange(S).repeat(B, 1)
    for b, n in enumerate(lens):
        pos[b, n or 0:] = -1
    cur = torch.tensor([n or S for n in lens])
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    bias = ops.decode_bias(pos, cur, None)
    self_cos, self_sin = ops.rope_tables_for(cur, dh, 1e6)
    ring = dict(q=_bf16(mk(B, G, Hg, dh)), zk_q=i8(B, S, G, rk), zk_s=sc(B, S, G),
                zv_q=i8(B, S, G, rv), zv_s=sc(B, S, G),
                r_k=_bf16(mk(G, rk, s * dh) * rk ** -0.5), cos=cos, sin=sin, bias=bias)
    selfs = dict(self_zk_q=i8(B, G, rk), self_zk_s=sc(B, G), self_zv_q=i8(B, G, rv),
                 self_zv_s=sc(B, G), self_cos=self_cos, self_sin=self_sin)
    return ring, selfs, 0.1 * mk(dh)


def _k3_call(fn, ring, selfs, kn, **kw):
    order = ("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin", "bias")
    return fn(*[ring[k] for k in order], k_norm=kn, **selfs, **kw)


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_emulation_without_rounding_equals_plain(case):
    ring, selfs, kn = _k3_inputs(case)
    got = _k3_call(k3_emulated, ring, selfs, kn, rounding=None, chunk=K3_CASES[case][-1])
    want = _k3_call(KQ.latent_decode_attention_quant_plain, ring, selfs, kn,
                    scale=ring["q"].shape[-1] ** -0.5)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_k3_emulation_without_rounding_equals_pallas_interpret():
    """The narrow case against the JAX Pallas kernel in interpret mode,
    which takes the self column appended to the ring at bias 0 (two
    256-column chunks here, 64-column blocks there)."""
    ring, selfs, kn = _k3_inputs("narrow")
    got = _k3_call(k3_emulated, ring, selfs, kn, rounding=None)
    cat = lambda a, b: np.concatenate([a.numpy(), b.numpy()[:, None]], axis=1)
    app = {k: cat(ring[k], selfs["self_" + k]) for k in ("zk_q", "zk_s", "zv_q", "zv_s",
                                                         "cos", "sin")}
    app["bias"] = cat(ring["bias"], torch.zeros(ring["bias"].shape[0]))
    j = jnp.asarray
    want = jax_k3(j(ring["q"].numpy()), j(app["zk_q"]), j(app["zk_s"]), j(app["zv_q"]),
                  j(app["zv_s"]), j(ring["r_k"].numpy()), j(app["cos"]), j(app["sin"]),
                  j(app["bias"]), scale=ring["q"].shape[-1] ** -0.5, block_s=64,
                  interpret=True, k_norm=j(kn.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_tensor_core_rounding_within_bf16_limit(case):
    """K3's rounding points (K1's, with the key scale on each rebuilt row
    and the value scale on P before the hi / lo split) keep the bf16 output
    within chip_smoke.py's limit of the f32 plain version; the masked row
    stays exact 0 without its self column."""
    ring, selfs, kn = _k3_inputs(case)
    chunk = K3_CASES[case][-1]
    got = _k3_call(k3_emulated, ring, selfs, kn, chunk=chunk).to(torch.bfloat16)
    want = _k3_call(KQ.latent_decode_attention_quant_plain, ring, selfs, kn,
                    scale=ring["q"].shape[-1] ** -0.5).to(torch.bfloat16)
    assert _worst(got, want) <= 1
    dead = _k3_call(k3_emulated, ring, {}, kn, chunk=chunk)
    assert (dead[-1] == 0).all()


def _budgets():
    """{(kernel, case): {rounding: worst err / limit}} for every case."""
    out = {}
    for case in sorted(K2_CASES):
        q, k, v, win = _k2_inputs(case)
        want = K2.flash_prefill_attention_plain(q, k, v, window=win).to(torch.bfloat16)
        out["K2", case] = {r: _worst(k2_emulated(q, k, v, window=win, rounding=r)
                                     .to(torch.bfloat16), want) for r in ("split", "one")}
    for case in sorted(K4_CASES):
        a, kw = _k4_inputs(case)
        args = [a[n] for n in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")]
        want = K1.latent_decode_attention_plain(
            *args, scale=a["q"].shape[-1] ** -0.5, **kw).to(torch.bfloat16)
        out["K4", case] = {r: _worst(k4_emulated(*args, **kw, rounding=r,
                                                 chunk=K4_CASES[case][-1])
                                     .to(torch.bfloat16), want) for r in ("split", "one")}
    for case in sorted(K3_CASES):
        ring, selfs, kn = _k3_inputs(case)
        want = _k3_call(KQ.latent_decode_attention_quant_plain, ring, selfs, kn,
                        scale=ring["q"].shape[-1] ** -0.5).to(torch.bfloat16)
        out["K3", case] = {r: _worst(_k3_call(k3_emulated, ring, selfs, kn, rounding=r,
                                              chunk=K3_CASES[case][-1])
                                     .to(torch.bfloat16), want) for r in ("split", "one")}
    for case in sorted(K6_CASES):
        ring, selfs, kn, _ = _k6_inputs(case)
        want = _k6_call(KQ.latent_decode_attention_mq_quant_plain, ring, selfs, kn,
                        scale=ring["q"].shape[-1] ** -0.5).to(torch.bfloat16)
        out["K6", case] = {r: _worst(_k6_call(k6_emulated, ring, selfs, kn, rounding=r,
                                              chunk=K6_CASES[case][-1])
                                     .to(torch.bfloat16), want) for r in ("split", "one")}
    for case in sorted(K5_CASES):
        a, kw = _k5_inputs(case)
        want = _k5_call(K1.latent_decode_attention_mq_plain, a, kw,
                        scale=a["q"].shape[-1] ** -0.5).to(torch.bfloat16)
        out["K5", case] = {r: _worst(_k5_call(k5_emulated, a, kw, rounding=r,
                                              chunk=K5_CASES[case][-1])
                                     .to(torch.bfloat16), want) for r in ("split", "one")}
    for case in sorted(DV_CASES):
        args, kw = _dv_inputs(case)
        want = KD.dense_decode_attention_mq_plain(*args, **kw).to(torch.bfloat16)
        out["DV", case] = {r: _worst(dense_verify_emulated(*args, **kw, rounding=r,
                                                           chunk=DV_CASES[case][-1])
                                     .to(torch.bfloat16), want) for r in ("split", "one")}
    return out


def test_one_bf16_rounding_is_measured():
    """The split's reason, measured: one bf16 rounding of P (K2, the dense
    verify kernel "DV"), or of the keys and P (K3-K6), errs more than the
    split in every case, and at K2's main widths by more than twice."""
    b = _budgets()
    assert all(v["split"] < v["one"] for v in b.values())
    assert b["K2", "main_widths"]["one"] > 2 * b["K2", "main_widths"]["split"]


if __name__ == "__main__":
    # python tests/test_torch_tc_rounding.py [--ring]: the budgets as a
    # table; --ring adds K3-K6 on ragged rings of chip_smoke.py's widths
    # (4 rows of 1500-4096 tokens in S = 4096).
    import sys
    if "--ring" in sys.argv:
        K4_CASES["ring_4096"] = (4096, 2, 16, 4, 128, 256, 256, (1500, 4096, 2500, 3300),
                                 256)
        K6_CASES["ring_4096"] = (4, 4096, 2, 16, 4, 4, 128, 256, 256,
                                 (1500, 4096, 2500, 3300), 128)
        K5_CASES["ring_4096"] = (4, 4096, 2, 16, 4, 4, 128, 256, 256,
                                 (1500, 4096, 2500, 3300), 128)
        K3_CASES["ring_4096"] = (4, 4096, 2, 16, 4, 128, 256, 256,
                                 (1500, 4096, 2500, 3300), 256)
        DV_CASES["ring_4096"] = (4, 4096, 8, 4, 4, 128, (1500, 4096, 2500, 3300), 512)
    for (kern, case), v in sorted(_budgets().items()):
        print(f"{kern} {case:20s} worst err / limit: split {v['split']:.3f}, "
              f"one bf16 rounding {v['one']:.3f}")
