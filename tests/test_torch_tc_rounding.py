"""The precision budget of the bf16 tensor-core kernels, on the CPU.

K2 (``csrc/flash_prefill.cu``) and K4 (``csrc/latent_decode_paged.cu``)
multiply bf16 operands on tensor cores with f32 accumulation.  This file
emulates, in plain torch, the points where their bf16 bodies round, and
holds each emulation to ``chip_smoke.py``'s bf16 limit of the f32 plain
version, per element: |emulated - plain| <= 2e-2 |plain| + 1e-2 rms(plain).

* K2: S = Q K^T from bf16 operands in f32; an online softmax over 64-key
  tiles in f32; P enters P V as hi = bf16(P) plus lo = bf16(P - hi).  The
  kernel's exponent base may lag the running max by up to 2^8, which scales
  P and l alike and moves no rounding point.
* K4: keys rebuilt from bf16 latents and R_k in f32, normed and rotated in
  f32, then split into bf16 hi + lo for the scores; one softmax per
  256-column chunk with P split into bf16 hi + lo for P zv; chunks merged
  by log-sum-exp in f32.

One bf16 rounding of P (K2), or of the keys and P (K4), is what a plain
bf16 tensor-core design would do; ``test_one_bf16_rounding_is_measured``
records its error beside the split's.

Each emulation without its rounding must equal the plain version to the
float32 limit (1e-4), which checks its tiling, masks and merge.  Inputs are
made with numpy from fixed seeds, at a narrow shape and at the main path's
widths (dh = 128, r = 256, latent values dv = 256).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_prefill as K2
from repro_torch.kernels import latent_decode as K1
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


def k4_emulated(q, zk, zv, r_k, cos, sin, bias, *, k_norm, self_zk, self_zv,
                self_cos, self_sin, eps=1e-6, rounding="split", chunk=256):
    """K4's bf16 body on the table-gathered ring (its result depends only
    on the columns' content): keys and P split into bf16 hi + lo
    (``rounding="one"``: one bf16 rounding each; None: f32).  f32 values of
    bf16 q (B,G,Hg,dh), zk/zv (B,S,G,r), r_k (G,r,s*dh); an optional self
    column at bias 0.  Returns (B,G,Hg,rv) f32 before the output rounding."""
    rnd = {"split": _split, "one": _bf16}.get(rounding, lambda x: x)
    B, G, Hg, dh = q.shape
    s = r_k.shape[-1] // dh
    qpk = Hg // s
    if self_zk is not None:
        zk = torch.cat([zk, self_zk[:, None]], dim=1)
        zv = torch.cat([zv, self_zv[:, None]], dim=1)
        cos = torch.cat([cos, self_cos[:, None]], dim=1)
        sin = torch.cat([sin, self_sin[:, None]], dim=1)
        bias = torch.cat([bias, torch.zeros(B, 1)], dim=1)
    S = zk.shape[1]
    keys = torch.einsum("btgr,grn->bgtn", zk, r_k).reshape(B, G, S, s, dh)
    keys = keys * torch.rsqrt((keys * keys).mean(-1, keepdim=True) + eps)
    keys = keys * (1.0 + k_norm)
    half = dh // 2
    c, sn = cos[:, None, :, None], sin[:, None, :, None]
    k1_, k2_ = keys[..., :half], keys[..., half:]
    keys = torch.cat([k1_ * c - k2_ * sn, k2_ * c + k1_ * sn], dim=-1)
    keys = rnd(keys)
    qg = q.reshape(B, G, s, qpk, dh)
    sc = torch.einsum("bgsqd,bgtsd->bgsqt", qg, keys).reshape(B, G, Hg, S)
    sc = sc * dh ** -0.5 + bias[:, None, None, :]
    parts = []
    for t0 in range(0, S, chunk):
        x = sc[..., t0:t0 + chunk]
        m = x.max(dim=-1).values
        alive = m > NEG_INF * 0.5
        p = torch.where(alive[..., None], torch.exp(x - m[..., None]),
                        torch.zeros_like(x))
        acc = torch.einsum("bght,btgr->bghr", rnd(p), zv[:, t0:t0 + chunk])
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


K2_CASES = {
    # name: (B, T, H, Hkv, Hv, dh, dv, window)
    "narrow_window": (2, 150, 4, 2, 2, 64, 64, 37),
    "main_widths": (1, 640, 4, 2, 1, 128, 256, None),
    "main_widths_window": (1, 333, 4, 2, 1, 128, 256, 100),
}


def _k2_inputs(case):
    B, T, H, Hkv, Hv, dh, dv, win = K2_CASES[case]
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


K4_CASES = {
    # name: (S, G, Hg, s, dh, r_k, r_v, tokens per row; None: masked row)
    "narrow": (300, 2, 8, 4, 64, 32, 48, (300, 180, None)),
    "main_widths": (1024, 2, 16, 4, 128, 256, 256, (1024, 614, None)),
}


def _k4_inputs(case):
    """A ragged ring view like chip_smoke.py's: row b holds its first
    lens[b] tokens (the tail has pos -1 and is masked), a None row is masked
    everywhere; bf16 latents, q, r_k (scaled by r^-1/2); f32 rotation
    tables and k-norm."""
    S, G, Hg, s, dh, rk, rv, lens = K4_CASES[case]
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
    got = k4_emulated(*args, **kw, rounding=None)
    want = K1.latent_decode_attention_plain(*args, scale=a["q"].shape[-1] ** -0.5, **kw)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_tensor_core_rounding_within_bf16_limit(case):
    """K4's rounding points (rebuilt keys and P per 256-column chunk as
    bf16 hi + lo) keep the bf16 output within chip_smoke.py's limit of the
    f32 plain version; the masked row stays exact 0 without its self
    column."""
    a, kw = _k4_inputs(case)
    args = [a[k] for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")]
    got = k4_emulated(*args, **kw).to(torch.bfloat16)
    want = K1.latent_decode_attention_plain(
        *args, scale=a["q"].shape[-1] ** -0.5, **kw).to(torch.bfloat16)
    assert _worst(got, want) <= 1
    no_self = {k: None for k in kw if k.startswith("self")}
    dead = k4_emulated(*args, k_norm=kw["k_norm"], **no_self)
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
        out["K4", case] = {r: _worst(k4_emulated(*args, **kw, rounding=r)
                                     .to(torch.bfloat16), want) for r in ("split", "one")}
    return out


def test_one_bf16_rounding_is_measured():
    """The split's reason, measured: one bf16 rounding of P (K2), or of the
    keys and P (K4), errs more than the split in every case, and at K2's
    main widths by more than twice."""
    b = _budgets()
    assert all(v["split"] < v["one"] for v in b.values())
    assert b["K2", "main_widths"]["one"] > 2 * b["K2", "main_widths"]["split"]


if __name__ == "__main__":
    # python tests/test_torch_tc_rounding.py [--ring]: the budgets as a
    # table; --ring adds K4 on a ragged ring of chip_smoke.py's K4 widths
    # (4 rows of 1500-4096 tokens in S = 4096).
    import sys
    if "--ring" in sys.argv:
        K4_CASES["ring_4096"] = (4096, 2, 16, 4, 128, 256, 256, (1500, 4096, 2500, 3300))
    for (kern, case), v in sorted(_budgets().items()):
        print(f"{kern} {case:20s} worst err / limit: split {v['split']:.3f}, "
              f"one bf16 rounding {v['one']:.3f}")
