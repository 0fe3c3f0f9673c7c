"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: without a CUDA device each test skips (the kernels have
no CPU mode).  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: max |kernel - plain| <= 1e-4 in float32 (TF32 off; the
summation order differs) and <= 2e-2 in bf16 (one bf16 rounding of
outputs of order 1).  K3 / K6 compare with their plain versions on the
same int8 latents and scales.
"""

import math

import pytest
import torch

from repro_torch.kernels import flash_prefill as K2
from repro_torch.kernels import latent_decode as K1
from repro_torch.kernels import latent_decode_q as KQ
from repro_torch.kernels import ops
from repro_torch.quant import quantize

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
def test_k1_cuda_kernel_matches_plain(cuda, dtype, dh):
    """Ragged ring (S = 70), empty slots, a fully masked row (exact 0),
    k-norm, G = 2, and the self column; one launch counted per call."""
    g = torch.Generator(device=cuda).manual_seed(dh)
    B, S, G, s, qpk, rk, rv = 3, 70, 2, 4, 2, 32, 48
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    q, zk, zv = rn(B, G, s * qpk, dh), rn(B, S, G, rk), rn(B, S, G, rv)
    r_k = rn(G, rk, s * dh) / math.sqrt(rk)
    pos = torch.arange(S, device=cuda).repeat(B, 1)
    pos[1, 40:] = -1
    cur = torch.full((B,), S, device=cuda)
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    bias = ops.decode_bias(pos, cur, None)
    bias[2] = -1e30
    cs, ss = ops.rope_tables_for(cur, dh, 1e6)
    lat = [t.to(dtype) for t in (q, zk, zv, r_k, zk[:, 0], zv[:, 0])]
    args = (*lat[:4], cos, sin, bias)
    kn = 0.1 * rn(dh)
    for kw in ({}, dict(self_zk=lat[4], self_zv=lat[5], self_cos=cs, self_sin=ss)):
        n = K1.latent_decode_attention.launches
        got = K1.latent_decode_attention(*args, scale=dh ** -0.5, k_norm=kn, **kw)
        torch.cuda.synchronize()
        assert K1.latent_decode_attention.launches == n + 1
        want = K1.latent_decode_attention_plain(*args, scale=dh ** -0.5,
                                                k_norm=kn, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        if not kw:                  # the self column (bias 0) revives row 2
            assert (got[2] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_cuda_kernel_window_single_group_matches_plain(cuda, dtype):
    """G = 1, s = 4 slots of one query head each, dh = 128, a window."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, S, G, s, qpk, dh, r = 2, 45, 1, 4, 1, 128, 16
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    pos = torch.arange(S, device=cuda).repeat(B, 1)
    cur = torch.full((B,), S, device=cuda)
    cos, sin = ops.rope_tables_for(pos, dh, 1e4)
    bias = ops.decode_bias(pos, cur, 20)
    args = [t.to(dtype) for t in (rn(B, G, s * qpk, dh), rn(B, S, G, r),
                                  rn(B, S, G, r), rn(G, r, s * dh) / 4)]
    kn = 0.2 * rn(dh)
    got = K1.latent_decode_attention(*args, cos, sin, bias, scale=0.1, k_norm=kn)
    want = K1.latent_decode_attention_plain(*args, cos, sin, bias, scale=0.1,
                                            k_norm=kn)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,dv,Hkv,Hv", [(128, 256, 4, 2), (64, 64, 2, 2)])
def test_k2_cuda_kernel_matches_plain(cuda, dtype, dh, dv, Hkv, Hv):
    """Latent values (Hv < Hkv, dv != dh) and plain GQA; a T that is not a
    tile multiple; causal with and without a window."""
    g = torch.Generator(device=cuda).manual_seed(dh + dv)
    q = torch.randn(2, 100, 8, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 100, Hkv, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 100, Hv, dv, generator=g, device=cuda).to(dtype)
    for win in (None, 30):
        n = K2.flash_prefill_attention.launches
        got = K2.flash_prefill_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        assert K2.flash_prefill_attention.launches == n + 1
        want = K2.flash_prefill_attention_plain(q, k, v, window=win)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def _quant(x):
    """int8 latents and (..., G) scales of a (..., G, r) tensor."""
    q, sc = quantize(x, 8)
    return q, sc[..., 0]


def _ring(cuda, seed, B=3, S=70, G=2, s=4, qpk=2, dh=128, rk=32, rv=48, nq=1):
    """A ragged ring (row 1 half empty), a fully masked row 2, k-norm,
    nq verify queries with their self columns (feed mask drops row 0's
    last column), all float32 on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    pos = torch.arange(S, device=cuda).repeat(B, 1)
    pos[1, 40:] = -1
    cur = torch.full((B,), S, device=cuda)
    pos_q = cur[:, None] + torch.arange(nq, device=cuda)
    feed = torch.ones(B, nq, dtype=torch.bool, device=cuda)
    feed[0, -1] = nq == 1
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    cs, ss = ops.rope_tables_for(pos_q, dh, 1e6)
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
    bias[2] = -1e30
    return dict(q=rn(B, G, nq * s * qpk, dh), zk=rn(B, S, G, rk), zv=rn(B, S, G, rv),
                r_k=rn(G, rk, s * dh) / math.sqrt(rk), cos=cos, sin=sin, bias=bias,
                k_norm=0.1 * rn(dh), self_zk=rn(B, nq, G, rk), self_zv=rn(B, nq, G, rv),
                self_cos=cs, self_sin=ss)


def _check(kernel, plain, args, kw, dtype, counter):
    n = counter.launches
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n + 1
    want = plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
def test_k3_cuda_kernel_matches_plain(cuda, dtype, dh):
    """int8 ring with per-(token, group) scales; the self column is the
    quantized fresh latent; a dead row stays exact 0 without it."""
    a = _ring(cuda, 30 + dh, dh=dh)
    zk_q, zk_s = _quant(a["zk"])
    zv_q, zv_s = _quant(a["zv"])
    sk_q, sk_s = _quant(a["self_zk"][:, 0])
    sv_q, sv_s = _quant(a["self_zv"][:, 0])
    args = (a["q"].to(dtype), zk_q, zk_s, zv_q, zv_s, a["r_k"].to(dtype), a["cos"],
            a["sin"], a["bias"][:, 0, :-1].contiguous())
    selfs = dict(self_zk_q=sk_q, self_zk_s=sk_s, self_zv_q=sv_q, self_zv_s=sv_s,
                 self_cos=a["self_cos"][:, 0], self_sin=a["self_sin"][:, 0])
    for kw in ({}, selfs):
        got = _check(KQ.latent_decode_attention_quant,
                     KQ.latent_decode_attention_quant_plain, args,
                     dict(scale=dh ** -0.5, k_norm=a["k_norm"], **kw), dtype,
                     KQ.latent_decode_attention_quant)
        if not kw:
            assert (got[2] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [1, 4])
def test_k5_cuda_kernel_matches_plain_and_k1(cuda, dtype, nq):
    """nq verify queries over [ragged ring | nq self columns] with a
    causal self block and a dropped feed column; at nq = 1 it equals K1
    with its self column."""
    a = _ring(cuda, 50 + nq, nq=nq)
    t = {k: (v.to(dtype) if k in ("q", "zk", "zv", "r_k", "self_zk", "self_zv") else v)
         for k, v in a.items()}
    args = (t["q"], t["zk"], t["zv"], t["r_k"], t["cos"], t["sin"], t["bias"])
    kw = dict(scale=0.1, k_norm=t["k_norm"], self_zk=t["self_zk"], self_zv=t["self_zv"],
              self_cos=t["self_cos"], self_sin=t["self_sin"])
    got = _check(K1.latent_decode_attention_mq, K1.latent_decode_attention_mq_plain,
                 args, kw, dtype, K1.latent_decode_attention_mq)
    assert (got[2] == 0).all()
    if nq == 1:
        one = K1.latent_decode_attention(
            *args[:6], t["bias"][:, 0, :-1].contiguous(), scale=0.1, k_norm=t["k_norm"],
            self_zk=t["self_zk"][:, 0], self_zv=t["self_zv"][:, 0],
            self_cos=t["self_cos"][:, 0], self_sin=t["self_sin"][:, 0])
        # rows 0-1 (row 2's self column is masked in K5's bias, live in K1's)
        torch.testing.assert_close(got[:2].float(), one[:2].float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_cuda_kernel_matches_plain(cuda, dtype):
    """K5 over the int8 ring, dh = 64 and 128, nq = 4."""
    for dh in (64, 128):
        a = _ring(cuda, 70 + dh, dh=dh, nq=4)
        q8 = {k: _quant(a[k]) for k in ("zk", "zv", "self_zk", "self_zv")}
        args = (a["q"].to(dtype), *q8["zk"], *q8["zv"], a["r_k"].to(dtype), a["cos"],
                a["sin"], a["bias"])
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_zk_q=q8["self_zk"][0],
                  self_zk_s=q8["self_zk"][1], self_zv_q=q8["self_zv"][0],
                  self_zv_s=q8["self_zv"][1], self_cos=a["self_cos"],
                  self_sin=a["self_sin"])
        got = _check(KQ.latent_decode_attention_mq_quant,
                     KQ.latent_decode_attention_mq_quant_plain, args, kw, dtype,
                     KQ.latent_decode_attention_mq_quant)
        assert (got[2] == 0).all()


@pytest.mark.gpu
def test_cuda_wrappers_reject_unsupported_inputs(cuda):
    """No silent fallback: shapes the kernels were not built for raise."""
    x = torch.randn(1, 8, 4, 96, device=cuda)
    with pytest.raises(ValueError, match="instantiation"):
        K2.flash_prefill_attention(x, x, x)
    q = torch.randn(1, 1, 2, 96, device=cuda)
    z = torch.randn(1, 4, 1, 8, device=cuda)
    tab = torch.zeros(1, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="dh must be 64 or 128"):
        K1.latent_decode_attention(q, z, z, torch.randn(1, 8, 192, device=cuda),
                                   tab, tab, torch.zeros(1, 4, device=cuda), scale=1.0)
    # nq = 5 verify rows at the main path's width need more shared memory
    # than a block has in f32; the wrapper raises instead of falling back
    qm = torch.randn(1, 2, 5 * 16, 128, device=cuda)
    zm = torch.randn(1, 8, 2, 256, device=cuda)
    tm = torch.zeros(1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        K1.latent_decode_attention_mq(qm, zm, zm, torch.randn(2, 256, 512, device=cuda),
                                      tm, tm, torch.zeros(1, 5, 8, device=cuda), scale=1.0)
