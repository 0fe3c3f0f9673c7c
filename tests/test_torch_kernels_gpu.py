"""The port's CUDA kernels against their plain PyTorch versions, on a card,
at every head width the bodies take (d_head 64, 80, 128, 256; q_per_kv up
to 16: h2o-danube-1.8b's and qwen3-moe-235b-a22b's widths are cases of
their own).

Marked ``gpu``: without a CUDA device each test skips (the kernels have
no CPU mode).  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: max |kernel - plain| <= 1e-4 in float32 (TF32 off; the
summation order differs) and <= 2e-2 in bf16 (one bf16 rounding of
outputs of order 1); the bf16 tensor-core bodies of K2 and K4 are also held
to chip_smoke.py's per-element limit 2e-2 |plain| + 1e-2 rms(plain) at the
main path's widths, and so are K3's, K5's, K6's and K7's, K2 at other
value widths and every decode body at 32 query rows per group (group_size
8) and at every rank up to s * dh (64-column chunks past the wider
plans).  K3 / K6 compare with their plain versions on the same int8
latents and scales.  K7 (the paged pool) and K4 must also equal K5 / K1
on the table-gathered ring bit for bit, in both types: they run the same
tiles in the same order on the same values (in bf16 K4 / K7 and K1 / K5
are one tensor-core body with two row maps).  The dense cores
(``ops.dense_decode*``: the dense decode kernel and the dense verify kernel,
each on the ring and the pool) are held to the same rules, the pool equal
to the ring on the gathered view bit for bit, a row that sees only one
self column returns that self value exactly, and a row masked everywhere
exact 0; the float32
template to 1e-4 at every width the bf16 bodies serve
(group_size 8, ranks 768 / 1,024, up to 8 verify queries); and one
full-width ``compress_attention_layer`` on the card to the CPU's by
product (1e-3 of the product's largest entry: cuSOLVER's and LAPACK's
f32 SVDs differ in their last bits).  Continuous batching's install: its
row copy (``csrc/stage_install.cu``) equals its plain version bit for
bit, idle and installing, and a replayed continuous window serves the
eager continuous window's streams.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import dense_decode as KD
from repro_torch.kernels import flash_prefill as K2
from repro_torch.kernels import latent_decode as K1
from repro_torch.kernels import latent_decode_q as KQ
from repro_torch.kernels import ops
from repro_torch.models.config import ReCalKVRuntime
from repro_torch.models.weights import init_params
from repro_torch.quant import quantize
from repro_torch.serving import Engine, Request, SamplingParams

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _within_bf16_limit(got, want):
    """chip_smoke.py's bf16 rule: |got - want| <= 2e-2 |want| + 1e-2 rms(want)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    limit = 2e-2 * want.abs() + 1e-2 * want.square().mean().sqrt()
    worst = ((got - want).abs() / limit).max().item()
    assert worst <= 1, f"worst err / limit {worst:.3f}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 80, 128, 256])
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
@pytest.mark.parametrize("dh,dv,H,Hkv,Hv", [(128, 256, 8, 4, 2), (64, 64, 8, 2, 2),
                                            (256, 256, 8, 4, 4), (256, 512, 8, 4, 2),
                                            (80, 80, 8, 2, 2), (80, 160, 8, 4, 2),
                                            (128, 128, 64, 4, 4), (128, 256, 64, 4, 1)])
def test_k2_cuda_kernel_matches_plain(cuda, dtype, dh, dv, H, Hkv, Hv):
    """Latent values (Hv < Hkv, dv != dh) and plain GQA, at dh 80
    (h2o-danube-1.8b: 5 k-steps over 128-column tiles) and 16 query heads
    a kv head (qwen3-moe-235b-a22b); a T that is not a tile multiple;
    causal with and without a window."""
    g = torch.Generator(device=cuda).manual_seed(dh + dv + H)
    q = torch.randn(2, 100, H, dh, generator=g, device=cuda).to(dtype)
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


@pytest.mark.gpu
@pytest.mark.parametrize("T", [2048, 1000])
def test_k2_bf16_tensor_cores_ragged_windowed(cuda, T):
    """The bf16 tensor-core body at the main path's widths (dh 128, latent
    values dv 256, Hv 2 < Hkv 4): T a multiple of the 128-row query tile
    and a ragged one, causal with and without a 300-key window (windowed
    query tiles skip their first key tiles, and rows that see no key of a
    loaded tile keep an empty softmax state)."""
    g = torch.Generator(device=cuda).manual_seed(T)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = rn(1, T, 8, 128), rn(1, T, 4, 128), rn(1, T, 2, 256)
    for win in (None, 300):
        n = K2.flash_prefill_attention.launches
        got = K2.flash_prefill_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        assert K2.flash_prefill_attention.launches == n + 1
        _within_bf16_limit(got, K2.flash_prefill_attention_plain(q, k, v, window=win))


@pytest.mark.gpu
@pytest.mark.parametrize("dh,dv", [(128, 256), (64, 64), (256, 256)])
def test_k2_bf16_single_key_rows_are_exact(cuda, dh, dv):
    """The dead-row check of K2.  Its masks always leave a row its own key,
    so no output row is dead, but with window 1 every loaded tile except
    the diagonal one is dead for each row: such a row must keep its empty
    softmax state (m = NEG_INF, l = 0) and its masked keys must add exact
    zeros.  Then P is exactly 1 on the diagonal and each output row is its
    value row bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(dh)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = rn(2, 333, 8, dh), rn(2, 333, 4, dh), rn(2, 333, 2, dv)
    got = K2.flash_prefill_attention(q, k, v, window=1)
    torch.cuda.synchronize()
    assert torch.equal(got, v.repeat_interleave(4, dim=2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dv", [128, 152, 384, 512])
def test_k2_serves_any_value_width(cuda, dtype, dv):
    """K2 at value widths of other ranks (r_v = 152 at keep ratio 0.3, 384,
    512 at group_size 8; 128 for the dense cache): one 128-column slice,
    one 256-column slice whose last 104 columns are zero-filled, and two
    256-column slices along the grid; T ragged, causal with and without a
    window, one value group (G = 1).  float32 within 1e-4, bf16 within
    chip_smoke.py's limit; one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(dv)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(dtype)
    q, k, v = rn(2, 300, 8, 128), rn(2, 300, 2, 128), rn(2, 300, 1, dv)
    for win in (None, 100):
        n = K2.flash_prefill_attention.launches
        got = K2.flash_prefill_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        assert K2.flash_prefill_attention.launches == n + 1
        want = K2.flash_prefill_attention_plain(q, k, v, window=win)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
        else:
            _within_bf16_limit(got, want)


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
@pytest.mark.parametrize("dh", [64, 80, 128, 256])
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
@pytest.mark.parametrize("dh", [64, 80, 128, 256])
def test_k3_bf16_tensor_cores_ragged_int8_ring(cuda, dh):
    """bf16 K3 (K1's tensor-core body over int8 latents) at the main path's
    group width (Hg 16, s 4, r_k = r_v = 256) on a ragged int8 ring of two
    256-column chunks: row 1 is live below position 40 only (null tiles
    and a dead chunk), row 2 is masked everywhere and ends as exact 0
    without its self column, or with it (its only live column) as that
    column's dequantized value latent to one bf16 step (the value scale
    enters as bf16 hi + lo); within the bf16 limit of the plain version,
    one launch per call."""
    a = _ring(cuda, 210 + dh, S=300, qpk=4, dh=dh, rk=256, rv=256)
    zk_q, zk_s = _quant(a["zk"])
    zv_q, zv_s = _quant(a["zv"])
    sk_q, sk_s = _quant(a["self_zk"][:, 0])
    sv_q, sv_s = _quant(a["self_zv"][:, 0])
    bf = torch.bfloat16
    args = (a["q"].to(bf), zk_q, zk_s, zv_q, zv_s, a["r_k"].to(bf), a["cos"], a["sin"],
            a["bias"][:, 0, :-1].contiguous())
    selfs = dict(self_zk_q=sk_q, self_zk_s=sk_s, self_zv_q=sv_q, self_zv_s=sv_s,
                 self_cos=a["self_cos"][:, 0], self_sin=a["self_sin"][:, 0])
    for kw in ({}, selfs):
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], **kw)
        got = _check_bf16(KQ.latent_decode_attention_quant,
                          KQ.latent_decode_attention_quant_plain, args, kw)
        if "self_zk_q" in kw:
            want = (sv_q[2].float() * sv_s[2][:, None])[:, None].expand(got[2].shape)
            torch.testing.assert_close(got[2].float(), want, atol=0, rtol=2 ** -7)
        else:
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
@pytest.mark.parametrize("nq", [1, 4])
def test_dh256_k5_k7_at_gemma3_widths(cuda, dtype, nq):
    """K5 (and K7 through a shuffled pool of the same ring) at gemma3-12b's
    latent widths: dh 256, s 4 kv heads of q_per_kv 2 (Hg 8), r 512, on a
    ragged ring of five 64-column chunks (the only plan at dh 256): within
    1e-4 (f32) or the bf16 limit of the plain version, row 2 exact 0, and
    K7 equal to K5 bit for bit."""
    a = _ring(cuda, 260 + nq, S=320, qpk=2, dh=256, rk=512, rv=512, nq=nq)
    t = {k: (v.to(dtype) if k in ("q", "zk", "zv", "r_k", "self_zk", "self_zv") else v)
         for k, v in a.items()}
    args = (t["q"], t["zk"], t["zv"], t["r_k"], t["cos"], t["sin"], t["bias"])
    kw = dict(scale=256 ** -0.5, k_norm=t["k_norm"], self_zk=t["self_zk"],
              self_zv=t["self_zv"], self_cos=t["self_cos"], self_sin=t["self_sin"])
    n = K1.latent_decode_attention_mq.launches
    got = K1.latent_decode_attention_mq(*args, **kw)
    torch.cuda.synchronize()
    assert K1.latent_decode_attention_mq.launches == n + 1
    want = K1.latent_decode_attention_mq_plain(*args, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _within_bf16_limit(got, want)
    assert (got[2] == 0).all()
    ptab, *pools = _shuffled_pool(t["zk"], t["zv"], 16, 261)
    paged = K1.latent_decode_attention_mq_paged(ptab, t["q"], *pools, *args[3:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_cuda_kernel_matches_plain(cuda, dtype):
    """K5 over the int8 ring, dh = 64, 128 and 256, nq = 4."""
    for dh in (64, 128, 256):
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,G,s,qpk,r", [(80, 2, 4, 4, 160), (128, 1, 4, 16, 256),
                                         (80, 1, 2, 16, 160), (80, 1, 8, 4, 640)])
def test_latent_bodies_at_dh80_and_q_per_kv16(cuda, dtype, dh, G, s, qpk, r):
    """K1, K3, K4 (one query) and K5, K6, K7 (nq 4) at h2o-danube-1.8b's
    latent widths (dh 80: Hg 16, r 160), qwen3-moe-235b-a22b's (q_per_kv
    16: G 1, Hg 64, r 256), both at once, and dh 80 at group_size 8 and
    rank s * dh = 640 (the 32-row R_k stages), on a ragged 320-column ring
    with self columns: within 1e-4 (f32) or the bf16 limit of the plain
    version, one launch a call, the masked row 2 exact 0 without its self
    column, and K4 / K7 on a shuffled page-16 pool equal to K1 / K5 bit
    for bit."""
    def check(kernel, plain, args, kw):
        n = kernel.launches
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == n + 1
        want = plain(*args, **kw)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            _within_bf16_limit(got, want)
        return got

    for nq in (1, 4):
        a = _ring(cuda, 800 + dh + qpk + nq + r, S=320, G=G, s=s, qpk=qpk, dh=dh, rk=r,
                  rv=r, nq=nq)
        t = {k: (v.to(dtype) if k in ("q", "zk", "zv", "r_k", "self_zk", "self_zv")
                 else v) for k, v in a.items()}
        ptab, *pools = _shuffled_pool(t["zk"], t["zv"], 16, 801)
        q8 = {k: _quant(a[k]) for k in ("zk", "zv", "self_zk", "self_zv")}
        base = dict(scale=dh ** -0.5, k_norm=t["k_norm"])
        if nq == 1:
            bias = t["bias"][:, 0, :-1].contiguous()
            args = (t["q"], t["zk"], t["zv"], t["r_k"], t["cos"], t["sin"], bias)
            kw = dict(base, self_zk=t["self_zk"][:, 0], self_zv=t["self_zv"][:, 0],
                      self_cos=t["self_cos"][:, 0], self_sin=t["self_sin"][:, 0])
            assert (check(K1.latent_decode_attention, K1.latent_decode_attention_plain,
                          args, base)[2] == 0).all()
            ring = check(K1.latent_decode_attention, K1.latent_decode_attention_plain,
                         args, kw)
            paged = check(K1.latent_decode_attention_paged,
                          K1.latent_decode_attention_paged_plain,
                          (ptab, t["q"], *pools, *args[3:]), kw)
            assert torch.equal(ring, paged)
            qargs = (t["q"], *q8["zk"], *q8["zv"], t["r_k"], t["cos"], t["sin"], bias)
            qkw = dict(base, self_zk_q=q8["self_zk"][0][:, 0],
                       self_zk_s=q8["self_zk"][1][:, 0], self_zv_q=q8["self_zv"][0][:, 0],
                       self_zv_s=q8["self_zv"][1][:, 0], self_cos=t["self_cos"][:, 0],
                       self_sin=t["self_sin"][:, 0])
            check(KQ.latent_decode_attention_quant, KQ.latent_decode_attention_quant_plain,
                  qargs, qkw)
        else:
            args = (t["q"], t["zk"], t["zv"], t["r_k"], t["cos"], t["sin"], t["bias"])
            kw = dict(base, self_zk=t["self_zk"], self_zv=t["self_zv"],
                      self_cos=t["self_cos"], self_sin=t["self_sin"])
            ring = check(K1.latent_decode_attention_mq, K1.latent_decode_attention_mq_plain,
                         args, kw)
            assert (ring[2] == 0).all()
            paged = check(K1.latent_decode_attention_mq_paged,
                          K1.latent_decode_attention_mq_paged_plain,
                          (ptab, t["q"], *pools, *args[3:]), kw)
            assert torch.equal(ring, paged)
            qargs = (t["q"], *q8["zk"], *q8["zv"], t["r_k"], t["cos"], t["sin"], t["bias"])
            qkw = dict(base, self_zk_q=q8["self_zk"][0], self_zk_s=q8["self_zk"][1],
                       self_zv_q=q8["self_zv"][0], self_zv_s=q8["self_zv"][1],
                       self_cos=t["self_cos"], self_sin=t["self_sin"])
            check(KQ.latent_decode_attention_mq_quant,
                  KQ.latent_decode_attention_mq_quant_plain, qargs, qkw)


def _paged(cuda, a, ps, seed):
    """Page ``_ring``'s rows into a shuffled pool: row 1 shares row 0's
    first page, row 1's pages past its length and all of row 2 (whose
    bias is masked) sit on the null page 0.  Returns (ptab, zk pool, zv
    pool) in float32."""
    B, S = a["zk"].shape[:2]
    n_sp = S // ps
    for k in ("zk", "zv"):
        a[k][1, :ps] = a[k][0, :ps]
    g = torch.Generator().manual_seed(seed)
    perm = (torch.randperm(B * n_sp, generator=g) + 1).tolist()
    ptab = torch.zeros(B, n_sp, dtype=torch.int32)
    for j in range(n_sp):
        ptab[0, j] = perm.pop()
    ptab[1, 0] = ptab[0, 0]
    for j in range(1, 40 // ps + 1):      # row 1 is valid below position 40
        ptab[1, j] = perm.pop()
    pools = {}
    for k in ("zk", "zv"):
        pool = torch.zeros((B * n_sp + 1, ps) + tuple(a[k].shape[2:]), device=cuda)
        for b in range(B):
            for j in range(n_sp):
                if ptab[b, j]:
                    pool[ptab[b, j]] = a[k][b, j * ps:(j + 1) * ps]
        pools[k] = pool
    return ptab.to(cuda), pools["zk"], pools["zv"]


def _in_order(ptab, *pools):
    """The same content through a second table: every mapped slot page at
    its own physical page, in row-major slot order."""
    mapped = ptab != 0
    order = torch.zeros_like(ptab)
    order[mapped] = torch.arange(1, int(mapped.sum()) + 1, device=ptab.device,
                                 dtype=ptab.dtype)
    out = []
    for pool in pools:
        p = torch.zeros((int(mapped.sum()) + 1,) + tuple(pool.shape[1:]),
                        device=pool.device, dtype=pool.dtype)
        p[order[mapped].long()] = pool[ptab[mapped].long()]
        out.append(p)
    return order, *out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,ps", [(64, 8), (80, 16), (128, 16), (256, 16)])
def test_k4_cuda_kernel_matches_plain_and_k1_on_view(cuda, dtype, dh, ps):
    """The paged pool through a ragged table (shuffled pages, null pages,
    one page shared by two rows; page_size below the kernels' tiles), with
    and without the self column: K4 against its plain version, and bit for
    bit against K1 on the gathered ring (float32: the template's parity
    instantiations; bf16: the tensor-core body with two row maps); in bf16
    also bit for bit against itself on an in-order placement of the same
    pages."""
    a = _ring(cuda, 90 + dh, S=6 * ps, dh=dh)
    ptab, pzk, pzv = _paged(cuda, a, ps, dh)
    S = 6 * ps
    q, r_k = a["q"].to(dtype), a["r_k"].to(dtype)
    pzk, pzv = pzk.to(dtype), pzv.to(dtype)
    bias = a["bias"][:, 0, :S].contiguous()
    selfs = dict(self_zk=a["self_zk"][:, 0].to(dtype), self_zv=a["self_zv"][:, 0].to(dtype),
                 self_cos=a["self_cos"][:, 0], self_sin=a["self_sin"][:, 0])
    order, ozk, ozv = _in_order(ptab, pzk, pzv)
    for kw in ({}, selfs):
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], **kw)
        tables = (a["cos"], a["sin"], bias)
        got = _check(K1.latent_decode_attention_paged,
                     K1.latent_decode_attention_paged_plain,
                     (ptab, q, pzk, pzv, r_k, *tables), kw, dtype,
                     K1.latent_decode_attention_paged)
        view = K1.latent_decode_attention(
            q, K1.gather_pages(pzk, ptab), K1.gather_pages(pzv, ptab), r_k, *tables, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, view)
        if dtype == torch.bfloat16:
            again = K1.latent_decode_attention_paged(order, q, ozk, ozv, r_k, *tables, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
        if "self_zk" not in kw:
            assert (got[2] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dh,ps", [(64, 8), (128, 16)])
def test_k4_bf16_null_page_tiles_and_dead_row(cuda, dh, ps):
    """bf16 K4 over 40 slot pages (three 256-column blocks): row 1 is live
    below position 40 only, so whole tiles and whole blocks of it sit on
    the null page and are skipped; row 2 is masked everywhere and ends as
    exact 0, or, with the self column (bias 0) its only live column, as
    that column's value latent bit for bit."""
    S = 40 * ps
    a = _ring(cuda, 130 + dh, S=S, dh=dh, rk=64, rv=64)
    ptab, pzk, pzv = _paged(cuda, a, ps, dh + 2)
    bf = torch.bfloat16
    q, r_k, pzk, pzv = a["q"].to(bf), a["r_k"].to(bf), pzk.to(bf), pzv.to(bf)
    bias = a["bias"][:, 0, :S].contiguous()
    self_zv = a["self_zv"][:, 0].to(bf)
    selfs = dict(self_zk=a["self_zk"][:, 0].to(bf), self_zv=self_zv,
                 self_cos=a["self_cos"][:, 0], self_sin=a["self_sin"][:, 0])
    for kw in ({}, selfs):
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], **kw)
        args = (ptab, q, pzk, pzv, r_k, a["cos"], a["sin"], bias)
        got = K1.latent_decode_attention_paged(*args, **kw)
        torch.cuda.synchronize()
        _within_bf16_limit(got, K1.latent_decode_attention_paged_plain(*args, **kw))
        if "self_zk" in kw:
            assert torch.equal(got[2], self_zv[2][:, None].expand_as(got[2]))
        else:
            assert (got[2] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dh,ps,rk,rv", [(64, 8, 64, 64), (128, 16, 64, 64),
                                         (128, 16, 152, 200), (128, 16, 384, 384),
                                         (128, 16, 512, 512), (256, 16, 512, 512)])
def test_k1_bf16_equals_k4_on_shuffled_pool(cuda, dh, ps, rk, rv):
    """bf16 K1 on a ragged ring of three 256-column chunks (six 128-column
    ones past rank 256) against bf16 K4 on a pool holding every page of
    that ring at shuffled physical pages: the same tensor-core body with
    two row maps and one block plan, so equal bit for bit, with and
    without the self column; and within the bf16 limit of the plain
    version.  r_k = 152 is padded to 160 inside the kernel; 384 and 512
    (recalkv ratios 0.75 and 1) take 128-column chunks."""
    S = 40 * ps
    a = _ring(cuda, 150 + dh + rk, S=S, dh=dh, rk=rk, rv=rv)
    bf = torch.bfloat16
    q, r_k, zk, zv = (a[k].to(bf) for k in ("q", "r_k", "zk", "zv"))
    ptab, *pools = _shuffled_pool(zk, zv, ps, dh)
    bias = a["bias"][:, 0, :S].contiguous()
    selfs = dict(self_zk=a["self_zk"][:, 0].to(bf), self_zv=a["self_zv"][:, 0].to(bf),
                 self_cos=a["self_cos"][:, 0], self_sin=a["self_sin"][:, 0])
    for kw in ({}, selfs):
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], **kw)
        ring = _check_bf16(K1.latent_decode_attention, K1.latent_decode_attention_plain,
                           (q, zk, zv, r_k, a["cos"], a["sin"], bias), kw)
        paged = K1.latent_decode_attention_paged(ptab, q, *pools, r_k, a["cos"], a["sin"],
                                                 bias, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ring, paged)
        if "self_zk" not in kw:
            assert (ring[2] == 0).all()


def _shuffled_pool(zk, zv, ps, seed):
    """Every page of the rings ``zk``, ``zv`` (B, S, G, r) at a shuffled
    physical page of a pool (page 0 unused): (ptab, zk pool, zv pool)."""
    B, S = zk.shape[:2]
    n_sp = S // ps
    g = torch.Generator().manual_seed(seed)
    ptab = (torch.randperm(B * n_sp, generator=g) + 1).reshape(B, n_sp)
    ptab = ptab.to(device=zk.device, dtype=torch.int32)
    pools = []
    for z in (zk, zv):
        pool = torch.zeros((B * n_sp + 1, ps) + tuple(z.shape[2:]), device=z.device,
                           dtype=z.dtype)
        pool[ptab.reshape(-1).long()] = z.reshape((B * n_sp, ps) + tuple(z.shape[2:]))
        pools.append(pool)
    return ptab, *pools


def _check_bf16(kernel, plain, args, kw):
    """One launch of a bf16 tensor-core body, counted, within chip_smoke.py's
    bf16 limit of its plain version."""
    n = kernel.launches
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    _within_bf16_limit(got, plain(*args, **kw))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 80, 128, 256])
def test_k6_bf16_tensor_cores_ragged_int8_ring(cuda, dh):
    """bf16 K6 at the main path's group width (Hg 16, s 4, nq 4: 64 score
    rows, r_k = r_v = 256) on a ragged int8 ring of three 128-column chunks
    and 4 self columns: row 1 is live below position 40 only (null tiles
    and chunks), row 2 is masked everywhere (an idle slot: exact 0), and
    query 1 of row 0 is masked everywhere (its rows exact 0) while row 0
    drops its last fed token; within the bf16 limit of the plain
    version."""
    a = _ring(cuda, 170 + dh, S=300, qpk=4, dh=dh, rk=256, rv=256, nq=4)
    a["bias"][0, 1] = -1e30
    q8 = {k: _quant(a[k]) for k in ("zk", "zv", "self_zk", "self_zv")}
    bf = torch.bfloat16
    args = (a["q"].to(bf), *q8["zk"], *q8["zv"], a["r_k"].to(bf), a["cos"], a["sin"],
            a["bias"])
    kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_zk_q=q8["self_zk"][0],
              self_zk_s=q8["self_zk"][1], self_zv_q=q8["self_zv"][0],
              self_zv_s=q8["self_zv"][1], self_cos=a["self_cos"], self_sin=a["self_sin"])
    got = _check_bf16(KQ.latent_decode_attention_mq_quant,
                      KQ.latent_decode_attention_mq_quant_plain, args, kw)
    assert (got[2] == 0).all()
    assert (got[0, :, 16:32] == 0).all()
    assert (got[0, :, :16] != 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("nq,s,qpk,r", [(5, 4, 4, 256), (8, 4, 4, 256), (5, 2, 8, 256),
                                        (4, 4, 4, 512), (5, 4, 4, 512)])
def test_k6_bf16_verify_windows_past_one_query_block(cuda, nq, s, qpk, r):
    """bf16 K6 on a ragged int8 ring for verify windows of spec_depth >= 4
    (nq = 5 and 8: a block scores min(4, 16 / qpk) query sets, so 2 or 3
    query blocks along grid z) and at rank 512 (a 64-row R_k stage):
    within the bf16 limit of the plain version; query set 4 of row 0 is
    masked everywhere (its rows exact 0, in the second query block) and
    row 2 is dead (exact 0)."""
    a = _ring(cuda, 190 + nq + r, S=300, s=s, qpk=qpk, dh=128, rk=r, rv=r, nq=nq)
    Hg = s * qpk
    if nq > 4:
        a["bias"][0, 4] = -1e30
    q8 = {k: _quant(a[k]) for k in ("zk", "zv", "self_zk", "self_zv")}
    bf = torch.bfloat16
    args = (a["q"].to(bf), *q8["zk"], *q8["zv"], a["r_k"].to(bf), a["cos"], a["sin"],
            a["bias"])
    kw = dict(scale=128 ** -0.5, k_norm=a["k_norm"], self_zk_q=q8["self_zk"][0],
              self_zk_s=q8["self_zk"][1], self_zv_q=q8["self_zv"][0],
              self_zv_s=q8["self_zv"][1], self_cos=a["self_cos"], self_sin=a["self_sin"])
    got = _check_bf16(KQ.latent_decode_attention_mq_quant,
                      KQ.latent_decode_attention_mq_quant_plain, args, kw)
    assert (got[2] == 0).all()
    if nq > 4:
        assert (got[0, :, 4 * Hg:5 * Hg] == 0).all()
        assert (got[0, :, :4 * Hg] != 0).any()


@pytest.mark.gpu
def test_engine_int8_ring_serves_spec_depth_4(cuda):
    """An Engine on the int8 ring with spec_depth 4 (5 verify queries per
    slot, past K6's one query block) serves every request on the card in
    bf16 through the kernels, with K6 launched."""
    cfg = dataclasses.replace(
        get_config("qwen3-4b", smoke=True), d_head=64, dtype=torch.bfloat16,
        attn_backend="kernel", cache_quant_bits=8,
        recalkv=ReCalKVRuntime(rank_k=64, rank_v=64, group_size=2))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = Engine(cfg, params, max_slots=2, max_len=96, spec_depth=4, draft="ngram",
                 device=cuda)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
               for n in (9, 30, 17)]
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=12))
    n = KQ.latent_decode_attention_mq_quant.launches
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 12 for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    assert KQ.latent_decode_attention_mq_quant.launches > n


@pytest.mark.gpu
@pytest.mark.parametrize("r", [256, 512, 768, 1024])
def test_bf16_bodies_serve_32_query_rows_per_group(cuda, r):
    """group_size 8: G = 1 group of s = 8 head slots with q_per_kv 4, so
    Hg = 32 query rows per group, past a block's 16 (64 for the verify
    bodies): the head slots split over blocks along grid z.  bf16 K1, K3
    and K4 (one query, self column) and K5, K6 and K7 (nq 4 verify
    queries) on a ragged ring of 320 tokens (rank 512 takes 128-column
    chunks, 768 and 1024 64-column ones) within the bf16 limit of their
    plain versions; K4 and K7 on a shuffled pool equal K1 and K5 bit for
    bit; the dead row 2 is exact 0."""
    S, ps, dh = 320, 16, 128
    bf = torch.bfloat16
    for nq in (1, 4):
        a = _ring(cuda, 230 + r + nq, S=S, G=1, s=8, qpk=4, dh=dh, rk=r, rv=r, nq=nq)
        q, r_k, zk, zv = (a[k].to(bf) for k in ("q", "r_k", "zk", "zv"))
        q8 = {k: _quant(a[k]) for k in ("zk", "zv", "self_zk", "self_zv")}
        base = dict(scale=dh ** -0.5, k_norm=a["k_norm"])
        if nq == 4:
            args = (q, *q8["zk"], *q8["zv"], r_k, a["cos"], a["sin"], a["bias"])
            kw = dict(base, self_zk_q=q8["self_zk"][0], self_zk_s=q8["self_zk"][1],
                      self_zv_q=q8["self_zv"][0], self_zv_s=q8["self_zv"][1],
                      self_cos=a["self_cos"], self_sin=a["self_sin"])
            got = _check_bf16(KQ.latent_decode_attention_mq_quant,
                              KQ.latent_decode_attention_mq_quant_plain, args, kw)
            assert (got[2] == 0).all()
            kw = dict(base, self_zk=a["self_zk"].to(bf), self_zv=a["self_zv"].to(bf),
                      self_cos=a["self_cos"], self_sin=a["self_sin"])
            tables = (a["cos"], a["sin"], a["bias"])
            ring = _check_bf16(K1.latent_decode_attention_mq,
                               K1.latent_decode_attention_mq_plain,
                               (q, zk, zv, r_k, *tables), kw)
            assert (ring[2] == 0).all()
            ptab, pzk, pzv = _shuffled_pool(zk, zv, ps, r + 1)
            paged = _check_bf16(K1.latent_decode_attention_mq_paged,
                                K1.latent_decode_attention_mq_paged_plain,
                                (ptab, q, pzk, pzv, r_k, *tables), kw)
            assert torch.equal(ring, paged)
            continue
        bias = a["bias"][:, 0, :S].contiguous()
        tables = (a["cos"], a["sin"], bias)
        sel = lambda k: a[k][:, 0]
        kw = dict(base, self_zk=sel("self_zk").to(bf), self_zv=sel("self_zv").to(bf),
                  self_cos=sel("self_cos"), self_sin=sel("self_sin"))
        ring = _check_bf16(K1.latent_decode_attention, K1.latent_decode_attention_plain,
                           (q, zk, zv, r_k, *tables), kw)
        ptab, pzk, pzv = _shuffled_pool(zk, zv, ps, r)
        paged = _check_bf16(K1.latent_decode_attention_paged,
                            K1.latent_decode_attention_paged_plain,
                            (ptab, q, pzk, pzv, r_k, *tables), kw)
        assert torch.equal(ring, paged)
        dead = K1.latent_decode_attention(q, zk, zv, r_k, *tables, **base)
        torch.cuda.synchronize()
        assert (dead[2] == 0).all()
        kw3 = dict(base, self_zk_q=q8["self_zk"][0][:, 0], self_zk_s=q8["self_zk"][1][:, 0],
                   self_zv_q=q8["self_zv"][0][:, 0], self_zv_s=q8["self_zv"][1][:, 0],
                   self_cos=sel("self_cos"), self_sin=sel("self_sin"))
        _check_bf16(KQ.latent_decode_attention_quant, KQ.latent_decode_attention_quant_plain,
                    (q, *q8["zk"], *q8["zv"], r_k, *tables), kw3)


@pytest.mark.gpu
@pytest.mark.parametrize("Hg,s", [(16, 4), (32, 8)])
def test_k5_k7_bf16_tensor_cores_ragged_ring(cuda, Hg, s):
    """bf16 K5 and K7 on the tensor-core body (nq 4, r_k = r_v = 256:
    128-column chunks) over a ragged ring of 320 tokens: row 1 is live
    below position 40 only, row 2 is masked everywhere (exact 0), and
    query 1 of row 0 is masked everywhere (its rows exact 0); within the
    bf16 limit of their plain versions, one launch per call, and K7 on a
    shuffled pool equal to K5 bit for bit.  At Hg = 32 (G = 1, s = 8) the
    head slots split over blocks along grid z."""
    S, ps, dh = 320, 16, 128
    a = _ring(cuda, 250 + Hg, S=S, G=32 // Hg, s=s, qpk=4, dh=dh, rk=256, rv=256, nq=4)
    a["bias"][0, 1] = -1e30
    bf = torch.bfloat16
    q, r_k, zk, zv = (a[k].to(bf) for k in ("q", "r_k", "zk", "zv"))
    kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_zk=a["self_zk"].to(bf),
              self_zv=a["self_zv"].to(bf), self_cos=a["self_cos"], self_sin=a["self_sin"])
    tables = (a["cos"], a["sin"], a["bias"])
    ring = _check_bf16(K1.latent_decode_attention_mq, K1.latent_decode_attention_mq_plain,
                       (q, zk, zv, r_k, *tables), kw)
    assert (ring[2] == 0).all()
    assert (ring[0, :, Hg:2 * Hg] == 0).all()
    assert (ring[0, :, :Hg] != 0).any()
    ptab, pzk, pzv = _shuffled_pool(zk, zv, ps, Hg)
    paged = _check_bf16(K1.latent_decode_attention_mq_paged,
                        K1.latent_decode_attention_mq_paged_plain,
                        (ptab, q, pzk, pzv, r_k, *tables), kw)
    assert torch.equal(ring, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,s,nq,r", [(128, 4, 2, 624), (64, 8, 1, 832), (64, 8, 4, 832)])
def test_bf16_bodies_serve_ranks_past_the_128_column_plans(cuda, dh, s, nq, r):
    """bf16 K5 at nq = 2, r = 624 (spec_depth 1 at a rank the CUDA-core
    template served; the tensor-core body takes 64-column chunks there),
    and the dh = 64 instantiations of the 64-column plan (r = 832: K1 and
    K5), on a ragged ring of 320 tokens within the bf16 limit of their
    plain versions; K4 / K7 on a shuffled pool equal K1 / K5 bit for bit."""
    S, ps = 320, 16
    a = _ring(cuda, 270 + dh + nq + r, S=S, G=1, s=s, qpk=4, dh=dh, rk=r, rv=r, nq=nq)
    bf = torch.bfloat16
    q, r_k, zk, zv = (a[k].to(bf) for k in ("q", "r_k", "zk", "zv"))
    sel = (lambda x: x[:, 0]) if nq == 1 else (lambda x: x)
    kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_zk=sel(a["self_zk"]).to(bf),
              self_zv=sel(a["self_zv"]).to(bf), self_cos=sel(a["self_cos"]),
              self_sin=sel(a["self_sin"]))
    tables = (a["cos"], a["sin"], a["bias"][:, 0, :S].contiguous() if nq == 1 else a["bias"])
    mq = "" if nq == 1 else "_mq"
    ring_k = getattr(K1, f"latent_decode_attention{mq}")
    paged_k = getattr(K1, f"latent_decode_attention{mq}_paged")
    ring = _check_bf16(ring_k, getattr(K1, ring_k.__name__ + "_plain"),
                       (q, zk, zv, r_k, *tables), kw)
    ptab, pzk, pzv = _shuffled_pool(zk, zv, ps, r)
    paged = _check_bf16(paged_k, getattr(K1, paged_k.__name__ + "_plain"),
                        (ptab, q, pzk, pzv, r_k, *tables), kw)
    assert torch.equal(ring, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [None, 8])
def test_engine_bf16_serves_group_size_8(cuda, bits):
    """A bf16 Engine at group_size 8 (8 kv heads in one latent group of 32
    query heads, rank 152) on the float and the int8 ring serves every
    request on the card through the kernels: K2 at dv = 152 in prefill,
    K1 or K3 at Hg = 32 in decode."""
    cfg = dataclasses.replace(
        get_config("qwen3-4b", smoke=True), num_heads=32, num_kv_heads=8, d_head=64,
        dtype=torch.bfloat16, attn_backend="kernel", cache_quant_bits=bits,
        recalkv=ReCalKVRuntime(rank_k=152, rank_v=152, group_size=8))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = Engine(cfg, params, max_slots=2, max_len=96, device=cuda)
    g = torch.Generator().manual_seed(2)
    for uid, n in enumerate((9, 30, 17)):
        eng.submit(Request(uid=uid, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                         generator=g).numpy(),
                           max_new_tokens=12))
    decode = KQ.latent_decode_attention_quant if bits else K1.latent_decode_attention
    n_dec, n_pre = decode.launches, K2.flash_prefill_attention.launches
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 12 for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    assert decode.launches > n_dec and K2.flash_prefill_attention.launches > n_pre


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,ps", [(64, 8), (80, 16), (128, 16), (256, 16)])
def test_k7_cuda_kernel_matches_plain_and_k5_on_view(cuda, dtype, dh, ps):
    """nq = 4 verify queries over the paged pool of the K4 test: against
    the plain version, and bit for bit against K5 on the gathered ring."""
    a = _ring(cuda, 110 + dh, S=6 * ps, dh=dh, nq=4)
    ptab, pzk, pzv = _paged(cuda, a, ps, dh + 1)
    q, r_k = a["q"].to(dtype), a["r_k"].to(dtype)
    pzk, pzv = pzk.to(dtype), pzv.to(dtype)
    kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_zk=a["self_zk"].to(dtype),
              self_zv=a["self_zv"].to(dtype), self_cos=a["self_cos"],
              self_sin=a["self_sin"])
    got = _check(K1.latent_decode_attention_mq_paged,
                 K1.latent_decode_attention_mq_paged_plain,
                 (ptab, q, pzk, pzv, r_k, a["cos"], a["sin"], a["bias"]), kw, dtype,
                 K1.latent_decode_attention_mq_paged)
    view = K1.latent_decode_attention_mq(
        q, K1.gather_pages(pzk, ptab), K1.gather_pages(pzv, ptab), r_k, a["cos"],
        a["sin"], a["bias"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, view)
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
    with pytest.raises(ValueError, match="dh must be 64, 80, 128 or 256"):
        K1.latent_decode_attention(q, z, z, torch.randn(1, 8, 192, device=cuda),
                                   tab, tab, torch.zeros(1, 4, device=cuda), scale=1.0)
    # nq = 5 verify rows at the main path's width do not fit one float32
    # block of all rows: the template splits them (a head-slot plan) and
    # serves them, K5 on the ring and K7 over a pool
    qm = torch.randn(1, 2, 5 * 16, 128, device=cuda)
    zm = torch.randn(1, 8, 2, 256, device=cuda)
    tm = torch.zeros(1, 8, 64, device=cuda)
    rk = torch.randn(2, 256, 512, device=cuda) / 16
    bm = torch.zeros(1, 5, 8, device=cuda)
    torch.testing.assert_close(
        K1.latent_decode_attention_mq(qm, zm, zm, rk, tm, tm, bm, scale=1.0),
        K1.latent_decode_attention_mq_plain(qm, zm, zm, rk, tm, tm, bm, scale=1.0),
        atol=1e-4, rtol=1e-4)
    # a page table must be int32
    pm = torch.randn(3, 4, 2, 256, device=cuda)
    tab2 = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        K1.latent_decode_attention_mq_paged(tab2, qm, pm, pm, rk, tm, tm, bm, scale=1.0),
        K1.latent_decode_attention_mq_paged_plain(tab2, qm, pm, pm, rk, tm, tm, bm,
                                                  scale=1.0), atol=1e-4, rtol=1e-4)
    with pytest.raises(TypeError, match="int32"):
        K1.latent_decode_attention_paged(
            tab2.long(), qm[:, :, :16], pm, pm, torch.randn(2, 256, 512, device=cuda),
            tm, tm, torch.zeros(1, 8, device=cuda), scale=1.0)
    # the bf16 tensor-core bodies hold at most 16 query rows per head slot
    # (past 8 the one-query bodies run the multi-query one), r_k and r_v
    # multiples of 8 whose block fits in shared memory (every rank up to s
    # * dh; any number of query rows per group: past the block's rows the
    # head slots split over blocks)
    bf = torch.bfloat16
    rk_bf = torch.randn(2, 256, 512, device=cuda).to(bf)
    with pytest.raises(ValueError, match="bf16 paged kernel"):
        K1.latent_decode_attention_paged(
            tab2, qm[:, :, :32].to(bf), pm.to(bf), pm.to(bf), rk_bf[..., :128], tm, tm,
            torch.zeros(1, 8, device=cuda), scale=1.0)
    # ranks past the 128-column plans take 64-column chunks: K1 at r = 712
    # and K6 at r = 576 are served (both were refused before that plan)
    cs, sn = ops.rope_tables_for(torch.arange(8, device=cuda)[None], 128, 1e6)
    z712 = torch.randn(1, 8, 2, 712, device=cuda).to(bf)
    args712 = (qm[:, :, :16].to(bf), z712, z712,
               (torch.randn(2, 712, 512, device=cuda) / math.sqrt(712)).to(bf), cs, sn,
               torch.zeros(1, 8, device=cuda))
    _within_bf16_limit(K1.latent_decode_attention(*args712, scale=128 ** -0.5),
                       K1.latent_decode_attention_plain(*args712, scale=128 ** -0.5))
    with pytest.raises(ValueError, match="bf16 ring kernel"):
        K1.latent_decode_attention(q.to(bf), z.to(bf), z.to(bf),
                                   torch.randn(1, 8, 192, device=cuda).to(bf), tab, tab,
                                   torch.zeros(1, 4, device=cuda), scale=1.0)
    z8 = torch.zeros(1, 8, 2, 256, dtype=torch.int8, device=cuda)
    s8 = torch.ones(1, 8, 2, device=cuda)
    z576 = torch.randint(-127, 128, (1, 8, 2, 576), dtype=torch.int8, device=cuda)
    r576 = (torch.randn(2, 576, 512, device=cuda) / math.sqrt(576)).to(bf)
    args576 = (qm.to(bf), z576, s8, z576, s8, r576, cs, sn, torch.zeros(1, 5, 8, device=cuda))
    _within_bf16_limit(KQ.latent_decode_attention_mq_quant(*args576, scale=0.01),
                       KQ.latent_decode_attention_mq_quant_plain(*args576, scale=0.01))
    z12 = torch.zeros(1, 8, 2, 12, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="bf16 int8 multi-query kernel"):
        KQ.latent_decode_attention_mq_quant(qm[:, :, :64].to(bf), z8, s8, z12, s8, rk_bf,
                                            tm, tm, torch.zeros(1, 4, 8, device=cuda),
                                            scale=1.0)


def _dense_ring(cuda, seed, B=3, S=64, Hkv=8, qpk=4, dh=128, nq=3):
    """A dense ring (row 1 valid below 40, row 2 empty), nq verify
    queries with their post-RoPE self entries, float32 on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    pos = torch.arange(S, device=cuda).repeat(B, 1)
    pos[1, 40:] = -1
    pos[2] = -1
    cache = {"k": rn(B, S, Hkv, dh), "v": rn(B, S, Hkv, dh), "pos": pos}
    cur = torch.tensor([S, 40, 0], device=cuda)
    feed = torch.ones(B, nq, dtype=torch.bool, device=cuda)
    feed[0, -1] = False
    return dict(cache=cache, cur=cur, feed=feed, q=rn(B, Hkv * qpk, dh),
                qm=rn(B, nq, Hkv * qpk, dh),
                one={k: rn(B, Hkv, dh) for k in ("k", "v")},
                many={k: rn(B, nq, Hkv, dh) for k in ("k", "v")})


def _pool_of(cache, ps, seed):
    """The ring's pages at shuffled physical pages, empty pages on the
    null page 0.  Returns (pool, ptab)."""
    B, S = cache["pos"].shape
    n_sp = S // ps
    perm = (torch.randperm(B * n_sp, generator=torch.Generator().manual_seed(seed)) + 1)
    ptab = torch.zeros(B, n_sp, dtype=torch.int32)
    pool = {k: torch.zeros((B * n_sp + 1, ps) + tuple(v.shape[2:]), dtype=v.dtype,
                           device=v.device) for k, v in cache.items()}
    pool["pos"][:] = -1
    for b in range(B):
        for j in range(n_sp):
            if (cache["pos"][b, j * ps:(j + 1) * ps] >= 0).any():
                ptab[b, j] = perm[b * n_sp + j]
                for k in pool:
                    pool[k][ptab[b, j]] = cache[k][b, j * ps:(j + 1) * ps]
    return pool, ptab.to(cache["pos"].device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_cores_match_plain_and_each_other(cuda, dtype):
    """The dense cores at qwen3-4b's head shape (Hkv = 8, q_per_kv 4, dh
    128): the dense decode kernel and the dense verify kernel (nq 3) on the
    ring and the pool, against their plain versions (the same calls on CPU
    copies); the pool == the ring on the gathered ring bit for bit; launches
    counted on the four dense wrappers, none on K1, K4, K5 or K7; the empty
    row 2 (query 0 of it in verify) sees only its self column and returns
    its value exactly."""
    a = _dense_ring(cuda, 300)
    cast = lambda d: {k: (v if k == "pos" else v.to(dtype)) for k, v in d.items()}
    cache, one, many = cast(a["cache"]), cast(a["one"]), cast(a["many"])
    q, qm = a["q"].to(dtype), a["qm"].to(dtype)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    kw = dict(window=None, scale=128 ** -0.5)
    pool, ptab = _pool_of(cache, 16, 301)
    view = {k: K1.gather_pages(v, ptab) for k, v in pool.items()}

    def check(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        else:
            _within_bf16_limit(got.cpu(), want)

    counted = (KD.dense_decode_attention, KD.dense_decode_attention_paged,
               KD.dense_decode_attention_mq, KD.dense_decode_attention_mq_paged,
               K1.latent_decode_attention, K1.latent_decode_attention_paged,
               K1.latent_decode_attention_mq, K1.latent_decode_attention_mq_paged)
    launches_before = [k.launches for k in counted]
    r1 = ops.dense_decode(q, cache, a["cur"], self_entry=one, **kw)
    check(r1, ops.dense_decode(q.cpu(), cpu(cache), a["cur"].cpu(), self_entry=cpu(one),
                               **kw))
    p1 = ops.dense_decode_paged(q, pool, ptab, a["cur"], self_entry=one, **kw)
    check(p1, ops.dense_decode_paged(q.cpu(), cpu(pool), ptab.cpu(), a["cur"].cpu(),
                                     self_entry=cpu(one), **kw))
    assert torch.equal(p1, ops.dense_decode(q, view, a["cur"], self_entry=one, **kw))
    assert torch.equal(r1[2], one["v"][2].repeat_interleave(4, dim=0))
    rm = ops.dense_decode_mq(qm, cache, a["cur"], a["feed"], many, **kw)
    check(rm, ops.dense_decode_mq(qm.cpu(), cpu(cache), a["cur"].cpu(), a["feed"].cpu(),
                                  cpu(many), **kw))
    pm = ops.dense_decode_mq_paged(qm, pool, ptab, a["cur"], a["feed"], many, **kw)
    check(pm, ops.dense_decode_mq_paged(qm.cpu(), cpu(pool), ptab.cpu(), a["cur"].cpu(),
                                        a["feed"].cpu(), cpu(many), **kw))
    assert torch.equal(pm, ops.dense_decode_mq(qm, view, a["cur"], a["feed"], many, **kw))
    assert torch.equal(rm[2, 0], many["v"][2, 0].repeat_interleave(4, dim=0))
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(counted, launches_before)] == [2, 1, 2, 1, 0, 0,
                                                                          0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,qpk,nq,window,unfed", [(64, 1, 1, None, False),
                                                    (64, 8, 5, 16, False),
                                                    (64, 1, 8, None, True),
                                                    (128, 8, 8, 16, True),
                                                    (128, 1, 5, 16, False),
                                                    (128, 4, 9, None, False),
                                                    (128, 4, 16, 16, False),
                                                    (64, 1, 16, None, True),
                                                    (256, 2, 4, 16, False),
                                                    (256, 8, 5, None, True),
                                                    (256, 1, 17, None, False),
                                                    (80, 4, 4, 16, False),
                                                    (80, 1, 5, None, True),
                                                    (80, 16, 3, None, False),
                                                    (128, 16, 4, None, False),
                                                    (128, 16, 1, 16, True),
                                                    (64, 16, 2, 16, False),
                                                    (256, 16, 2, None, False),
                                                    # 17, 36, 64, 65 and 256 rows
                                                    (64, 1, 17, 16, False),
                                                    (80, 1, 17, None, True),
                                                    (128, 1, 17, None, False),
                                                    (64, 9, 4, 16, False),
                                                    (80, 4, 9, None, True),
                                                    (256, 12, 3, 16, False),
                                                    (64, 16, 4, None, True),
                                                    (80, 8, 8, 16, False),
                                                    (256, 4, 16, None, False),
                                                    (64, 13, 5, None, False),
                                                    (80, 5, 13, 16, True),
                                                    (128, 1, 65, 16, False),
                                                    (256, 13, 5, None, True),
                                                    (64, 16, 16, 16, False),
                                                    (80, 16, 16, None, False),
                                                    (128, 16, 16, 16, True),
                                                    (256, 16, 16, None, False)])
def test_dense_verify_kernel_edge_shapes(cuda, dtype, dh, qpk, nq, window, unfed):
    """The dense verify kernel at dh 64 / 80 / 128 / 256, q_per_kv 1-16,
    nq 1-65: up to 16 query rows one m16 tile a block, more in row groups
    of 64 (17, 32, 36, 40, 48, 64, 65 and 256 rows at every dh: a partial
    group, one, two with a one-row second, four; 17 queries at dh 256
    narrow the chunk so that their bias rows fit beside the rings), with
    and without a window and with every candidate unfed, on a ring whose
    row 2 is empty: within
    1e-4 (f32) or the bf16 limit of the plain version; row 2's query 0
    exactly its self value (exact 0 with the candidates unfed, when it sees
    no column); the pool (page size 8) equal to the ring on the gathered
    view bit for bit."""
    a = _dense_ring(cuda, 700 + dh + 10 * qpk + nq, S=200, qpk=qpk, dh=dh, nq=nq)
    cache = {k: (v if k == "pos" else v.to(dtype)) for k, v in a["cache"].items()}
    feed = torch.zeros_like(a["feed"]) if unfed else a["feed"]
    sk, sv = a["many"]["k"].to(dtype), a["many"]["v"].to(dtype)
    pos_q = a["cur"][:, None] + torch.arange(nq, device=cuda)
    bias = ops.verify_bias(torch.cat([cache["pos"], pos_q], 1), pos_q, feed, window, 200)
    qg = ops.group_queries_mq(a["qm"].to(dtype), 8)
    kw = dict(scale=dh ** -0.5, self_k=sk, self_v=sv)
    got = KD.dense_decode_attention_mq(qg, cache["k"], cache["v"], bias, **kw)
    want = KD.dense_decode_attention_mq_plain(qg, cache["k"], cache["v"], bias, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _within_bf16_limit(got, want)
    self0 = torch.zeros_like(sv[2, 0]) if unfed else sv[2, 0]
    assert torch.equal(got[2, :, :qpk], self0[:, None].expand(8, qpk, dh))
    pool, ptab = _pool_of(cache, 8, 701)
    pos = K1.gather_pages(pool["pos"], ptab)
    pbias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, window, 200)
    paged = KD.dense_decode_attention_mq_paged(ptab, qg, pool["k"], pool["v"], pbias, **kw)
    view = KD.dense_decode_attention_mq(qg, K1.gather_pages(pool["k"], ptab),
                                        K1.gather_pages(pool["v"], ptab), pbias, **kw)
    assert torch.equal(paged, view)


@pytest.mark.gpu
def test_dense_verify_kernel_rejects_shapes_outside_limits(cuda):
    """No fallback: shapes and types the dense verify kernel does not take
    raise, and count no launch."""
    g = torch.Generator(device=cuda).manual_seed(8)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    k, bias = rn(2, 32, 2, 128), torch.zeros(2, 4, 36, device=cuda)
    sk = rn(2, 4, 2, 128)
    kw = dict(scale=1.0, self_k=sk, self_v=sk)
    before = (KD.dense_decode_attention_mq.launches, KD.dense_decode_attention_mq_paged.launches)
    with pytest.raises(ValueError, match="dh must be 64, 80, 128 or 256"):
        KD.dense_decode_attention_mq(rn(2, 2, 16, 96), rn(2, 32, 2, 96), rn(2, 32, 2, 96),
                                     bias, scale=1.0, self_k=rn(2, 4, 2, 96),
                                     self_v=rn(2, 4, 2, 96))
    with pytest.raises(ValueError, match="q_per_kv 1-16, nq >= 1"):
        KD.dense_decode_attention_mq(rn(2, 2, 68, 128), k, k, bias, **kw)
    with pytest.raises(ValueError, match="nq >= 1"):
        KD.dense_decode_attention_mq(rn(2, 2, 10, 128), k, k, bias, **kw)
    with pytest.raises(ValueError, match="unsupported shapes"):
        KD.dense_decode_attention_mq(rn(2, 2, 16, 128), k, k, bias[..., :32], **kw)
    with pytest.raises(ValueError, match="self columns"):
        KD.dense_decode_attention_mq(rn(2, 2, 16, 128), k, k, bias, scale=1.0, self_k=None,
                                     self_v=None)
    with pytest.raises(TypeError, match="bf16 or float32"):
        KD.dense_decode_attention_mq(rn(2, 2, 16, 128).half(), k.half(), k.half(), bias,
                                     scale=1.0, self_k=sk.half(), self_v=sk.half())
    with pytest.raises(TypeError, match="must be"):
        KD.dense_decode_attention_mq(rn(2, 2, 16, 128).to(torch.bfloat16), k, k, bias, **kw)
    with pytest.raises(TypeError, match="int32"):
        KD.dense_decode_attention_mq_paged(torch.zeros(2, 4, dtype=torch.int64, device=cuda),
                                           rn(2, 2, 16, 128), rn(9, 8, 2, 128),
                                           rn(9, 8, 2, 128), bias, **kw)
    assert (KD.dense_decode_attention_mq.launches,
            KD.dense_decode_attention_mq_paged.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,qpk,window", [(64, 1, None), (64, 8, 16), (128, 1, 16),
                                           (128, 8, None), (256, 2, None), (256, 8, 16),
                                           (80, 4, None), (80, 16, 16), (80, 1, 16),
                                           (128, 16, None), (64, 16, 16), (256, 16, None),
                                           (64, 9, None), (64, 12, 16), (80, 9, 16),
                                           (80, 12, None), (128, 9, 16), (128, 12, None),
                                           (256, 9, 16), (256, 12, None)])
def test_dense_decode_kernel_edge_shapes(cuda, dtype, dh, qpk, window):
    """The dense decode at dh 64 / 80 / 128 / 256, q_per_kv 1 / 2 / 4
    (``csrc/dense_decode.cu``) and 8 / 9 / 12 / 16 (one m16 tile of
    ``csrc/dense_verify.cu``'s tensor-core body), with and without a
    window, on a ring whose row 2 is masked everywhere: within
    1e-4 (f32) or the bf16 limit of the plain version, row 2 exactly its
    self value (and exact 0 without a self column), and the pool equal to
    the ring on the gathered view bit for bit (page size 8)."""
    a = _dense_ring(cuda, 500 + dh + qpk, S=200, qpk=qpk, dh=dh)
    cache = {k: (v if k == "pos" else v.to(dtype)) for k, v in a["cache"].items()}
    qg = ops.group_queries(a["q"].to(dtype), 8)
    sk, sv = a["one"]["k"].to(dtype), a["one"]["v"].to(dtype)
    bias = ops.decode_bias(cache["pos"], a["cur"], window)
    kw = dict(scale=dh ** -0.5, self_k=sk, self_v=sv)
    got = KD.dense_decode_attention(qg, cache["k"], cache["v"], bias, **kw)
    want = KD.dense_decode_attention_plain(qg, cache["k"], cache["v"], bias, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _within_bf16_limit(got, want)
    assert torch.equal(got[2], sv[2][:, None].expand(8, qpk, dh))
    bare = KD.dense_decode_attention(qg, cache["k"], cache["v"], bias, scale=dh ** -0.5)
    bare_want = KD.dense_decode_attention_plain(qg, cache["k"], cache["v"], bias,
                                                scale=dh ** -0.5)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(bare, bare_want, atol=1e-4, rtol=1e-4)
    else:
        _within_bf16_limit(bare, bare_want)
    assert (bare[2] == 0).all()
    pool, ptab = _pool_of(cache, 8, 501)
    pbias = ops.decode_bias(K1.gather_pages(pool["pos"], ptab), a["cur"], window)
    for sk_, sv_ in ((sk, sv), (None, None)):
        paged = KD.dense_decode_attention_paged(ptab, qg, pool["k"], pool["v"], pbias,
                                                scale=dh ** -0.5, self_k=sk_, self_v=sv_)
        view = KD.dense_decode_attention(qg, K1.gather_pages(pool["k"], ptab),
                                         K1.gather_pages(pool["v"], ptab), pbias,
                                         scale=dh ** -0.5, self_k=sk_, self_v=sv_)
        assert torch.equal(paged, view)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
def test_dense_decode_bodies_agree_at_8_rows(cuda, dtype, dh):
    """At q_per_kv 8, where the wrapper moves from the CUDA-core body to the
    tensor-core body (``dense_verify.cu``'s decode entry), both are held
    to the same plain version on the ring and the pool, so the two can be
    timed against each other; the CUDA-core body refuses 9 rows."""
    a = _dense_ring(cuda, 900 + dh, S=200, qpk=8, dh=dh)
    cache = {k: (v if k == "pos" else v.to(dtype)) for k, v in a["cache"].items()}
    qg = ops.group_queries(a["q"].to(dtype), 8)
    sk, sv = a["one"]["k"].to(dtype), a["one"]["v"].to(dtype)
    bias = ops.decode_bias(cache["pos"], a["cur"], None)
    want = KD.dense_decode_attention_plain(qg, cache["k"], cache["v"], bias,
                                           scale=dh ** -0.5, self_k=sk, self_v=sv)
    pool, ptab = _pool_of(cache, 8, 901)
    pbias = ops.decode_bias(K1.gather_pages(pool["pos"], ptab), a["cur"], None)
    for body in ("cuda_core", "tensor_core"):
        got = KD.launch(qg, cache["k"], cache["v"], bias, dh ** -0.5, sk, sv, body=body)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            _within_bf16_limit(got, want)
        paged = KD.launch(qg, pool["k"], pool["v"], pbias, dh ** -0.5, sk, sv, ptab=ptab,
                          body=body)
        view = KD.launch(qg, K1.gather_pages(pool["k"], ptab),
                         K1.gather_pages(pool["v"], ptab), pbias, dh ** -0.5, sk, sv,
                         body=body)
        assert torch.equal(paged, view)
    q9 = torch.cat([qg, qg[:, :, :1]], dim=2)
    with pytest.raises(ValueError, match="CUDA-core body takes q_per_kv 1-8"):
        KD.launch(q9, cache["k"], cache["v"], bias, dh ** -0.5, sk, sv, body="cuda_core")


@pytest.mark.gpu
def test_dense_decode_kernel_rejects_shapes_outside_limits(cuda):
    """No fallback: shapes and types the dense decode kernel does not take
    raise, and count no launch."""
    g = torch.Generator(device=cuda).manual_seed(7)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    k, bias = rn(2, 32, 2, 128), torch.zeros(2, 32, device=cuda)
    before = KD.dense_decode_attention.launches
    with pytest.raises(ValueError, match="dh must be 64, 80, 128 or 256"):
        KD.dense_decode_attention(rn(2, 2, 4, 96), rn(2, 32, 2, 96), rn(2, 32, 2, 96),
                                  bias, scale=1.0)
    with pytest.raises(ValueError, match="q_per_kv 1-16"):
        KD.dense_decode_attention(rn(2, 2, 17, 128), k, k, bias, scale=1.0)
    with pytest.raises(ValueError, match="unsupported shapes"):
        KD.dense_decode_attention(rn(2, 2, 4, 128), k, k, bias[:, :16], scale=1.0)
    with pytest.raises(TypeError, match="bf16 or float32"):
        KD.dense_decode_attention(rn(2, 2, 4, 128).half(), k.half(), k.half(), bias,
                                  scale=1.0)
    with pytest.raises(TypeError, match="must be"):
        KD.dense_decode_attention(rn(2, 2, 4, 128).to(torch.bfloat16), k, k, bias,
                                  scale=1.0)
    with pytest.raises(TypeError, match="int32"):
        KD.dense_decode_attention_paged(torch.zeros(2, 4, dtype=torch.int64, device=cuda),
                                        rn(2, 2, 4, 128), rn(9, 8, 2, 128),
                                        rn(9, 8, 2, 128), bias, scale=1.0)
    assert KD.dense_decode_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("nq,r", [(1, 768), (1, 1024), (4, 768), (4, 1024), (8, 1024)])
def test_f32_template_serves_group_size_8_wide_ranks(cuda, nq, r):
    """The float32 template at widths one block of all rows cannot hold
    (G = 1, s = 8, Hg = 32, r = 768 / 1,024, nq up to 8): within 1e-4 of
    the plain version (K1 at nq 1, K5 otherwise), and K4 / K7 equal to K1
    / K5 on the gathered ring bit for bit."""
    S, ps = 96, 16
    a = _ring(cuda, 400 + r + nq, S=S, G=1, s=8, qpk=4, dh=128, rk=r, rv=r, nq=nq)
    if nq == 1:
        kernel, plain, paged = (K1.latent_decode_attention,
                                K1.latent_decode_attention_plain,
                                K1.latent_decode_attention_paged)
        bias = a["bias"][:, 0, :S].contiguous()
        sel = lambda k: a[k][:, 0]
    else:
        kernel, plain, paged = (K1.latent_decode_attention_mq,
                                K1.latent_decode_attention_mq_plain,
                                K1.latent_decode_attention_mq_paged)
        bias = a["bias"]
        sel = lambda k: a[k]
    kw = dict(scale=128 ** -0.5, k_norm=a["k_norm"], self_zk=sel("self_zk"),
              self_zv=sel("self_zv"), self_cos=sel("self_cos"), self_sin=sel("self_sin"))
    tables = (a["cos"], a["sin"], bias)
    got = _check(kernel, plain, (a["q"], a["zk"], a["zv"], a["r_k"], *tables), kw,
                 torch.float32, kernel)
    ptab, pzk, pzv = _paged(cuda, a, ps, r + nq)
    view = kernel(a["q"], K1.gather_pages(pzk, ptab), K1.gather_pages(pzv, ptab),
                  a["r_k"], *tables, **kw)
    assert torch.equal(paged(ptab, a["q"], pzk, pzv, a["r_k"], *tables, **kw), view)
    assert got.shape == (3, 1, nq * 32, r)


@pytest.mark.gpu
def test_compress_attention_layer_on_card_matches_cpu(cuda):
    """One qwen3-4b-width layer (d 2560, 32 q heads, 8 kv heads, dh 128)
    through HSR, whitened grouped SVD and ALS on the card and on the CPU:
    the same groups, and the products L_k R_k and L_v[g] W~_o[h] within
    1e-3 of the product's largest entry."""
    from repro_torch.core import pipeline as P
    g = torch.Generator().manual_seed(500)
    d, H, Hkv, dh = 2560, 32, 8, 128
    rn = lambda *sh: torch.randn(sh, generator=g)
    X = rn(4096, d) @ (torch.eye(d) + 0.05 * rn(d, d))
    w = dict(W_q=rn(d, H * dh) / d ** 0.5, W_k=rn(d, Hkv * dh) / d ** 0.5,
             W_v=rn(d, Hkv * dh) / d ** 0.5, W_o=rn(H * dh, d) / (H * dh) ** 0.5)
    rc = P.ReCalKVConfig(keep_ratio=0.5, group_size=4)
    out = {}
    for dev in ("cpu", cuda):
        aw = P.AttnWeights(**{k: v.to(dev) for k, v in w.items()}, num_q_heads=H,
                           num_kv_heads=Hkv)
        out[str(dev)] = P.compress_attention_layer(aw, P.collect_stats(X.to(dev)), rc,
                                                   256, 256)
    c, k = out["cpu"], out[str(cuda)]
    assert c.perm == k.perm and c.report["groups"] == k.report["groups"]

    def near(a, b):
        a, b = a.cpu(), b.cpu()
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()

    for grp in range(2):
        near(k.L_k[grp] @ k.R_k[grp], c.L_k[grp] @ c.R_k[grp])
    for h in range(H):
        grp = (h // 4) // 4
        near(k.L_v[grp] @ k.W_o_fused[h], c.L_v[grp] @ c.W_o_fused[h])


def _graph_engine_cfg(dense: bool, bits=None):
    """Smoke qwen3-4b at d_head 64 in bf16 on the kernel backend: the dense
    cache, or a latent one (group_size 2, rank 64)."""
    return dataclasses.replace(
        get_config("qwen3-4b", smoke=True), d_head=64, dtype=torch.bfloat16,
        attn_backend="kernel", cache_quant_bits=bits,
        recalkv=None if dense else ReCalKVRuntime(rank_k=64, rank_v=64, group_size=2))


def _cache_ptrs(eng):
    caches = eng.cache + (eng.draft_cache or [])
    return [leaf.data_ptr() for c in caches for leaf in c["self"].values()]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dense,bits,flags,must", [
    ("ring", False, None, {}, "latent_decode_attention"),
    ("pool", False, None, dict(cache_layout="paged", page_size=16),
     "latent_decode_attention_paged"),
    ("dense ring", True, None, {}, "dense_decode_attention"),
    ("dense pool, ngram", True, None,
     dict(cache_layout="paged", page_size=16, spec_depth=3, draft="ngram"),
     "dense_decode_attention_mq_paged"),
    ("int8 ring, layers:1, adaptive", False, 8,
     dict(spec_depth=2, draft="layers:1", adaptive_spec=True),
     "latent_decode_attention_mq_quant")])
def test_aot_graph_streams_equal_eager(cuda, name, dense, bits, flags, must):
    """aot=True on the card: the window iteration captured as CUDA graphs
    (greedy and sampled) serves the same streams as the eager window, in
    the sync and the overlapped engine, on the ring, the pool and the dense
    cache, greedy and sampled; ``captures`` is 2 after construction and
    does not move while serving; no cache leaf moved; the graphs hold the
    path's kernel and were replayed."""
    cfg = _graph_engine_cfg(dense, bits)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
               for n in (9, 30, 17, 40, 5)]
    sampled = SamplingParams(temperature=0.9, top_k=32, top_p=0.9, seed=3)

    def serve(**kw):
        eng = Engine(cfg, params, max_slots=3, max_len=128, sync_every=4, device=cuda,
                     **flags, **kw)
        captured = (eng.metrics()["captures"], _cache_ptrs(eng))
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=12,
                               sampling=sampled if uid % 2 else None))
        done = eng.run()
        eng.close()
        assert sorted(r.uid for r in done) == list(range(len(prompts)))
        return {r.uid: list(r.out_tokens) for r in done}, eng, captured

    want, _, _ = serve()
    for kw in (dict(aot=True), dict(aot=True, overlap=True, pipeline_depth=3)):
        got, eng, (captures, ptrs) = serve(**kw)
        assert got == want, (name, kw)
        m = eng.metrics()
        assert captures == m["captures"] == 2, m
        assert _cache_ptrs(eng) == ptrs
        assert set(m["graphs"]) == {"greedy", "sampled"}
        assert all(gr[must] > 0 for gr in (v["launches"] for v in m["graphs"].values()))
        assert sum(v["replays"] for v in m["graphs"].values()) >= m["windows"]


@pytest.mark.gpu
@pytest.mark.parametrize("slot", [-1, 0, 3, 4])
def test_stage_install_kernel_matches_plain(cuda, slot):
    """The install's predicated row copy against its plain version
    (``torch.where`` on the selected row), bit for bit, on the leaf kinds a
    cache holds (bf16 latents, int8 latents, f32 scales, int64 positions)
    and one leaf whose rows are not 16-byte multiples (the byte loop).
    Slots -1 and 4 (= the batch) install nothing: every leaf stays as it
    was; 0 and 3 take stage row 2."""
    from repro_torch.kernels import stage_install as KS
    g = torch.Generator(device=cuda).manual_seed(11)
    B = 4
    shapes = [((70, 2, 32), torch.bfloat16), ((70, 2, 32), torch.int8),
              ((70, 2), torch.float32), ((70,), torch.int64), ((5, 3), torch.int8)]

    def leaves():
        out = []
        for sh, dt in shapes:
            x = torch.randn((B,) + sh, generator=g, device=cuda) * 50
            out.append(x.to(dt))
        return out

    dst, src = leaves(), leaves()
    want = [d.clone() for d in dst]
    s = torch.tensor(slot, device=cuda)
    q = torch.tensor(2, device=cuda)
    KS.stage_install_rows_plain(want, src, s, q)
    before = KS.stage_install_rows.launches
    KS.stage_install_rows(dst, src, s, q, KS.InstallTable(dst, src))
    torch.cuda.synchronize()
    assert KS.stage_install_rows.launches == before + 1
    for d, w, s_ in zip(dst, want, src):
        assert torch.equal(d, w)
        if 0 <= slot < B:
            assert torch.equal(d[slot], s_[2])


@pytest.mark.gpu
def test_stage_install_table_is_its_engines(cuda):
    """Each continuous ring engine holds the install table of its own ring
    and stage cache.  An engine at (8 slots, 256 positions) is dropped,
    then one at (16, 128) is built in the same process, where the caching
    allocator may hand back the same blocks with rows half as long: its
    last slot takes its last stage row and no other row changes.  A table
    built over other leaves is refused."""
    from repro_torch.kernels import stage_install as KS
    from repro_torch.models import transformer as T
    cfg = _graph_engine_cfg(False)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(12)
    old = None
    for B, L in ((8, 256), (16, 128)):
        eng = Engine(cfg, params, max_slots=B, max_len=L, sync_every=4, device=cuda,
                     overlap=True, continuous=True)
        cache, stage, table = eng.cache, eng._stage["cache"], eng._stage["table"]
        for c in cache + stage:
            for leaf in c["self"].values():
                leaf.copy_(torch.randint(-1, 100, leaf.shape, generator=g, device=cuda))
        want = [{k: v.clone() for k, v in c["self"].items()} for c in cache]
        for w, s_ in zip(want, stage):
            for k in w:
                w[k][B - 1] = s_["self"][k][B - 1]
        last = torch.tensor(B - 1, device=cuda)
        T.swap_cache_slot(cache, stage, last, last, table)
        torch.cuda.synchronize()
        for c, w in zip(cache, want):
            for k, v in c["self"].items():
                assert torch.equal(v, w[k]), (B, L, k)
        if old is not None:
            with pytest.raises(ValueError, match="other leaves"):
                T.swap_cache_slot(cache, stage, last, last, old)
        old = table
        eng.close()
        del eng, cache, stage, want
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("name,dense,flags,must", [
    ("ring", False, {}, "latent_decode_attention"),
    ("pool", False, dict(cache_layout="paged", page_size=16),
     "latent_decode_attention_paged"),
    ("dense pool, ngram", True,
     dict(cache_layout="paged", page_size=16, spec_depth=3, draft="ngram"),
     "dense_decode_attention_mq_paged")])
def test_continuous_graph_streams_equal_eager(cuda, name, dense, flags, must):
    """Continuous batching on the card: the replayed continuous window
    (aot) serves the streams of the eager continuous window and of the
    sync engine, greedy and sampled, with installs inside the windows;
    two graphs captured at construction, none after; on the ring each
    replay launches the install's row copy."""
    cfg = _graph_engine_cfg(dense)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
               for n in (9, 30, 17, 40, 5, 22, 12)]
    sampled = SamplingParams(temperature=0.9, top_k=32, top_p=0.9, seed=3)

    def serve(**kw):
        eng = Engine(cfg, params, max_slots=3, max_len=128, sync_every=4, device=cuda,
                     **flags, **kw)
        captures = eng.metrics()["captures"]
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4 + 3 * (uid % 4),
                               sampling=sampled if uid % 2 else None))
        done = eng.run()
        eng.close()
        return {r.uid: list(r.out_tokens) for r in done}, eng.metrics(), captures

    want, _, _ = serve()
    cont = dict(overlap=True, continuous=True, pipeline_depth=3)
    eager, me, _ = serve(**cont)
    got, m, captures = serve(aot=True, **cont)
    assert eager == want and got == want, name
    assert me["slot_swaps"] > 0 and m["slot_swaps"] > 0
    assert captures == m["captures"] == 2
    for gr in m["graphs"].values():
        assert gr["launches"][must] > 0
        assert gr["launches"].get("stage_install_rows", 0) == (0 if flags else 1)
