"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: without a CUDA device each test skips (the kernels have
no CPU mode).  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: max |kernel - plain| <= 1e-4 in float32 (TF32 off; the
summation order differs) and <= 2e-2 in bf16 (one bf16 rounding of
outputs of order 1).
"""

import math

import pytest
import torch

from repro_torch.kernels import flash_prefill as K2
from repro_torch.kernels import latent_decode as K1
from repro_torch.kernels import ops

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
