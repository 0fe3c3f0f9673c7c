"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode, as the JAX package's own tests
do.  Inputs come from numpy with a fixed seed and go to both.  Float32
throughout (TF32 off); tolerance atol = rtol = 1e-5 (f32 summation order
differs between the two).  ``test_torch_kernels_gpu.py`` holds the CUDA
kernels against these plain versions on the card.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_prefill import flash_prefill_attention as jax_k2
from repro.kernels.latent_decode import latent_decode_attention as jax_k1
from repro_torch.kernels import flash_prefill as K2
from repro_torch.kernels import latent_decode as K1
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
THETA = 1e4


def _k1_inputs(seed, B=2, S=13, G=2, s=2, qpk=2, dh=16, rk=8, rv=12,
               dead_row=None):
    """Numpy K1 operands: random positions (some slots empty), their RoPE
    tables and decode bias; ``dead_row`` masks one batch row entirely."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos = rng.permutation(S * B).reshape(B, S) % (S + 3) - 1
    cur = np.full(B, S + 1)
    half = dh // 2
    freq = THETA ** (-np.arange(half, dtype=np.float32) / half)
    ang = np.maximum(pos, 0)[..., None].astype(np.float32) * freq
    bias = np.where((pos >= 0) & (pos <= cur[:, None]), 0.0, NEG_INF)
    if dead_row is not None:
        bias[dead_row] = NEG_INF
    return dict(q=f(B, G, s * qpk, dh), zk=f(B, S, G, rk), zv=f(B, S, G, rv),
                r_k=f(G, rk, s * dh) / np.sqrt(rk), cos=np.cos(ang).astype(np.float32),
                sin=np.sin(ang).astype(np.float32), bias=bias.astype(np.float32),
                k_norm=0.3 * f(dh))


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


K1_CASES = {
    # name: (input kwargs, use k_norm)
    "groups2_knorm": (dict(G=2, s=2, qpk=2), True),
    "groups2_plain": (dict(G=2, s=2, qpk=2), False),
    "groups1_s4": (dict(G=1, s=4, qpk=1, rk=16, rv=8), True),
    # group_size 8: one group of 8 slots, 32 query rows (past one block)
    "groups1_s8": (dict(G=1, s=8, qpk=4, rk=24, rv=16), True),
    "dead_row": (dict(G=2, s=2, qpk=2, dead_row=1), True),
    # gemma3-12b's head width
    "dh256": (dict(G=2, s=2, qpk=2, dh=256, rk=16, rv=24), True),
    # h2o-danube-1.8b's head width, and qwen3-moe's 16 q heads a kv head
    "dh80": (dict(G=2, s=4, qpk=4, dh=80, rk=24, rv=16), True),
    "qpk16": (dict(G=1, s=2, qpk=16, rk=16, rv=8), True),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_plain_matches_pallas_interpret(case):
    """S = 13 is not a multiple of the 8-column tile; G = 2 exercises the
    group index; a dead row must come out as exact 0 on both sides."""
    kw, use_kn = K1_CASES[case]
    a = _k1_inputs(zlib.crc32(case.encode()), **kw)
    scale = a["q"].shape[-1] ** -0.5
    kn = a["k_norm"] if use_kn else None
    want = np.asarray(jax_k1(
        *[jnp.asarray(a[k]) for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")],
        scale=scale, block_s=8, interpret=True,
        k_norm=None if kn is None else jnp.asarray(kn)))
    t = _t(a)
    got = K1.latent_decode_attention(
        t["q"], t["zk"], t["zv"], t["r_k"], t["cos"], t["sin"], t["bias"],
        scale=scale, k_norm=t["k_norm"] if use_kn else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if kw.get("dead_row") is not None:
        assert (got[kw["dead_row"]] == 0).all() and (want[kw["dead_row"]] == 0).all()


def test_k1_plain_matches_jnp_oracle():
    a = _k1_inputs(5)
    scale = a["q"].shape[-1] ** -0.5
    want = np.asarray(jref.latent_decode_attention(
        *[jnp.asarray(a[k]) for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")],
        scale))
    t = _t(a)
    got = K1.latent_decode_attention_plain(
        t["q"], t["zk"], t["zv"], t["r_k"], t["cos"], t["sin"], t["bias"],
        scale=scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_k1_self_column_equals_appended_ring():
    """The self-column operands compute what appending the token to the
    ring computes (the JAX wrapper's _extend_ring), at bias 0."""
    a = _k1_inputs(9)
    b = _k1_inputs(10, S=1)
    t, u = _t(a), _t(b)
    scale = a["q"].shape[-1] ** -0.5
    got = K1.latent_decode_attention(
        t["q"], t["zk"], t["zv"], t["r_k"], t["cos"], t["sin"], t["bias"],
        scale=scale, k_norm=t["k_norm"], self_zk=u["zk"][:, 0],
        self_zv=u["zv"][:, 0], self_cos=u["cos"][:, 0], self_sin=u["sin"][:, 0])
    cat = lambda k: np.concatenate([a[k], b[k]], axis=1)
    bias = np.concatenate([a["bias"], np.zeros_like(b["bias"])], axis=1)
    want = jax_k1(jnp.asarray(a["q"]), jnp.asarray(cat("zk")), jnp.asarray(cat("zv")),
                  jnp.asarray(a["r_k"]), jnp.asarray(cat("cos")), jnp.asarray(cat("sin")),
                  jnp.asarray(bias), scale=scale, block_s=8, interpret=True,
                  k_norm=jnp.asarray(a["k_norm"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_latent_decode_glue_matches_jax_ops():
    """ops.latent_decode (tables, bias, grouping, self column) against the
    JAX ops wrapper on the same ring cache and self entry."""
    rng = np.random.default_rng(4)
    B, S, G, H, dh, r = 2, 11, 2, 8, 16, 8
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos = np.stack([np.arange(S), np.where(np.arange(S) < 6, np.arange(S), -1)])
    cur = np.array([S, 6])
    cache = {"zk": f(B, S, G, r), "zv": f(B, S, G, r), "pos": pos}
    entry = {"zk": f(B, G, r), "zv": f(B, G, r)}
    q, r_k, kn = f(B, H, dh), f(G, r, 2 * dh) / 3, 0.2 * f(dh)
    kw = dict(theta=THETA, window=5, scale=dh ** -0.5, norm_eps=1e-6)
    want = jops.latent_decode(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(r_k), jnp.asarray(cur), block_s=8, interpret=True,
        self_entry={k: jnp.asarray(v) for k, v in entry.items()},
        k_norm=jnp.asarray(kn), **kw)
    got = ops.latent_decode(
        torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in cache.items()},
        torch.from_numpy(r_k), torch.from_numpy(cur),
        self_entry={k: torch.from_numpy(v) for k, v in entry.items()},
        k_norm=torch.from_numpy(kn), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


K2_CASES = {
    # name: (T, H, Hkv, Hv, dh, dv, window)
    "latent_values_tail": (13, 8, 4, 2, 16, 24, None),
    "latent_values_window": (21, 8, 4, 1, 16, 8, 5),
    "dense_gqa": (16, 4, 2, 2, 8, 8, None),
    # r_v = 152 in one value group (group_size 8 at keep ratio 0.3)
    "latent_values_152": (13, 8, 2, 1, 16, 152, None),
    # dh 256 (gemma3-12b): dense values, windowed latent values, and latent
    # values past one 256-column slice
    "dh256_dense": (21, 4, 2, 2, 256, 256, None),
    "dh256_window": (21, 4, 2, 1, 256, 40, 5),
    "dh256_latent_520": (13, 4, 2, 1, 256, 520, None),
    # dh 80 (h2o-danube-1.8b): dense values in a window, latent values;
    # 16 query heads a kv head (qwen3-moe-235b-a22b), one value group
    "dh80_dense_window": (21, 8, 2, 2, 80, 80, 5),
    "dh80_latent": (13, 8, 4, 2, 80, 40, None),
    "qpk16_latent": (13, 32, 2, 1, 16, 24, None),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_matches_pallas_interpret(case):
    """Hv < Hkv, dv != dh, a window, and T not a multiple of the tile."""
    T, H, Hkv, Hv, dh, dv, win = K2_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    q = rng.standard_normal((2, T, H, dh)).astype(np.float32)
    k = rng.standard_normal((2, T, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, T, Hv, dv)).astype(np.float32)
    want = np.asarray(jax_k2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=win, block_q=8, block_k=8, interpret=True))
    got = ops.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), window=win).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrappers_take_plain_path_on_cpu_and_raise_elsewhere():
    """A CPU tensor runs the plain version without counting a launch; a
    tensor on a device with no kernel raises instead of falling back."""
    a = _t(_k1_inputs(1))
    before = (K1.latent_decode_attention.launches,
              K2.flash_prefill_attention.launches)
    args = [a[k] for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")]
    out = K1.latent_decode_attention(*args, scale=0.25)
    torch.testing.assert_close(out, K1.latent_decode_attention_plain(*args, scale=0.25))
    q = torch.randn(1, 5, 4, 8)
    K2.flash_prefill_attention(q, q[:, :, :2], q[:, :, :1])
    assert (K1.latent_decode_attention.launches,
            K2.flash_prefill_attention.launches) == before
    meta = [t.to("meta") for t in args]
    with pytest.raises(RuntimeError, match="no kernel"):
        K1.latent_decode_attention(*meta, scale=0.25)
    with pytest.raises(RuntimeError, match="no kernel"):
        K2.flash_prefill_attention(q.to("meta"), q.to("meta"), q.to("meta"))
