"""The port's int8 latent ring against the JAX package: quantization, K3's
plain version against the Pallas kernel in interpret mode, the decode
reader on both backends, prefill + decode logits and greedy Engine streams
with ``cache_quant_bits=8``.

Float32 with TF32 off.  Tolerances: quantizing the same input gives equal
values and scales; kernel and module outputs atol = rtol = 1e-5 (f32
summation order differs); logits atol 1e-4; streams token for token.
"""

import dataclasses
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.latent_decode_q import latent_decode_attention_quant as jax_k3
from repro.models import kv_cache as JKC
from repro.models import transformer as JT
from repro.quant import dequantize as jdeq
from repro.quant import quantize as jquant
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.kernels import latent_decode_q as KQ
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as KC
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.quant import dequantize, fake_quant, quantize
from repro_torch.serving import Engine, Request

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=0)
THETA = 1e4
JAX_JIT = types.SimpleNamespace(
    prefill=jax.jit(JT.prefill, static_argnums=(0, 4)),
    decode_step=jax.jit(JT.decode_step, static_argnums=(0,)))


def _jax_cfg(backend="einsum", bits=8):
    cfg = get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5)
    return dataclasses.replace(cfg, dtype=jnp.float32, attn_backend=backend,
                               cache_quant_bits=bits)


def _jax_params(cfg, seed=0):
    """JAX init with the zero norm scales perturbed (qk-norm exercised)."""
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def bump(path, x):
        if getattr(path[-1], "key", "") in ("q_norm", "k_norm", "ln1", "ln2",
                                            "final_norm"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(bump, params)


def _port(cfg, params):
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_quantize_dequantize_equal_jax(bits):
    """Round half to even on both sides, ties included (x = k + 0.5 steps)."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 5, 2, 24)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 127.0]        # exact ties at scale 1
    q, s = quantize(torch.from_numpy(x), bits)
    jq, js = jquant(jnp.asarray(x), bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize(q, s).numpy(), np.asarray(jdeq(jq, js)))
    np.testing.assert_array_equal(fake_quant(torch.from_numpy(x), bits).numpy(),
                                  np.asarray(jdeq(jq, js)))
    with pytest.raises(ValueError):
        quantize(torch.from_numpy(x), 5)


def _k3_inputs(seed, B=2, S=13, G=2, s=2, qpk=2, dh=16, rk=8, rv=12, dead_row=None):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos = rng.permutation(S * B).reshape(B, S) % (S + 3) - 1
    cur = np.full(B, S + 1)
    half = dh // 2
    freq = THETA ** (-np.arange(half, dtype=np.float32) / half)
    ang = np.maximum(pos, 0)[..., None].astype(np.float32) * freq
    bias = np.where((pos >= 0) & (pos <= cur[:, None]), 0.0, -1e30).astype(np.float32)
    if dead_row is not None:
        bias[dead_row] = -1e30
    zk_q, zk_s = (np.asarray(a) for a in jquant(jnp.asarray(f(B, S, G, rk)), 8))
    zv_q, zv_s = (np.asarray(a) for a in jquant(jnp.asarray(f(B, S, G, rv)), 8))
    return dict(q=f(B, G, s * qpk, dh), zk_q=zk_q, zk_s=zk_s[..., 0], zv_q=zv_q,
                zv_s=zv_s[..., 0], r_k=f(G, rk, s * dh) / np.sqrt(rk),
                cos=np.cos(ang).astype(np.float32), sin=np.sin(ang).astype(np.float32),
                bias=bias, k_norm=0.3 * f(dh))


ORDER = ("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin", "bias")
K3_CASES = {
    "groups2_knorm": (dict(G=2, s=2, qpk=2), True),
    "groups1_s4": (dict(G=1, s=4, qpk=1, rk=16, rv=8), True),
    "groups1_s8": (dict(G=1, s=8, qpk=4, rk=24, rv=16), True),
    "groups2_plain": (dict(G=2, s=2, qpk=2), False),
    "dead_row": (dict(G=2, s=2, qpk=2, dead_row=1), True),
    "dh256": (dict(G=2, s=2, qpk=2, dh=256, rk=16, rv=24), True),
    "dh80": (dict(G=2, s=4, qpk=4, dh=80, rk=24, rv=16), True),
    "qpk16": (dict(G=1, s=2, qpk=16, rk=16, rv=8), True),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_plain_matches_pallas_interpret(case):
    """S = 13 (a tail tile at block 8), G = 1 and 2, k-norm, and a dead row
    that must be exact 0 on both sides."""
    kw, use_kn = K3_CASES[case]
    a = _k3_inputs(zlib.crc32(case.encode()), **kw)
    scale = a["q"].shape[-1] ** -0.5
    want = np.asarray(jax_k3(*[jnp.asarray(a[k]) for k in ORDER], scale=scale,
                             block_s=8, interpret=True,
                             k_norm=jnp.asarray(a["k_norm"]) if use_kn else None))
    got = KQ.latent_decode_attention_quant(
        *[torch.from_numpy(a[k]) for k in ORDER], scale=scale,
        k_norm=torch.from_numpy(a["k_norm"]) if use_kn else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if kw.get("dead_row") is not None:
        assert (got[kw["dead_row"]] == 0).all() and (want[kw["dead_row"]] == 0).all()


def test_k3_self_column_is_the_quantized_round_trip():
    """The self operands (int8 + scale) compute what the JAX wrapper's
    appended quantized entry computes: the fresh latents' quantize ->
    dequantize round trip, at bias 0."""
    a, b = _k3_inputs(9), _k3_inputs(10, S=1)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    u = {k: torch.from_numpy(v) for k, v in b.items()}
    scale = a["q"].shape[-1] ** -0.5
    got = KQ.latent_decode_attention_quant(
        *[t[k] for k in ORDER], scale=scale, k_norm=t["k_norm"],
        self_zk_q=u["zk_q"][:, 0], self_zk_s=u["zk_s"][:, 0],
        self_zv_q=u["zv_q"][:, 0], self_zv_s=u["zv_s"][:, 0],
        self_cos=u["cos"][:, 0], self_sin=u["sin"][:, 0])
    cat = {k: np.concatenate([a[k], b[k]], axis=1) for k in ORDER[1:-1] if k != "r_k"}
    bias = np.concatenate([a["bias"], np.zeros_like(b["bias"])], axis=1)
    want = jax_k3(jnp.asarray(a["q"]), *[jnp.asarray(cat[k]) for k in ORDER[1:5]],
                  jnp.asarray(a["r_k"]), jnp.asarray(cat["cos"]), jnp.asarray(cat["sin"]),
                  jnp.asarray(bias), scale=scale, block_s=8, interpret=True,
                  k_norm=jnp.asarray(a["k_norm"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_glue_routes_to_k3_and_matches_jax_ops():
    """ops.latent_decode over an int8 ring dict (K3 with the quantized self
    entry as operands) against the JAX ops wrapper."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(4)
    B, S, G, H, dh, r = 2, 11, 2, 8, 16, 8
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos = np.stack([np.arange(S), np.where(np.arange(S) < 6, np.arange(S), -1)])
    cfg8 = ModelConfig.from_dict(_jax_cfg().to_dict())
    cache = {**KC.latent_cache_entry(cfg8, torch.from_numpy(f(B, S, G, r)),
                                     torch.from_numpy(f(B, S, G, r))),
             "pos": torch.from_numpy(pos)}
    entry = KC.latent_cache_entry(cfg8, torch.from_numpy(f(B, G, r)),
                                  torch.from_numpy(f(B, G, r)))
    q, r_k, kn, cur = f(B, H, dh), f(G, r, 2 * dh) / 3, 0.2 * f(dh), np.array([S, 6])
    kw = dict(theta=THETA, window=5, scale=dh ** -0.5, norm_eps=1e-6)
    want = jops.latent_decode(
        jnp.asarray(q), {k: jnp.asarray(v.numpy()) for k, v in cache.items()},
        jnp.asarray(r_k), jnp.asarray(cur), block_s=8, interpret=True,
        self_entry={k: jnp.asarray(v.numpy()) for k, v in entry.items()},
        k_norm=jnp.asarray(kn), **kw)
    n = KQ.latent_decode_attention_quant.launches
    got = ops.latent_decode(torch.from_numpy(q), cache, torch.from_numpy(r_k),
                            torch.from_numpy(cur), self_entry=entry,
                            k_norm=torch.from_numpy(kn), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert KQ.latent_decode_attention_quant.launches == n      # CPU: plain version


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_decode_attn_latent_int8_matches_jax(backend):
    cfg = _jax_cfg(backend)
    params = _jax_params(cfg)
    pcfg, pp = _port(cfg, params)
    rng = np.random.default_rng(2)
    B, Lr = 2, 20
    G, r = cfg.recalkv.num_groups(cfg.num_kv_heads), cfg.recalkv.rank_k
    pos = np.stack([np.arange(Lr), np.where(np.arange(Lr) < 9, np.arange(Lr), -1)])
    zk_q, zk_s = jquant(jnp.asarray(rng.standard_normal((B, Lr, G, r)), jnp.float32))
    zv_q, zv_s = jquant(jnp.asarray(rng.standard_normal((B, Lr, G, r)), jnp.float32))
    cache = {"zk_q": np.asarray(zk_q), "zk_s": np.asarray(zk_s)[..., 0],
             "zv_q": np.asarray(zv_q), "zv_s": np.asarray(zv_s)[..., 0], "pos": pos}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cur = np.array([Lr, 9])
    p0 = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
    y, upd = JKC.decode_attn_latent(p0, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in cache.items()},
                                    cfg, jnp.asarray(cur), None)
    yt, updt = KC.decode_attn_latent(pp["layers"][0]["attn"], torch.from_numpy(x),
                                     {k: torch.from_numpy(v) for k, v in cache.items()},
                                     pcfg, torch.from_numpy(cur), None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
    assert set(updt) == set(upd) == {"zk_q", "zk_s", "zv_q", "zv_s", "pos"}
    # the fresh latents differ in the last f32 bits (summation order), so a
    # scale may move by an ulp and a value sitting on a rounding boundary
    # by one int8 step
    for k in ("zk_s", "zv_s"):
        np.testing.assert_allclose(updt[k].numpy(), np.asarray(upd[k]), rtol=1e-5)
    for k in ("zk_q", "zv_q"):
        d = np.abs(updt[k].numpy().astype(int) - np.asarray(upd[k]).astype(int))
        assert d.max() <= 1, k
    np.testing.assert_array_equal(updt["pos"].numpy(), np.asarray(upd["pos"]))


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_int8_prefill_decode_logits_match_jax(backend):
    """prefill (int8 ring written through latent_cache_entry) + 4 decode
    steps, ring length 37."""
    cfg = _jax_cfg(backend)
    params = _jax_params(cfg, seed=3)
    pcfg, pp = _port(cfg, params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    lens = np.array([9, 6])
    outs = {}
    for name, mod, conv in (("jax", JAX_JIT, lambda a: jnp.asarray(a, jnp.int32)),
                            ("port", T, torch.as_tensor)):
        logits, caches = mod.prefill(cfg if name == "jax" else pcfg,
                                     params if name == "jax" else pp,
                                     conv(toks), conv(lens), 37)
        seq = [np.asarray(logits)]
        cur, tok = lens.copy(), np.asarray(logits).argmax(-1)
        for _ in range(4):
            logits, caches = mod.decode_step(cfg if name == "jax" else pcfg,
                                             params if name == "jax" else pp,
                                             caches, conv(tok), conv(cur))
            seq.append(np.asarray(logits))
            tok, cur = np.asarray(logits).argmax(-1), cur + 1
        outs[name] = seq
        if name == "port":
            assert caches[0]["self"]["zk_q"].dtype == torch.int8
    for i, (a, b) in enumerate(zip(outs["jax"], outs["port"])):
        np.testing.assert_allclose(b, a, err_msg=f"step {i}", **LOGITS)


MIXED_KW = dict(max_slots=2, max_len=40, sync_every=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def int8_served():
    cfg = _jax_cfg()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    g = np.random.default_rng(3)
    prompts = [g.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 7, 12, 3)]
    eng = JEngine(cfg, params, **MIXED_KW)
    for i, pr in enumerate(prompts):
        eng.submit(JRequest(uid=i, prompt=pr.copy(), max_new_tokens=6))
    want = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
    return (*_port(cfg, params), prompts, want)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_int8_engine_greedy_streams_match_jax(int8_served, backend):
    pcfg, pp, prompts, want = int8_served
    eng = Engine(pcfg, pp, backend=backend, device="cpu", **MIXED_KW)
    for i, pr in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=pr.copy(), max_new_tokens=6))
    assert {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()} == want
    assert eng.cache[0]["self"]["zv_q"].dtype == torch.int8


def test_config_takes_cache_quant_bits():
    """ModelConfig validates it as the JAX package does; get_config and a
    JAX-written config dict carry it; check_supported accepts it."""
    from repro_torch.configs import get_config as pt_get_config
    from repro_torch.models.config import check_supported
    pcfg = ModelConfig.from_dict(_jax_cfg().to_dict())
    assert pcfg.cache_quant_bits == 8 and pcfg.to_dict() == _jax_cfg().to_dict()
    check_supported(pcfg)
    assert pt_get_config("qwen3-4b", recalkv_ratio=0.5,
                         cache_quant_bits=4).cache_quant_bits == 4
    with pytest.raises(ValueError, match="3, 4 or 8"):
        dataclasses.replace(pcfg, cache_quant_bits=5)
    with pytest.raises(ValueError, match="recalkv"):
        dataclasses.replace(pcfg, recalkv=None)
