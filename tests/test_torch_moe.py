"""qwen3-moe-235b-a22b in the port — the capacity-routed MoE FFN
(``models.layers.moe_ffn``) under ``attn`` blocks with 4 kv heads — against
the JAX package at its smoke size (3 layers, 8 experts, top-2), dense and
at ``recalkv_ratio=0.5``:

* the registry: FULL and SMOKE equal JAX's configs field for field, and
  ``check_supported`` takes the arch on a CUDA device with the kernel
  backend (q_per_kv 16 at full width);
* ``moe_ffn`` against JAX's on numpy-seeded weights and tokens (1e-5): the
  default capacity, a tight one where tokens drop (repeated tokens, so the
  drop order decides who is dropped), the same N as a different (B, T),
  and one shared expert;
* prefill, decode and verify logits through the port's einsum and kernel
  backends (the plain versions on the CPU) against JAX's einsum (dense) or
  its Pallas kernels in interpret mode (latent), also at 32 q heads over 2
  kv heads (q_per_kv 16 at the model level);
* greedy ``Engine`` streams equal to the JAX engine's run with the same
  flags, token for token: sync, ``spec_depth=3`` with ``"ngram"``,
  overlapped with continuous batching (inline admission), and the paged
  pool on the latent cache, sync and paged on the dense one (a verify
  call's N = 16 rows can drop tokens, so each variant meets its own JAX
  run);
* ``compress("recalkv", keep_ratio=0.5)``: the same ``ranks_by_layer`` and
  logits within 1e-4; and the compressed artifact written by one package
  and read by the other, expert leaves and the float32 router intact.

Float32 with TF32 off.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as JA
from repro.configs import get_config
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
import repro_torch.api as A
from repro_torch import configs as PC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import (MambaConfig, MLAConfig, ModelConfig, MoEConfig,
                                      check_supported)
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.serving import Engine, Request

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ARCH = "qwen3-moe-235b-a22b"
LOGITS = dict(atol=1e-4, rtol=0)
RATIOS = {"dense": None, "latent": 0.5}
JAX_BACKEND = {"dense": "einsum", "latent": "pallas"}
JAX_STEPS = types.SimpleNamespace(
    prefill=jax.jit(JT.prefill, static_argnums=(0, 4)),
    decode_step=jax.jit(JT.decode_step, static_argnums=(0,)),
    verify_step=jax.jit(JT.verify_step, static_argnums=(0,)))
MAX_LEN = 48
ENGINE = dict(max_slots=4, max_len=MAX_LEN, sync_every=4)
_MODELS, _LOGITS = {}, {}


def _model(kind, backend="einsum", heads=None):
    """(JAX cfg, JAX params, port cfg, port params) of the smoke config,
    once per (kind, heads); ``heads`` = (q heads, kv heads) replaces the
    smoke's 8 over 2; ``backend`` rebinds only the configs."""
    key = (kind, heads)
    if key not in _MODELS:
        cfg = dataclasses.replace(get_config(ARCH, smoke=True, recalkv_ratio=RATIOS[kind]),
                                  dtype=jnp.float32)
        if heads:
            cfg = dataclasses.replace(cfg, num_heads=heads[0], num_kv_heads=heads[1])
        params = JT.init_params(cfg, jax.random.PRNGKey(13))
        pcfg = ModelConfig.from_dict(cfg.to_dict())
        _MODELS[key] = (cfg, params, pcfg,
                        params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                        device="cpu"))
    cfg, params, pcfg, pp = _MODELS[key]
    return (dataclasses.replace(cfg, attn_backend=backend), params,
            dataclasses.replace(pcfg, attn_backend="kernel" if backend == "pallas"
                                else "einsum"), pp)


def test_registry_and_check_supported():
    """FULL and SMOKE, dense and at ratio 0.5 (G 1 group of s 4, r 256 at
    full width), equal JAX's config dicts, MoEConfig included; the CPU and
    a CUDA device with the kernel backend take them (q_per_kv 16); an MLA
    config passes too (ported), and so does a Mamba config (ported
    since).  No card is needed: the check reads the config."""
    assert ARCH in PC.ARCHS
    for smoke in (False, True):
        for ratio in RATIOS.values():
            got = PC.get_config(ARCH, smoke=smoke, recalkv_ratio=ratio)
            assert got.to_dict() == get_config(ARCH, smoke=smoke,
                                               recalkv_ratio=ratio).to_dict()
            check_supported(got)
            if not smoke:
                check_supported(dataclasses.replace(got, attn_backend="kernel"),
                                torch.device("cuda"))
    full = PC.get_config(ARCH, recalkv_ratio=0.5)
    assert full.moe == MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                                 capacity_factor=1.25, router_zloss=1e-3)
    assert (full.recalkv.num_groups(4), full.recalkv.rank_k) == (1, 256)
    assert full.num_heads // full.num_kv_heads == 16
    check_supported(dataclasses.replace(full, mla=MLAConfig()))
    check_supported(dataclasses.replace(full, mamba=MambaConfig()))   # ported since


MOE_CASES = {
    # name: ((B, T), capacity_factor, num_shared, repeated tokens)
    "default": ((2, 32), 1.25, 0, False),
    "tight_drops": ((2, 32), 0.5, 0, True),
    "same_n_other_shape": ((4, 16), 0.5, 0, True),
    "shared_expert": ((3, 8), 1.25, 1, False),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_jax(case):
    """``moe_ffn`` of the smoke widths (d 64, 8 experts, top 2, d_expert 64)
    on numpy-seeded weights and tokens equals JAX's within 1e-5, and so
    does its aux loss term (``with_aux``; serving's call, without it,
    gives the same output and no aux); in the
    tight cases tokens are dropped (asserted), and tokens 8-15 repeat
    tokens 0-7, so which of two equal tokens keeps its slot is the drop
    order's choice."""
    (B, Tn), cf, shared, repeat = MOE_CASES[case]
    m = MoEConfig(num_experts=8, top_k=2, d_expert=64, num_shared=shared,
                  capacity_factor=cf)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), moe=m, dtype=jnp.float32)
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    rng = np.random.default_rng(17)
    d, E, f = 64, 8, 64
    p = {"router": rng.normal(size=(d, E)) * d ** -0.5,
         "wi": rng.normal(size=(E, d, f)) * d ** -0.5,
         "wg": rng.normal(size=(E, d, f)) * d ** -0.5,
         "wo": rng.normal(size=(E, f, d)) * f ** -0.5}
    if shared:
        p["shared"] = {"wi": rng.normal(size=(d, f)) * d ** -0.5,
                       "wg": rng.normal(size=(d, f)) * d ** -0.5,
                       "wo": rng.normal(size=(f, d)) * f ** -0.5}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    x = rng.normal(size=(B * Tn, d)).astype(np.float32)
    if repeat:
        x[8:16] = x[0:8]
    x = x.reshape(B, Tn, d)
    want, waux = JL.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg)
    tp = jax.tree.map(torch.as_tensor, p)
    got, aux = L.moe_ffn(tp, torch.as_tensor(x), pcfg, with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert float(aux) == pytest.approx(float(waux), rel=1e-5)
    served, none = L.moe_ffn(tp, torch.as_tensor(x), pcfg)
    assert none is None and torch.equal(served, got)
    N = B * Tn
    cap = max(8, int(np.ceil(N * 2 / E * cf / 8)) * 8)
    sel = torch.topk(torch.softmax(torch.as_tensor(x).reshape(N, d) @ tp["router"], -1),
                     2).indices
    dropped = int((L._expert_positions(sel, E) >= cap).sum())
    assert dropped > 0 or cf >= 1


def _steps(mod, cfg, params, conv):
    """Prompts of 20 / 13 / 7 tokens, two greedy decode steps, then one
    S = 4 verify step with a -1 pad and masked columns: the logits of
    each (prefill and decode (3, V), verify (3, 4, V))."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 20))
    lens = np.array([20, 13, 7])
    logits, caches = mod.prefill(cfg, params, conv(toks), conv(lens), MAX_LEN)
    outs, cur = [np.asarray(logits)], lens.copy()
    for _ in range(2):
        logits, caches = mod.decode_step(cfg, params, caches, conv(outs[-1].argmax(-1)),
                                         conv(cur))
        outs.append(np.asarray(logits))
        cur = cur + 1
    fed = rng.integers(0, cfg.vocab_size, (3, 4))
    fed[1, 3] = -1
    mask = np.array([[True] * 4, [True, True, True, False], [True, False, False, False]])
    vlog, _ = mod.verify_step(cfg, params, caches, conv(fed), conv(cur), conv(mask))
    return np.stack(outs), np.asarray(vlog)


def _jconv(a):
    a = np.asarray(a)
    return jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, jnp.int32)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("kind,heads", [("dense", None), ("latent", None),
                                        ("latent", (32, 2))])
def test_logits_match_jax(kind, heads, backend):
    """Prefill, decode and verify logits within 1e-4 of JAX's einsum
    (dense) or its Pallas kernels in interpret mode (latent), one JAX run
    per config, through both port backends; (32, 2) is 32 q heads over 2
    kv heads, q_per_kv 16, through K1 / K5's plain versions (the dense
    cores' at q_per_kv 16 are cases of test_torch_dense_decode.py and
    test_torch_dense_verify.py)."""
    cfg, params, _, pp = _model(kind, JAX_BACKEND[kind], heads)
    if (kind, heads) not in _LOGITS:
        _LOGITS[kind, heads] = _steps(JAX_STEPS, cfg, params, _jconv)
    pcfg = dataclasses.replace(_model(kind, heads=heads)[2], attn_backend=backend)
    for got, want in zip(_steps(T, pcfg, pp, torch.as_tensor), _LOGITS[kind, heads]):
        np.testing.assert_allclose(got, want, **LOGITS)


def _prompts(vocab):
    """Five prompts (one more than the slots), one a repeated motif for the
    n-gram draft."""
    rng = np.random.default_rng(7)
    motif = rng.integers(0, vocab, 6)
    return [rng.integers(0, vocab, 27), np.tile(motif, 4), rng.integers(0, vocab, 9),
            rng.integers(0, vocab, 18), rng.integers(0, vocab, 12)]


def _serve(eng, prompts, port=True):
    R = Request if port else JRequest
    for i, p in enumerate(prompts):
        eng.submit(R(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=8))
    done = eng.run()
    eng.close()
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}


VARIANTS = {"sync": {}, "ngram3": dict(spec_depth=3, draft="ngram"),
            # inline admission: a worker thread forms waves as requests
            # arrive, and MoE rows of one call share the experts' capacity
            "overlap_continuous": dict(overlap=True, continuous=True, pipeline_depth=2,
                                       admission_thread=False),
            "paged": dict(cache_layout="paged", page_size=8)}


# every variant on the latent cache (the port's kernel glue), the dense
# cache sync and paged (its own pool): each case costs a JAX engine run
STREAM_CASES = [("latent", v) for v in sorted(VARIANTS)] + [("dense", "sync"),
                                                            ("dense", "paged")]


@pytest.mark.parametrize("kind,variant", STREAM_CASES)
def test_engine_streams_match_jax(kind, variant):
    """Greedy streams of the port's engine equal the JAX engine's with the
    same flags, token for token: every call's N (prefill chunks, padded
    rows, verify widths, idle and staged rows) must be JAX's, since a
    token's MoE output depends on the other rows of its call once
    capacity drops."""
    cfg, params, pcfg, pp = _model(kind)
    flags = VARIANTS[variant]
    want = _serve(JEngine(cfg, params, **ENGINE, **flags), _prompts(cfg.vocab_size),
                  port=False)
    got = _serve(Engine(pcfg, pp, device="cpu", **ENGINE, **flags), _prompts(cfg.vocab_size))
    assert got == want


def test_compress_and_artifacts_match_jax(tmp_path):
    """``calibrate`` + ``compress("recalkv", keep_ratio=0.5)`` of the dense
    smoke model (``scan_layers=False``), whose calibration forward runs
    the MoE FFN: the same compressed config and ranks as JAX's, logits
    within 1e-4, the expert tensors shared with the dense model; the
    port's artifact loads in JAX and JAX's in the port with every leaf
    equal (the router float32)."""
    cfg, _, pcfg, pp = _model("dense")
    cfg = dataclasses.replace(cfg, scan_layers=False)
    pcfg = dataclasses.replace(pcfg, scan_layers=False)
    params = jax.tree.map(jnp.asarray, params_to_jax(pcfg, pp))
    batches = [jsyn.batch(jsyn.DataConfig(vocab_size=cfg.vocab_size, seq_len=32), "calib",
                          i, 2) for i in range(2)]
    want = JA.compress(cfg, params, JA.CompressionSpec(
        "recalkv", rank_policy=JA.RankPolicy(keep_ratio=0.5)),
        JA.calibrate(cfg, params, [{"tokens": jnp.asarray(b["tokens"])} for b in batches]))
    got = A.compress(pcfg, pp, A.CompressionSpec(
        "recalkv", rank_policy=A.RankPolicy(keep_ratio=0.5)),
        A.calibrate(pcfg, pp, batches))
    assert got.cfg.to_dict() == want.cfg.to_dict()
    assert got.provenance["ranks_by_layer"] == want.provenance["ranks_by_layer"]
    assert got.params["layers"][0]["mlp"]["wi"] is pp["layers"][0]["mlp"]["wi"]
    for a, b in zip(_steps(T, got.cfg, got.params, torch.as_tensor),
                    _steps(JAX_STEPS, want.cfg, want.params, _jconv)):
        np.testing.assert_allclose(a, b, **LOGITS)
    A.save_artifact(got, str(tmp_path / "port"))
    jart = JA.load_artifact(str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(jart.params),
                    jax.tree.leaves(params_to_jax(got.cfg, got.params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jart.params["prefix"][0]["mlp"]["router"].dtype == np.float32
    JA.save_artifact(want, str(tmp_path / "jax"))
    back = A.load_artifact(str(tmp_path / "jax"), device="cpu")
    assert back.cfg.to_dict() == want.cfg.to_dict()
    assert back.params["layers"][1]["mlp"]["router"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(params_to_jax(back.cfg, back.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want.params))):
        np.testing.assert_array_equal(a, b)
