"""Cross-attention and encoder-decoder models in the port —
``llama-3.2-vision-11b`` (``cross`` layers every 5th block) and
``whisper-small`` (an encoder of non-causal ``attn_dense`` blocks and a
decoder of ``attn_cross`` blocks) — against the JAX package at their smoke
sizes, float32 with TF32 off, on numpy-seeded inputs and weights carried
by ``params_from_jax``:

* the registry: FULL and SMOKE equal JAX's config dicts; ``check_supported``
  takes both (also on a CUDA device with the kernel backend), and the
  recurrent falcon-mamba and recurrentgemma too;
* the four cross functions, the non-causal dense attention and ``encode``
  (rtol / atol 1e-5);
* ``forward_hidden`` for whisper, llama-vision and qwen3-4b (1e-4; aux 0;
  a MoE model's aux JAX's, 1e-5), and prefill-then-decode reproducing the forward for
  both new models, dense and latent (2e-3, as JAX's ``test_models.py``);
* ``params_*`` / ``caches_*`` round trips with ``encoder`` and ``cross``
  leaves, unrolled and scanned (bit for bit);
* ``capture_calibration`` with a source and ``compress_model`` with cross
  layers (1e-4), the cross-only rank fallback, the quantized-latent walk;
* Engine greedy-and-sampled streams token for token against the JAX
  engine, one run per reference: sync, overlapped and continuous and, on
  llama-vision, n-gram depth 2 (a wave's row i reads source row i in
  both packages: on distinct source rows a variant needs the JAX
  engine's own waves, on one row repeated any waves give the sync
  streams); the paged refusal, the kernel backend's ``RuntimeWarning``
  (JAX's fallback kinds) and a missing source.

The "compressed" whisper is the latent config's random init, as the JAX
package draws it: JAX's ``encode`` cannot run a compressed whisper (its
dense encoder blocks under the decoder's latent config, ROADMAP.md
Queue 3); llama-vision's is JAX's ``compress_model`` output.
"""

import dataclasses
import functools
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as JA
from repro.configs import get_config
from repro.core import pipeline as JP
from repro.models import compress as JC
from repro.models import kv_cache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
import repro_torch.api as A
from repro_torch import configs as PC
from repro_torch.core import pipeline as P
from repro_torch.models import compress as C
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.weights import (caches_from_jax, caches_to_jax, init_params,
                                        params_from_jax, params_to_jax)
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
VISION, WHISPER = "llama-3.2-vision-11b", "whisper-small"
TOL = dict(rtol=1e-5, atol=1e-5)
FWD = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_slots=4, max_len=48, sync_every=4)
SAMPLED = dict(temperature=0.8, top_k=20, seed=3)
_RUNS = {}
# one compile per config and shape, not one dispatch per op
J_ENCODE = jax.jit(JT.encode, static_argnums=0)
J_FORWARD = jax.jit(JT.forward_hidden, static_argnums=0)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(0, 4))
J_DECODE = jax.jit(JT.decode_step, static_argnums=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


@functools.lru_cache(maxsize=None)
def _model(arch, latent=False, scan=False):
    """(JAX cfg, JAX params, port cfg, port params) of the float32 smoke
    config (the latent config's random init with ``latent``)."""
    kw = {"recalkv_ratio": 0.5} if latent else {}
    cfg = dataclasses.replace(get_config(arch, smoke=True, **kw), dtype=jnp.float32,
                              scan_layers=scan)
    params = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return cfg, params, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                              device="cpu")


def _source(cfg, rows, seed=4):
    return np.random.default_rng(seed).normal(
        size=(rows, cfg.cross_source_len, cfg.d_model)).astype(np.float32)


def _calib_batches(cfg, n=2):
    g = np.random.default_rng(5)
    return [{"tokens": g.integers(0, cfg.vocab_size, (2, 16)),
             "source": _source(cfg, 2, seed=6 + i)} for i in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_compressed(arch):
    """JAX's ``compress_model`` of the dense smoke model (keep 0.5, group 2),
    on statistics captured with a source: (cfg, params, stats)."""
    cfg, params, _, _ = _model(arch)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in _calib_batches(cfg)]
    stats = JC.capture_calibration(cfg, params, batches)
    rc = JP.ReCalKVConfig(keep_ratio=0.5, group_size=2, use_fisher=False)
    ccfg, cparams = JC.compress_model(cfg, params, stats, rc)
    return ccfg, cparams, stats


def test_registry_and_refusals():
    """FULL and SMOKE equal JAX's config dicts (and their ReCalKV ratio's);
    ``check_supported`` takes both, FULL on a CUDA device with the kernel
    backend too (dh 128 / 64, q_per_kv 4 / 1); so it does the recurrent
    falcon-mamba (no ratio: ReCalKV does not apply) and recurrentgemma
    (dh 256, q_per_kv 16), whose configs equal JAX's too."""
    for arch in (VISION, WHISPER):
        assert arch in PC.ARCHS and PC.RECALKV_APPLICABLE[arch]
        for smoke in (False, True):
            for ratio in (None, 0.5):
                got = PC.get_config(arch, smoke=smoke, recalkv_ratio=ratio)
                assert got.to_dict() == get_config(arch, smoke=smoke,
                                                   recalkv_ratio=ratio).to_dict()
                check_supported(got)
                if not smoke:   # the smoke widths are the CPU's alone
                    check_supported(dataclasses.replace(got, attn_backend="kernel"),
                                    "cuda")
    for arch, ratios in (("falcon-mamba-7b", (None,)), ("recurrentgemma-9b", (None, 0.5))):
        for smoke in (False, True):
            for ratio in ratios:
                got = PC.get_config(arch, smoke=smoke, recalkv_ratio=ratio)
                assert got.to_dict() == get_config(arch, smoke=smoke,
                                                   recalkv_ratio=ratio).to_dict()
                check_supported(ModelConfig.from_dict(got.to_dict()))
                if not smoke:
                    check_supported(dataclasses.replace(got, attn_backend="kernel"),
                                    "cuda")


@pytest.mark.parametrize("latent", [False, True])
def test_cross_functions_and_encode_match_jax(latent):
    """``make_cross_source_*``, ``cross_attention_*`` (key absorption on the
    latent side), the decode readers at 1 and 3 query tokens, dense
    attention with ``causal=False`` and ``encode`` against JAX's on
    seeded inputs."""
    cfg, params, pcfg, pp = _model(WHISPER, latent)
    g = np.random.default_rng(7)
    x = g.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    src = _source(cfg, 2)
    jp, p = params["prefix"][0]["cross"], pp["layers"][0]["cross"]
    make_j = JL.make_cross_source_latent if latent else JL.make_cross_source_dense
    make_p = L.make_cross_source_latent if latent else L.make_cross_source_dense
    attend_j = JL.cross_attention_latent if latent else JL.cross_attention_dense
    attend_p = L.cross_attention_latent if latent else L.cross_attention_dense
    want_src = jax.jit(make_j, static_argnums=2)(jp, jnp.asarray(src), cfg)
    got_src = make_p(p, _t(src), pcfg)
    for w, o in zip(want_src, got_src):
        np.testing.assert_allclose(_np(o), np.asarray(w), **TOL)
    np.testing.assert_allclose(_np(attend_p(p, _t(x), got_src, pcfg)),
                               np.asarray(jax.jit(attend_j, static_argnums=3)(
                                   jp, jnp.asarray(x), want_src, cfg)), **TOL)
    cache = dict(zip(("zk", "zv") if latent else ("k", "v"), want_src))
    reader_j = JKC.decode_cross_latent if latent else JKC.decode_cross_dense
    reader_p = KC.decode_cross_latent if latent else KC.decode_cross_dense
    pcache = {k: _t(v) for k, v in cache.items()}
    for n in (1, 3):
        np.testing.assert_allclose(
            _np(reader_p(p, _t(x[:, :n]), pcache, pcfg)),
            np.asarray(jax.jit(reader_j, static_argnums=3)(
                jp, jnp.asarray(x[:, :n]), cache, cfg)[0]), **TOL)
    if not latent:
        pos = np.broadcast_to(np.arange(5), (2, 5))
        a = params["encoder"]["blocks"][0]["attn"]
        want, _ = jax.jit(functools.partial(JL.self_attention_dense, cfg=cfg, window=None,
                                            causal=False, use_kernel=False))(
            a, jnp.asarray(x), positions=jnp.asarray(pos))
        got, _ = L.self_attention_dense(pp["encoder"]["layers"][0]["attn"], _t(x), pcfg,
                                        _t(pos), None, causal=False, use_kernel=False)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(T.encode(pcfg, pp, _t(src))),
                               np.asarray(J_ENCODE(cfg, params, jnp.asarray(src))), **TOL)


@pytest.mark.parametrize("arch", [WHISPER, VISION, "qwen3-4b"])
def test_forward_hidden_matches_jax(arch):
    """``forward_hidden`` (the einsum path, the source encoded for whisper)
    equals JAX's within 1e-4, its aux JAX's 0; a MoE model returns its
    hidden states and its load-balance and router z-loss aux, JAX's
    within 1e-5."""
    cfg, params, pcfg, pp = _model(arch)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12))
    src = _source(cfg, 2) if cfg.cross_source_len else None
    want, waux = J_FORWARD(cfg, params, jnp.asarray(toks, jnp.int32),
                           None if src is None else jnp.asarray(src))
    got, aux = T.forward_hidden(pcfg, pp, _t(toks), None if src is None else _t(src))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    assert float(aux) == float(waux) == 0.0 and aux.dtype == torch.float32
    if arch == "qwen3-4b":
        cfg, params, pcfg, pp = _model("qwen3-moe-235b-a22b")
        want, waux = J_FORWARD(cfg, params, jnp.asarray(toks, jnp.int32))
        got, aux = T.forward_hidden(pcfg, pp, _t(toks))
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
        assert float(waux) > 0 and aux.dtype == torch.float32
        assert float(aux) == pytest.approx(float(waux), rel=1e-5)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
@pytest.mark.parametrize("latent", [False, True])
def test_prefill_then_decode_reproduces_forward(arch, latent):
    """Prefill of 8 tokens then 4 decode steps give the full forward's
    logits at each position (2e-3, as JAX's ``test_decode_matches_forward``),
    and a 4-token verify step from the prefill gives the same four; the
    cross caches are the prefill's and stay as they are."""
    cfg, _, pcfg, pp = _model(arch, latent)
    B, Tn, Lp = 2, 12, 8
    toks = _t(np.random.default_rng(9).integers(0, cfg.vocab_size, (B, Tn)))
    src = _t(_source(cfg, B))
    full = T.logits_for(pcfg, pp, T.forward_hidden(pcfg, pp, toks, src)[0])
    lg, cache = T.prefill(pcfg, pp, toks[:, :Lp], torch.full((B,), Lp), Tn + 4, source=src)
    np.testing.assert_allclose(_np(lg), _np(full[:, Lp - 1]), rtol=1e-3, atol=1e-3)
    cross = [{k: v.clone() for k, v in c["cross"].items()} for c in cache if "cross" in c]
    _, upd = T.verify_step(pcfg, pp, cache, toks[:, Lp:], torch.full((B,), Lp),
                           torch.ones((B, Tn - Lp), dtype=torch.bool))
    vlg, _ = T.verify_step(pcfg, pp, cache, toks[:, Lp:], torch.full((B,), Lp),
                           torch.ones((B, Tn - Lp), dtype=torch.bool))
    np.testing.assert_allclose(_np(vlg), _np(full[:, Lp:]), rtol=2e-3, atol=2e-3)
    for t in range(Lp, Tn):
        lg, cache = T.decode_step(pcfg, pp, cache, toks[:, t], torch.full((B,), t))
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), rtol=2e-3, atol=2e-3)
    T.commit_verify_writes(cache, upd, torch.full((B,), Lp),
                           torch.ones((B, Tn - Lp), dtype=torch.bool))
    assert all(torch.equal(a[k], c["cross"][k]) for a, c in
               zip(cross, [c for c in cache if "cross" in c]) for k in a)


def test_int8_ring_keeps_cross_cache_in_model_dtype():
    """Under ``cache_quant_bits=8`` the self rings hold int8 latents and the
    cross caches stay in the model dtype, as in the JAX package: prefill
    and decode logits and every cache leaf equal JAX's (1e-4; int8 leaves
    exactly)."""
    cfg, params, pcfg, pp = _model(VISION, latent=True)
    cfg = dataclasses.replace(cfg, cache_quant_bits=8)
    pcfg = dataclasses.replace(pcfg, cache_quant_bits=8)
    B = 2
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 7))
    src = _source(cfg, B)
    want, jc = J_PREFILL(cfg, params, jnp.asarray(toks, jnp.int32), jnp.full((B,), 7), 16,
                         jnp.asarray(src))
    got, pc = T.prefill(pcfg, pp, _t(toks), torch.full((B,), 7), 16, source=_t(src))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    nxt = np.asarray(jnp.argmax(want, -1))
    want, jc = J_DECODE(cfg, params, jc, jnp.asarray(nxt, jnp.int32), jnp.full((B,), 7))
    got, pc = T.decode_step(pcfg, pp, pc, _t(nxt), torch.full((B,), 7))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    assert {v.dtype for c in pc if "cross" in c for v in c["cross"].values()} == {
        torch.float32}
    assert pc[0]["self"]["zk_q"].dtype == torch.int8
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(caches_to_jax(pcfg, pc))):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        if a.dtype == np.int8:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, **FWD)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
@pytest.mark.parametrize("scan", [False, True])
def test_params_and_caches_round_trip(arch, scan):
    """``params_from_jax`` / ``params_to_jax`` and ``caches_from_jax`` /
    ``caches_to_jax`` carry ``encoder`` and ``cross`` leaves both ways, bit
    for bit, unrolled and scanned (stacked ``blocks``); the port's
    ``init_params`` draws JAX's leaves and shapes."""
    cfg, params, pcfg, pp = _model(arch, latent=scan, scan=scan)
    back = params_to_jax(pcfg, pp)
    jl = jax.tree_util.tree_leaves_with_path(params)
    bl = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [jax.tree_util.keystr(k) for k, _ in bl]
    for (_, a), (_, b) in zip(jl, bl):
        assert np.array_equal(np.asarray(a), b)
    mine = init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda a: (np.asarray(a).shape, np.asarray(a).dtype.name),
                          params_to_jax(pcfg, mine))
    assert shapes == jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    B = 2
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (B, 6))
    _, cache = J_PREFILL(cfg, params, jnp.asarray(toks, jnp.int32), jnp.full((B,), 6), 16,
                         jnp.asarray(_source(cfg, B)))
    cache = jax.tree.map(np.asarray, cache)
    got = caches_from_jax(pcfg, cache, device="cpu")
    assert [sorted(c) for c in got] == [
        ["cross"] if k == "cross" else ["cross", "self"] if k == "attn_cross" else ["self"]
        for k in pcfg.expanded_layers()]
    again = caches_to_jax(pcfg, got)
    assert jax.tree.structure(again) == jax.tree.structure(cache)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(again)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_calibration_and_compression_match_jax(arch):
    """``capture_calibration`` with a source (encoded for whisper) gives
    JAX's statistics, and ``compress_model`` on them JAX's params (self
    layers on their statistics, cross layers on identity statistics at the
    first self layer's rank) within 1e-4; through ``repro_torch.api`` the
    batches carry the source and ``quantized-latent`` quantizes the cross
    factors as JAX's does."""
    cfg, params, pcfg, pp = _model(arch)
    ccfg, cparams, jstats = _jax_compressed(arch)
    batches = _calib_batches(cfg)
    stats = C.capture_calibration(pcfg, pp, batches)
    assert len(stats) == len(jstats)
    for a, b in zip(stats, jstats):
        np.testing.assert_allclose(_np(a.cov), np.asarray(b.cov), rtol=1e-4, atol=1e-3)
        assert a.count == b.count
    rc = P.ReCalKVConfig(keep_ratio=0.5, group_size=2, use_fisher=False)
    pccfg, got = C.compress_model(pcfg, pp, stats, rc)
    assert pccfg.recalkv.ranks_by_layer == ccfg.recalkv.ranks_by_layer
    want = params_to_jax(pccfg, got)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(cparams),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    if arch == VISION:
        spec = dict(rank_policy=dict(keep_ratio=0.5, group_size=2),
                    options={"base": "grouped-svd", "bits": 4})
        jart = JA.compress(cfg, params, JA.CompressionSpec(
            "quantized-latent", options=spec["options"],
            rank_policy=JA.RankPolicy(**spec["rank_policy"])),
            [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
        part = A.compress(pcfg, pp, A.CompressionSpec(
            "quantized-latent", options=spec["options"],
            rank_policy=A.RankPolicy(**spec["rank_policy"])), A.calibrate(pcfg, pp, batches))
        x = 3   # the first cross layer
        for leaf in ("l_k", "r_k", "l_v"):
            np.testing.assert_allclose(
                _np(part.params["layers"][x]["cross"][leaf]),
                np.asarray(jart.params["prefix"][x]["cross"][leaf]), rtol=1e-4, atol=1e-4)


def test_cross_only_rank_fallback():
    """A model with cross layers only compresses them at the policy's rank
    for the group width (keep 0.1 of 32 rounds to 0; the floor lifts it to
    12), JAX's params within 1e-4; the runtime config carries that rank."""
    cfg = dataclasses.replace(get_config(VISION, smoke=True), name="cross-only",
                              num_layers=2, num_kv_heads=4, layer_pattern=("cross",),
                              cross_source_len=8, dtype=jnp.float32, scan_layers=False,
                              remat=False)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    rc = dict(keep_ratio=0.1, group_size=2, rank_multiple=8, min_rank=12, use_fisher=False)
    _, want = JC.compress_model(cfg, params, [], JP.ReCalKVConfig(**rc))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    ccfg, got = C.compress_model(pcfg, pp, [], P.ReCalKVConfig(**rc))
    assert got["layers"][0]["cross"]["l_k"].shape[-1] == 12
    assert (ccfg.recalkv.rank_k, ccfg.recalkv.rank_v) == (12, 12)
    for i in range(2):
        for k, v in want["prefix"][i]["cross"].items():
            np.testing.assert_allclose(_np(got["layers"][i]["cross"][k]), np.asarray(v),
                                       rtol=1e-4, atol=1e-4)


def _prompts(vocab):
    g = np.random.default_rng(11)
    return [g.integers(0, vocab, 3 + i).astype(np.int32) for i in range(6)]


def _serve(eng, prompts, port=True):
    """Odd uids sample, even ones are greedy; six requests on four slots."""
    R, SP = (Request, SamplingParams) if port else (JRequest, JSamplingParams)
    for i, p in enumerate(prompts):
        eng.submit(R(uid=i, prompt=p.copy(), max_new_tokens=6 + i % 3,
                     sampling=SP(**SAMPLED) if i % 2 else None))
    done = eng.run()
    eng.close()
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}, eng.metrics()


@functools.lru_cache(maxsize=None)
def _engine_model(arch, cache):
    """(JAX cfg, JAX params, port cfg, port params) per cache: dense, or
    compressed (JAX's ``compress_model`` for llama-vision; the latent
    config's random init for whisper)."""
    if cache == "dense" or arch == WHISPER:
        return _model(arch, latent=cache != "dense")
    ccfg, cparams, _ = _jax_compressed(arch)
    pcfg = ModelConfig.from_dict(ccfg.to_dict())
    return ccfg, cparams, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, cparams),
                                                device="cpu")


# A wave's row i reads source row i, so engines that form other waves give
# a request other source rows.  On a source of distinct rows a variant is
# held to the JAX engine with its own flags and inline admission (the same
# waves); on one row repeated, to the JAX sync engine, whatever the waves
# (threaded admission, staging, speculation).
VARIANTS = {"sync": {},
            "overlap": dict(overlap=True),
            "continuous": dict(overlap=True, continuous=True),
            "ngram2": dict(spec_depth=2, draft="ngram"),
            "continuous_inline": dict(overlap=True, continuous=True,
                                      admission_thread=False)}
DISTINCT_ROWS = ("sync", "continuous_inline")
CASES = ([(a, c, v) for a in (VISION, WHISPER) for c in ("dense", "compressed")
          for v in ("sync", "overlap", "continuous")]
         + [(VISION, c, "ngram2") for c in ("dense", "compressed")]
         + [(VISION, "dense", "continuous_inline")])


@pytest.mark.parametrize("arch,cache,variant", CASES)
def test_engine_streams_match_jax(arch, cache, variant):
    """The port's engine (kernel backend: plain versions on the CPU) serves
    six requests on four slots with an eight-row source, greedy and
    sampled, with the JAX engine's (einsum) streams token for token (see
    ``VARIANTS`` for which JAX run each variant is held to); continuous
    batching installs (as many times as JAX's on distinct rows)."""
    cfg, params, pcfg, pp = _engine_model(arch, cache)
    flags = VARIANTS[variant]
    distinct = variant in DISTINCT_ROWS
    src = _source(cfg, 8) if distinct else np.repeat(_source(cfg, 1), 8, axis=0)
    key = (arch, cache, variant if distinct else "repeated")
    if key not in _RUNS:
        _RUNS[key] = _serve(JEngine(cfg, params, source=jnp.asarray(src), **ENGINE,
                                    **(flags if distinct else {})),
                            _prompts(cfg.vocab_size), port=False)
    want, jm = _RUNS[key]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # see the warning test
        eng = Engine(dataclasses.replace(pcfg, attn_backend="kernel"), pp, source=src,
                     device="cpu", **ENGINE, **flags)
    got, m = _serve(eng, _prompts(cfg.vocab_size))
    assert got == want
    if flags.get("continuous"):
        assert m["slot_swaps"] > 0
        assert not distinct or m["slot_swaps"] == jm["slot_swaps"]
    if variant == "ngram2":
        assert m["draft_proposed"] > 0


def test_engine_refusals_and_warning():
    """The paged pool refuses cross layers with JAX's ValueError; the kernel
    backend warns once naming JAX's fallback kinds (the self layers keep
    their kernels); a cross model without a source, or with a source of
    the wrong width, raises; a prefill wave wider than the source raises."""
    for arch in (VISION, WHISPER):
        cfg, params, pcfg, pp = _model(arch)
        src = _source(cfg, 4)
        paged = dict(ENGINE, cache_layout="paged", page_size=8)
        with pytest.raises(ValueError) as want:
            JEngine(cfg, params, source=jnp.asarray(src), **paged)
        with pytest.raises(ValueError) as got:
            Engine(pcfg, pp, source=src, device="cpu", **paged)
        assert str(got.value) == str(want.value)
        kinds = JKC.pallas_fallback_kinds(cfg)
        assert kinds == KC.kernel_fallback_kinds(pcfg) == (
            ["cross"] if arch == VISION else ["attn_cross"])
        with pytest.warns(RuntimeWarning,
                          match=re.escape(f"backend='kernel': layer kinds {kinds}")):
            Engine(pcfg, pp, source=src, device="cpu", backend="kernel", **ENGINE).close()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            Engine(pcfg, pp, source=src, device="cpu", **ENGINE).close()
        for bad in (None, src[:, :, :8]):
            with pytest.raises(ValueError, match="cross-attention layers: pass source"):
                Engine(pcfg, pp, source=bad, device="cpu", **ENGINE)
        eng = Engine(pcfg, pp, source=src[:1], device="cpu", **ENGINE)
        with pytest.raises(ValueError, match="reads source rows 0..1"):
            _serve(eng, _prompts(cfg.vocab_size)[:2])


def test_serve_passes_the_source():
    """``api.serve`` of a compressed llama-vision artifact with ``source``
    gives the streams of the Engine built directly."""
    cfg, params, pcfg, pp = _model(VISION)
    batches = _calib_batches(cfg)
    art = A.compress(pcfg, pp, A.CompressionSpec(
        "recalkv", rank_policy=A.RankPolicy(keep_ratio=0.5, group_size=2)), batches)
    src = _source(cfg, 4)
    want, _ = _serve(Engine(art.cfg, art.params, source=src, device="cpu", **ENGINE),
                     _prompts(cfg.vocab_size))
    got, _ = _serve(A.serve(art, source=src, device="cpu", **ENGINE),
                    _prompts(cfg.vocab_size))
    assert got == want
