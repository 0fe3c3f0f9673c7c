"""The port's paged serving against the JAX package: ``Engine(cache_layout=
"paged")`` streams equal the JAX paged engine's and the port's ring
engine's (greedy, sampled, chunked, n-gram and layer-draft speculation,
the int8 pool); prefix-affinity's sharing counters, lazy preemption
counts and pinned prefixes match the JAX engine's too.

Float32 with TF32 off.  Streams and counters compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
SAMPLED = dict(temperature=0.9, top_k=32, top_p=0.9, seed=11)
MIXED_KW = dict(max_slots=2, max_len=40, sync_every=4, prefill_chunk=8)
COUNTERS = ("prefill_calls", "prefill_calls_saved", "pages_shared", "cow_forks",
            "prefix_resurrections", "preemptions", "pages_peak", "pages_pinned")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, bits in (("float", None), ("int8", 8)):
        cfg = dataclasses.replace(
            get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5), dtype=jnp.float32,
            cache_quant_bits=bits)
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
        pcfg = ModelConfig.from_dict(cfg.to_dict())
        out[name] = (cfg, params, pcfg,
                     params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return out


def _serve(eng, prompts, max_new=6, sampling=None, uid0=0):
    port = isinstance(eng, Engine)
    R = Request if port else JRequest
    sp = None
    if sampling is not None:
        sp = SamplingParams(**sampling) if port else JSamplingParams(**sampling)
    for i, pr in enumerate(prompts):
        eng.submit(R(uid=uid0 + i, prompt=pr.copy(), max_new_tokens=max_new, sampling=sp))
    done = eng.run()
    assert not eng.scheduler.has_work
    return {r.uid: [int(t) for t in r.out_tokens] for r in done
            if r.uid >= uid0}


def _both(models, model, kw, prompts, **serve_kw):
    """(JAX streams, port streams, JAX metrics, port metrics) for one
    engine configuration; ``kw["backend"]`` "kernel" is JAX's "pallas"."""
    cfg, params, pcfg, pp = models[model]
    jkw = dict(kw)
    if jkw.get("backend") == "kernel":
        jkw["backend"] = "pallas"
    jeng = JEngine(cfg, params, **jkw)
    peng = Engine(pcfg, pp, device="cpu", **kw)
    want = _serve(jeng, prompts, **serve_kw)
    got = _serve(peng, prompts, **serve_kw)
    return want, got, jeng.metrics(), peng.metrics()


def _mixed(vocab):
    g = np.random.default_rng(3)
    return [g.integers(0, vocab, n).astype(np.int32) for n in (5, 19, 7, 12, 3)]


STREAM_CASES = {
    # name: (model, engine keywords, sampled)
    "greedy_einsum": ("float", dict(backend="einsum"), False),
    "greedy_kernel": ("float", dict(backend="kernel"), False),
    "sampled_kernel": ("float", dict(backend="kernel"), True),
    "ngram_kernel": ("float", dict(backend="kernel", spec_depth=3, draft="ngram"), False),
    "layer_draft_kernel": ("float", dict(backend="kernel", spec_depth=2,
                                         draft="layers:1"), False),
    "int8_kernel": ("int8", dict(backend="kernel"), False),
    "int8_ngram_einsum": ("int8", dict(backend="einsum", spec_depth=3), False),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_paged_streams_match_jax_and_ring(models, case):
    """Five requests on two slots, two of them chunked (prefill_chunk 8),
    page_size 4 (10 slot pages): the port's paged streams equal the JAX
    paged engine's and the port's own ring engine's."""
    model, kw, sampled = STREAM_CASES[case]
    _, _, pcfg, pp = models[model]
    prompts = _mixed(pcfg.vocab_size)
    sampling = SAMPLED if sampled else None
    kw = dict(MIXED_KW, cache_layout="paged", page_size=4, **kw)
    want, got, _, m = _both(models, model, kw, prompts, sampling=sampling)
    assert got == want
    ring_kw = {k: v for k, v in kw.items() if k not in ("cache_layout", "page_size")}
    ring = Engine(pcfg, pp, device="cpu", **ring_kw)
    assert _serve(ring, prompts, sampling=sampling) == got
    assert m["cache_layout"] == "paged" and m["page_size"] == 4
    assert m["pages_free"] == m["pages_total"] - 1      # every page returned


def _shared_load(vocab, n=8, sys_len=16, seed=5):
    g = np.random.default_rng(seed)
    sysp = g.integers(0, vocab, sys_len).astype(np.int32)
    return [np.concatenate([sysp, g.integers(0, vocab, 3).astype(np.int32)])
            for _ in range(n)]


@pytest.mark.parametrize("policy", ["prefix-affinity", "fifo"])
def test_prefix_sharing_counters_match_jax(models, policy):
    """Eight sharers of a 16-token system prompt through four slots (two
    waves): prefill calls, skipped prefills, shares, forks and
    resurrections equal the JAX engine's, and so do the streams."""
    _, _, pcfg, _ = models["float"]
    kw = dict(max_slots=4, max_len=40, cache_layout="paged", page_size=4,
              n_pages=65, policy=policy, backend="kernel")
    want, got, jm, pm = _both(models, "float", kw, _shared_load(pcfg.vocab_size))
    assert got == want
    assert {k: pm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert pm["pages_shared"] > 0 and pm["cow_forks"] > 0
    if policy == "prefix-affinity":
        assert pm["prefill_calls_saved"] >= 1


@pytest.mark.parametrize("sampled", [False, True])
def test_lazy_preemption_matches_jax(models, sampled):
    """A 13-page pool against reaches of 23-33 tokens (page_size 4) runs
    dry mid-decode: the port preempts as often as the JAX engine, and the
    streams equal an ample pool's, which never preempts."""
    _, _, pcfg, pp = models["float"]
    g = np.random.default_rng(5)
    prompts = [g.integers(0, pcfg.vocab_size, 7 + 2 * i).astype(np.int32)
               for i in range(6)]
    sampling = SAMPLED if sampled else None
    tiny = dict(max_slots=4, max_len=40, sync_every=2, cache_layout="paged",
                page_size=4, n_pages=13, lazy_pages=True)
    want, got, jm, pm = _both(models, "float", tiny, prompts, max_new=16,
                              sampling=sampling)
    assert pm["preemptions"] > 0
    assert {k: pm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert got == want
    ample = Engine(pcfg, pp, device="cpu", **dict(tiny, n_pages=65))
    assert _serve(ample, prompts, max_new=16, sampling=sampling) == got
    assert ample.metrics()["preemptions"] == 0
    assert pm["pages_free"] + pm["pages_parked"] == pm["pages_total"] - 1


def test_pinned_prefixes_survive_churn_like_jax(models):
    """pin_prefixes=2 keeps a 16-token system prompt's two pages parked
    through a flood of disjoint prompts, so later sharers resurrect them;
    every counter equals the JAX engine's at each stage."""
    cfg, params, pcfg, pp = models["float"]
    g = np.random.default_rng(11)
    sysp = g.integers(0, pcfg.vocab_size, 16).astype(np.int32)
    shared = lambda n: [np.concatenate([sysp, g.integers(0, pcfg.vocab_size, 3)])
                        .astype(np.int32) for _ in range(n)]
    stages = [shared(2), [g.integers(0, pcfg.vocab_size, 20).astype(np.int32)
                          for _ in range(8)], shared(2)]
    kw = dict(max_slots=4, max_len=48, cache_layout="paged", page_size=8,
              pin_prefixes=2)
    jeng = JEngine(cfg, params, **kw)
    peng = Engine(pcfg, pp, device="cpu", **kw)
    for k, prompts in enumerate(stages):
        want = _serve(jeng, prompts, max_new=4, uid0=100 * k)
        assert _serve(peng, prompts, max_new=4, uid0=100 * k) == want
        jm, pm = jeng.metrics(), peng.metrics()
        assert {c: pm[c] for c in COUNTERS} == {c: jm[c] for c in COUNTERS}, k
    assert pm["pages_pinned"] == 2 and pm["prefix_resurrections"] > 0
