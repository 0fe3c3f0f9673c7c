"""Continuous batching in the port (``Engine(overlap=True,
continuous=True)``: a device staging queue and an in-window install)
against the JAX package.

The install function (``Engine._stage_install``) and
``transformer.swap_cache_slot`` are held to JAX's ``Engine._stage_install``
and ``swap_cache_slot`` exactly, on numpy-seeded carries, keys and caches.
Per model case the JAX engine serves the prompts once with
``continuous=True`` and the same flags; every port variant of that case
must equal its streams token for token, and so must the port's sync
engine: pipeline depth 2 and 3, the dense and int8 caches, the paged pool
with and without n-gram speculation, chunked prompts of mixed lengths and
budgets, inline and threaded admission, a saturating sampled load,
``adaptive_spec``, and ``aot`` on the CPU.  JAX's own tests hold its
continuous streams to its sync engine's, so one JAX run per case is the
reference for the variants.  Also the refusals, ``staging_depth`` and
the sync contract ``host_syncs == windows + admission_syncs``.

Float32 with TF32 off; smoke ``qwen3-4b``; streams compared exactly.
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
from repro.serving.engine import STAGE_FREE as J_STAGE_FREE
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import caches_from_jax, params_from_jax
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.engine import STAGE_FREE

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
CASES = {"dense": {}, "latent": {"recalkv_ratio": 0.5},
         "int8_latent": {"recalkv_ratio": 0.5, "cache_quant_bits": 8}}
SAMPLED = dict(temperature=0.9, top_k=32, top_p=0.9, seed=11)
KW = dict(max_slots=4, max_len=40)
CHUNKED = dict(max_slots=4, max_len=40, prefill_chunk=6, sync_every=4)
CONT = dict(overlap=True, continuous=True, pipeline_depth=3)
_MODELS, _REFS = {}, {}


def _model(case):
    """(JAX cfg, JAX params, port cfg, port params), once per case."""
    if case not in _MODELS:
        extra = CASES[case]
        cfg = get_config("qwen3-4b", smoke=True,
                         **{k: v for k, v in extra.items() if k == "recalkv_ratio"})
        cfg = dataclasses.replace(cfg, dtype=jnp.float32,
                                  cache_quant_bits=extra.get("cache_quant_bits"))
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
        pcfg = ModelConfig.from_dict(cfg.to_dict())
        _MODELS[case] = (cfg, params, pcfg,
                         params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                         device="cpu"))
    return _MODELS[case]


def _prompts(vocab, n=6, seed=3):
    g = np.random.default_rng(seed)
    return [g.integers(0, vocab, 5 + 2 * i).astype(np.int32) for i in range(n)]


def _serve(eng, prompts, max_new=6, sampled=()):
    """Submit, run, close; the streams by uid.  ``max_new`` is one budget
    or one per prompt; ``sampled`` holds the uids that sample."""
    port = isinstance(eng, Engine)
    R = Request if port else JRequest
    sp = SamplingParams(**SAMPLED) if port else JSamplingParams(**SAMPLED)
    news = [max_new] * len(prompts) if isinstance(max_new, int) else max_new
    for i, (pr, n) in enumerate(zip(prompts, news)):
        eng.submit(R(uid=i, prompt=pr.copy(), max_new_tokens=n,
                     sampling=sp if i in sampled else None))
    done = eng.run()
    eng.close()
    assert not eng.scheduler.has_work
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}


def _port(case, prompts=None, max_new=6, sampled=(), kw=KW, **flags):
    _, _, pcfg, pparams = _model(case)
    eng = Engine(pcfg, pparams, device="cpu", **kw, **flags)
    prompts = _prompts(pcfg.vocab_size) if prompts is None else prompts
    return _serve(eng, prompts, max_new, sampled), eng


def _jax(key, case, prompts=None, max_new=6, sampled=(), kw=KW, **flags):
    """One JAX run per ``key``, shared by every test that names it."""
    if key not in _REFS:
        cfg, params, _, _ = _model(case)
        prompts = _prompts(cfg.vocab_size) if prompts is None else prompts
        eng = JEngine(cfg, params, **kw, **flags)
        _REFS[key] = (_serve(eng, prompts, max_new, sampled), eng.metrics())
    return _REFS[key]


def _sync_contract(m):
    assert m["host_syncs"] == m["windows"] + m["admission_syncs"], m


# -- the install function --------------------------------------------------------

B, L_MAX = 4, 16
# (act, seq) per case: a full batch; an empty stage; one free slot; several
# free slots; a free slot whose stage head is one row past a cleared one
INSTALL_CASES = {
    "full batch": ([1, 1, 1, 1], [4, 2, None, 7]),
    "empty stage": ([1, 0, 0, 1], [None] * 4),
    "one free slot": ([1, 0, 1, 1], [None, 5, 3, None]),
    "several free": ([0, 1, 0, 0], [7, 2, 9, None]),
    "cleared row": ([0, 1, 1, 0], [None, 6, None, 4]),
}


def _carry(g, act):
    """A numpy-seeded carry of B rows: the leaves' kinds and widths the
    engine carries (int, bool, a key pair, float, a buffer, gen)."""
    return {"tok": g.integers(0, 100, B), "cur": g.integers(0, L_MAX, B),
            "act": np.asarray(act, bool), "keys": g.integers(0, 2 ** 31, (B, 2)),
            "temp": g.random(B).astype(np.float32), "buf": g.integers(0, 100, (B, 3)),
            "more": g.random(B) < 0.5, "gen": g.integers(0, 5, B)}


def _random_cache(g, cfg):
    """JAX's cache tree for ``cfg`` at B rows, every leaf numpy-random."""
    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return g.integers(-127, 128, a.shape).astype(np.int8)
        if np.issubdtype(a.dtype, np.integer):
            return g.integers(-1, L_MAX, a.shape).astype(a.dtype)
        return g.standard_normal(a.shape).astype(a.dtype)
    return jax.tree.map(fill, JT.init_decode_cache(cfg, B, L_MAX))


def _np(x):
    """A leaf as numpy, integers and flags widened to int64 (the packages
    keep tokens, keys and counts at different widths)."""
    x = np.asarray(x)
    return x if x.dtype.kind == "f" else x.astype(np.int64)


def _jax_carry(c):
    return {k: jnp.asarray(v.astype(np.uint32) if k == "keys"
                           else v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in c.items()}


def _torch_carry(c):
    return {k: torch.from_numpy(v.astype(np.int32) if k == "gen" else v.copy())
            for k, v in c.items()}


@pytest.mark.parametrize("case", ["latent", "int8_latent", "dense"])
def test_stage_install_matches_jax(case):
    """The port's install equals JAX's ``Engine._stage_install`` exactly on
    every leaf of the carry, the ring cache (the stage cache's row copied
    into the slot, or nothing), the cleared key and the (sw_seq, sw_slot)
    outputs; each case installs twice in a row, so the second sees the
    first's cleared key and filled slot."""
    cfg, _, pcfg, _ = _model(case)
    for name, (act, keys) in INSTALL_CASES.items():
        g = np.random.default_rng(len(name))
        st, rows = _carry(g, act), _carry(g, g.random(B) < 0.5)
        seq = np.array([STAGE_FREE if k is None else k for k in keys], np.int32)
        cache, scache = _random_cache(g, cfg), _random_cache(g, cfg)
        jst, jcache, jseq = _jax_carry(st), jax.tree.map(jnp.asarray, cache), jnp.asarray(seq)
        jstage = {"rows": _jax_carry(rows), "cache": jax.tree.map(jnp.asarray, scache)}
        pst = _torch_carry(st)
        pcache = caches_from_jax(pcfg, cache, device="cpu")
        pstage = {"seq": torch.from_numpy(seq.copy()), "rows": _torch_carry(rows),
                  "cache": caches_from_jax(pcfg, scache, device="cpu")}
        for step in range(2):
            jst, jcache, jseq, jsw_seq, jsw_slot = JEngine._stage_install(
                jst, jcache, jseq, jstage)
            pst, sw = Engine._stage_install(pst, pcache, pstage)
            where = f"{case}, {name}, install {step}"
            for k in st:
                np.testing.assert_array_equal(_np(pst[k]), _np(jst[k]),
                                              err_msg=f"{where}: {k}")
            np.testing.assert_array_equal(pstage["seq"].numpy(), np.asarray(jseq), err_msg=where)
            assert int(sw["sw_seq"]) == int(jsw_seq), where
            assert int(sw["sw_slot"]) == int(jsw_slot), where
            want = caches_from_jax(pcfg, jax.tree.map(np.asarray, jcache), device="cpu")
            for lw, lg in zip(want, pcache):
                for leaf in lw["self"]:
                    torch.testing.assert_close(lg["self"][leaf], lw["self"][leaf],
                                               rtol=0, atol=0, msg=f"{where}: {leaf}")
    assert J_STAGE_FREE == STAGE_FREE


@pytest.mark.parametrize("slot", [0, 2, B])
def test_swap_cache_slot_matches_jax(slot):
    """``swap_cache_slot`` on the float and int8 latent rings and the dense
    ring equals JAX's: stage row 1 lands in ``slot``; a slot past the batch
    copies nothing (JAX's ``mode="drop"``)."""
    for case in ("latent", "int8_latent", "dense"):
        cfg, _, pcfg, _ = _model(case)
        g = np.random.default_rng(slot)
        cache, scache = _random_cache(g, cfg), _random_cache(g, cfg)
        want = JT.swap_cache_slot(jax.tree.map(jnp.asarray, cache),
                                  jax.tree.map(jnp.asarray, scache),
                                  jnp.int32(slot), jnp.int32(1))
        got = caches_from_jax(pcfg, cache, device="cpu")
        T.swap_cache_slot(got, caches_from_jax(pcfg, scache, device="cpu"),
                          torch.tensor(slot), torch.tensor(1))
        want = caches_from_jax(pcfg, jax.tree.map(np.asarray, want), device="cpu")
        for lw, lg in zip(want, got):
            for leaf in lw["self"]:
                torch.testing.assert_close(lg["self"][leaf], lw["self"][leaf],
                                           rtol=0, atol=0, msg=f"{case} {leaf}")


def test_install_table_is_for_cuda_leaves():
    """On the CPU the install runs its plain version and needs no table:
    ``install_table`` is None there, and a table over CPU leaves is
    refused."""
    from repro_torch.kernels.stage_install import InstallTable
    _, _, pcfg, _ = _model("latent")
    g = np.random.default_rng(5)
    cache = caches_from_jax(pcfg, _random_cache(g, _model("latent")[0]), device="cpu")
    assert T.install_table(cache, cache) is None
    leaves = [leaf for c in cache for leaf in c["self"].values()]
    with pytest.raises(ValueError, match="CUDA leaves"):
        InstallTable(leaves, leaves)


# -- engine streams ---------------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 3])
def test_continuous_streams_match_jax_and_sync(depth):
    """Greedy, ring: the continuous engine at pipeline depth 2 and 3 equals
    the JAX continuous engine and the port's sync engine; every request is
    installed inside a window."""
    want, jm = _jax("latent", "latent", **CONT)
    sync, _ = _port("latent")
    got, eng = _port("latent", overlap=True, continuous=True, pipeline_depth=depth)
    assert sync == want
    assert got == want
    m = eng.metrics()
    assert m["continuous"] is True and m["pipeline_depth"] == depth
    assert m["slot_swaps"] == len(want) and jm["slot_swaps"] == len(want)
    _sync_contract(m)


@pytest.mark.parametrize("case", ["dense", "int8_latent"])
def test_continuous_variants_match_jax(case):
    """The dense and the int8 latent caches: the install copies their
    leaves (k / v / pos, latents + scales / pos)."""
    want, _ = _jax(case, case, **CONT)
    got, eng = _port(case, **CONT)
    assert got == want
    assert eng.metrics()["slot_swaps"] > 0


@pytest.mark.parametrize("spec_depth", [0, 2])
def test_paged_continuous_matches_jax(spec_depth):
    """The paged pool, with n-gram speculation at depth 2: a staged request's
    pages are scattered at stage time and the install copies its table
    row; streams equal the JAX continuous engine's, and the pages all come
    back."""
    want, _ = _jax("latent", "latent", **CONT)
    got, eng = _port("latent", cache_layout="paged", spec_depth=spec_depth,
                     draft="ngram" if spec_depth else None, **CONT)
    assert got == want
    m = eng.metrics()
    assert m["slot_swaps"] > 0
    assert m["pages_free"] + m["pages_parked"] == m["pages_total"] - 1
    if spec_depth:
        assert m["draft_proposed"] > 0
    _sync_contract(m)


def test_chunked_mixed_lengths_match_jax():
    """Chunked prefill with staggered budgets: slots free and refill
    mid-window while other slots still ingest prompt chunks (gen-guarded
    refills)."""
    g = np.random.default_rng(23)
    vocab = _model("latent")[2].vocab_size
    prompts = [g.integers(0, vocab, int(g.integers(3, 30))).astype(np.int32)
               for _ in range(8)]
    news = [4 + i % 5 for i in range(8)]
    want, _ = _jax("chunked", "latent", prompts, news, kw=CHUNKED, **CONT)
    sync, _ = _port("latent", prompts, news, kw=CHUNKED)
    got, eng = _port("latent", prompts, news, kw=CHUNKED, **CONT)
    assert sync == want
    assert got == want
    assert eng.metrics()["slot_swaps"] > 0


def test_inline_admission_matches_threaded_and_jax():
    """Staging on the dispatch loop or on the admission thread: the same
    streams; inline, the schedule is deterministic and equals the JAX
    engine's install for install and window for window."""
    prompts = _prompts(_model("latent")[2].vocab_size, n=8)
    want, jm = _jax("inline", "latent", prompts, admission_thread=False, **CONT)
    got_t, et = _port("latent", prompts, **CONT)
    got_i, ei = _port("latent", prompts, admission_thread=False, **CONT)
    assert got_t == want and got_i == want
    mi = ei.metrics()
    assert et.metrics()["admission_thread"] is True and mi["admission_thread"] is False
    for k in ("slot_swaps", "windows", "admission_syncs", "tokens"):
        assert mi[k] == jm[k], (k, mi[k], jm[k])
    for eng in (et, ei):
        _sync_contract(eng.metrics())


def test_saturating_sampled_load_swaps_in_window():
    """More requests than slots, every one sampled: the installs ride the
    staging queue and the sampled streams (bit-exact threefry) equal the
    JAX continuous engine's."""
    prompts = _prompts(_model("latent")[2].vocab_size, n=10)
    uids = set(range(10))
    want, _ = _jax("sampled", "latent", prompts, sampled=uids, **CONT)
    got, eng = _port("latent", prompts, sampled=uids, **CONT)
    assert got == want
    m = eng.metrics()
    assert m["slot_swaps"] > 0 and m["occupancy_device_mean"] > 0.0
    _sync_contract(m)


def test_adaptive_spec_continuous_matches_jax():
    """``adaptive_spec`` with n-gram speculation under continuous batching
    (an installed slot's counts are skipped at its harvest): streams and
    ``spec_degraded`` equal the JAX engine's, and plain decoding's."""
    prompts = _prompts(_model("latent")[2].vocab_size, n=8)
    flags = dict(spec_depth=2, draft="ngram", adaptive_spec=True,
                 admission_thread=False, **CONT)
    want, jm = _jax("adaptive", "latent", prompts, max_new=12, **flags)
    plain, _ = _port("latent", prompts, max_new=12)
    got, eng = _port("latent", prompts, max_new=12, **flags)
    assert got == want == plain
    assert eng.metrics()["spec_degraded"] == jm["spec_degraded"]


def test_aot_continuous_on_cpu():
    """``aot=True`` with continuous batching at depth 3 on the CPU captures
    nothing and serves the eager continuous window."""
    want, _ = _jax("latent", "latent", **CONT)
    got, eng = _port("latent", aot=True, **CONT)
    m = eng.metrics()
    assert got == want
    assert m["captures"] == 0 and m["slot_swaps"] > 0


@pytest.mark.parametrize("depth", [None, 1, 3])
def test_staging_depth_bounds_lookahead(depth):
    """``staging_depth`` (default 2 x max_slots) bounds the requests taken
    off the queue ahead of a slot, is reported, and leaves the streams as
    they were; it sizes the prefill wave's row bucket too."""
    want, _ = _jax("latent", "latent", **CONT)
    got, eng = _port("latent", staging_depth=depth, **CONT)
    m = eng.metrics()
    assert got == want
    assert m["staging_depth"] == eng.staging_depth == (depth or 2 * KW["max_slots"])
    sync, seng = _port("latent", staging_depth=depth, overlap=True)
    assert sync == want and seng.metrics()["staging_depth"] == m["staging_depth"]


def test_refusals():
    """The JAX constructor's refusals, with its messages."""
    _, _, pcfg, pparams = _model("latent")
    mk = lambda **kw: Engine(pcfg, pparams, max_slots=2, max_len=40, device="cpu", **kw)
    with pytest.raises(ValueError, match="requires overlap=True"):
        mk(continuous=True)
    with pytest.raises(ValueError, match="layer-fraction draft"):
        mk(overlap=True, continuous=True, spec_depth=2, draft="layers:2")
    with pytest.raises(ValueError, match="lazy_pages is incompatible with continuous"):
        mk(overlap=True, continuous=True, cache_layout="paged", lazy_pages=True)
    with pytest.raises(ValueError, match="staging_depth must be >= 1"):
        mk(overlap=True, staging_depth=0)
    m = mk(overlap=True).metrics()
    assert m["continuous"] is False and m["slot_swaps"] == 0 and m["staging_depth"] == 4
