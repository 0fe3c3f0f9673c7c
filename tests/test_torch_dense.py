"""The port's dense (uncompressed) KV cache against the JAX package:
``self_attention_dense``, ``decode_attn_dense`` and ``verify_attn_dense``
on rings and pools through both backends (the Pallas kernels in interpret
mode); the dense cores ``ops.dense_decode*`` (K1 / K4 / K5 / K7 at an
identity R_k); Engine streams at ``recalkv=None``; ``params_to_jax``;
and the config dict each package writes, read by the other.

Float32 with TF32 off.  Tolerances: module outputs atol = rtol = 1e-5
(f32 summation order differs), logits atol 1e-4, streams token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.models import kv_cache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch import kernels
from repro_torch.configs import get_config as pt_get_config
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import (caches_from_jax, init_params,
                                        params_from_jax, params_to_jax)
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=0)
PS = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _jcfg(backend="einsum", scan=True):
    return dataclasses.replace(get_config("qwen3-4b", smoke=True), dtype=jnp.float32,
                               attn_backend=backend, scan_layers=scan)


def _bumped(params, seed):
    rng = np.random.default_rng(seed)

    def bump(path, x):
        if getattr(path[-1], "key", "") in ("q_norm", "k_norm", "ln1", "ln2", "final_norm"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(bump, params)


@pytest.fixture(scope="module")
def model():
    cfg = _jcfg()
    params = _bumped(JT.init_params(cfg, jax.random.PRNGKey(2)), 2)
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return cfg, params, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                              device="cpu")


# -- config and params bridges ---------------------------------------------------


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
@pytest.mark.parametrize("ratio", [None, 0.5])
def test_config_dicts_load_in_both_packages(backend, ratio):
    """The port writes JAX's values ("pallas" for the kernel backend):
    JAX's ``from_dict`` reads the port's dict, and back."""
    jcfg = dataclasses.replace(get_config("qwen3-4b", recalkv_ratio=ratio),
                               attn_backend=backend)
    pcfg = ModelConfig.from_dict(jcfg.to_dict())
    assert pcfg.attn_backend == ("kernel" if backend == "pallas" else "einsum")
    assert JModelConfig.from_dict(pcfg.to_dict()) == jcfg
    assert pcfg.to_dict() == jcfg.to_dict()
    assert ModelConfig.from_dict(pcfg.to_dict()) == pcfg
    assert pt_get_config("qwen3-4b", recalkv_ratio=ratio).to_dict() == \
        get_config("qwen3-4b", recalkv_ratio=ratio).to_dict()


def test_params_to_jax_inverts_params_from_jax():
    """An unrolled JAX tree survives the round trip leaf for leaf."""
    cfg = _jcfg(scan=False)
    tree = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(4)))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    back = params_to_jax(pcfg, params_from_jax(pcfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_params_dense_leaves_match_jax():
    """The port's random dense model has JAX's leaves, shapes and scales."""
    cfg = _jcfg(scan=False)
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    want = params_to_jax(pcfg, params_from_jax(
        pcfg, jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0))),
        device="cpu"))
    got = params_to_jax(pcfg, init_params(pcfg, torch.Generator().manual_seed(0),
                                          device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.25, atol=1e-6,
                                   err_msg=str(path))


# -- attention modules -----------------------------------------------------------


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_self_attention_dense_matches_jax(model, backend):
    cfg, params, pcfg, pp = model
    jb = "pallas" if backend == "kernel" else "einsum"
    jc, pc = dataclasses.replace(cfg, attn_backend=jb), dataclasses.replace(
        pcfg, attn_backend=backend)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    jp = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
    y, (k, v) = JL.self_attention_dense(jp, jnp.asarray(x), jc, jnp.asarray(pos), None)
    gy, (gk, gv) = L.self_attention_dense(pp["layers"][0]["attn"], _t(x), pc, _t(pos),
                                          None)
    for g, w in ((gy, y), (gk, k), (gv, v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _ring(cfg, seed):
    """A dense ring: row 0 holds positions 0..12, row 1 a wrapped ring
    (positions 20..39), row 2 nothing.  Returns (cache leaves, cur)."""
    rng = np.random.default_rng(seed)
    B, Lr, Hkv, dh = 3, 20, cfg.num_kv_heads, cfg.d_head
    pos = np.full((B, Lr), -1, np.int32)
    pos[0, :13] = np.arange(13)
    pos[1] = 20 + (np.arange(Lr) - 20) % Lr
    cache = {"k": rng.standard_normal((B, Lr, Hkv, dh)).astype(np.float32),
             "v": rng.standard_normal((B, Lr, Hkv, dh)).astype(np.float32),
             "pos": pos}
    return cache, np.array([13, 40, 0])


def _pool(cache):
    """The ring's 5 slot pages per row at shuffled physical pages; pages
    without a valid position stay on the null page 0."""
    B, Lr = cache["pos"].shape
    n_sp = Lr // PS
    ptab = np.zeros((B, n_sp), np.int32)
    order = iter(np.random.default_rng(9).permutation(np.arange(1, B * n_sp + 1)))
    pool = {k: np.zeros((B * n_sp + 1, PS) + v.shape[2:], v.dtype)
            for k, v in cache.items()}
    pool["pos"][:] = -1
    for b in range(B):
        for j in range(n_sp):
            if (cache["pos"][b, j * PS:(j + 1) * PS] >= 0).any():
                ptab[b, j] = next(order)
                for k in pool:
                    pool[k][ptab[b, j]] = cache[k][b, j * PS:(j + 1) * PS]
    return pool, ptab


READER_CASES = [(layout, backend) for layout in ("ring", "pool")
                for backend in ("einsum", "kernel")]


@pytest.mark.parametrize("layout,backend", READER_CASES)
def test_decode_and_verify_attn_dense_match_jax(model, layout, backend):
    """``decode_attn_dense`` and ``verify_attn_dense`` (S = 3, one row's
    last column not fed) on a ragged ring or pool: outputs and deferred
    entries."""
    cfg, params, pcfg, pp = model
    jc = dataclasses.replace(cfg, attn_backend="pallas" if backend == "kernel" else "einsum")
    pc = dataclasses.replace(pcfg, attn_backend=backend)
    cache, cur = _ring(cfg, 3)
    jpages = pages = None
    if layout == "pool":
        cache, ptab = _pool(cache)
        jpages, pages = (jnp.asarray(ptab), PS), (_t(ptab), PS)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    pcache = {k: _t(v).long() if k == "pos" else _t(v) for k, v in cache.items()}
    jp = jax.tree.map(lambda a: a[1], params["blocks"][0]["attn"])
    p = pp["layers"][1]["attn"]
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    want = JKC.decode_attn_dense(jp, jnp.asarray(x1), jcache, jc,
                                 jnp.asarray(cur, jnp.int32), None, pages=jpages)
    got = KC.decode_attn_dense(p, _t(x1), pcache, pc, _t(cur), None, pages=pages)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]), **TOL)
    x3 = rng.standard_normal((3, 3, cfg.d_model)).astype(np.float32)
    feed = np.array([[True, True, True], [True, True, False], [True, True, True]])
    want = JKC.verify_attn_dense(jp, jnp.asarray(x3), jcache, jc,
                                 jnp.asarray(cur, jnp.int32), jnp.asarray(feed), None,
                                 pages=jpages)
    got = KC.verify_attn_dense(p, _t(x3), pcache, pc, _t(cur), _t(feed), None,
                               pages=pages)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]), **TOL)


@pytest.mark.parametrize("layout", ["ring", "pool"])
def test_dense_cores_match_jax_kernels(model, layout):
    """``ops.dense_decode*`` (the plain versions of K1 / K4 / K5 / K7 at an
    identity R_k and identity tables) against ``repro.kernels.ops.
    dense_decode*`` with the Pallas kernels in interpret mode."""
    cfg = model[0]
    cache, cur = _ring(cfg, 7)
    rng = np.random.default_rng(8)
    B, H, Hkv, dh = 3, cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    qm = rng.standard_normal((B, 3, H, dh)).astype(np.float32)
    one = {k: rng.standard_normal((B, Hkv, dh)).astype(np.float32) for k in ("k", "v")}
    many = {k: rng.standard_normal((B, 3, Hkv, dh)).astype(np.float32) for k in ("k", "v")}
    feed = np.array([[True, True, False], [True, True, True], [True, False, False]])
    kw = dict(window=None, scale=dh ** -0.5)
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    p = lambda d: {k: _t(v).long() if k == "pos" else _t(v) for k, v in d.items()}
    jcur = jnp.asarray(cur, jnp.int32)
    if layout == "ring":
        want1 = jops.dense_decode(jnp.asarray(q), j(cache), jcur, self_entry=j(one),
                                  interpret=True, block_s=8, **kw)
        got1 = ops.dense_decode(_t(q), p(cache), _t(cur), self_entry=p(one), **kw)
        wantm = jops.dense_decode_mq(jnp.asarray(qm), j(cache), jcur, jnp.asarray(feed),
                                     j(many), interpret=True, block_s=8, **kw)
        gotm = ops.dense_decode_mq(_t(qm), p(cache), _t(cur), _t(feed), p(many), **kw)
    else:
        pool, ptab = _pool(cache)
        want1 = jops.dense_decode_paged(jnp.asarray(q), j(pool), jnp.asarray(ptab), jcur,
                                        self_entry=j(one), interpret=True, **kw)
        got1 = ops.dense_decode_paged(_t(q), p(pool), _t(ptab), _t(cur),
                                      self_entry=p(one), **kw)
        wantm = jops.dense_decode_mq_paged(jnp.asarray(qm), j(pool), jnp.asarray(ptab),
                                           jcur, jnp.asarray(feed), j(many),
                                           interpret=True, **kw)
        gotm = ops.dense_decode_mq_paged(_t(qm), p(pool), _t(ptab), _t(cur), _t(feed),
                                         p(many), **kw)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)
    np.testing.assert_allclose(gotm.numpy(), np.asarray(wantm), **TOL)


def test_dense_core_launches_count_by_route():
    """On the CPU the wrappers run their plain versions and count nothing:
    the dense decode kernels (``ops.dense_decode*``), the dense verify
    kernels (``ops.dense_decode_mq*``), and K1, K4, K5 and K7, which no
    dense core rides any more."""
    kernels.reset_launch_counts()
    assert all(k.launches == 0 for k in kernels.KERNELS)
    cache, cur = _ring(_jcfg(), 7)
    cache = {k: _t(v).long() if k == "pos" else _t(v) for k, v in cache.items()}
    pool, ptab = _pool({k: v.numpy() for k, v in cache.items()})
    pool = {k: _t(v).long() if k == "pos" else _t(v) for k, v in pool.items()}
    ops.dense_decode(torch.zeros(3, 4, 16), cache, _t(cur), window=None, scale=0.25)
    ops.dense_decode_paged(torch.zeros(3, 4, 16), pool, _t(ptab), _t(cur), window=None,
                           scale=0.25)
    entries = {"k": torch.zeros(3, 2, 2, 16), "v": torch.zeros(3, 2, 2, 16)}
    feed = torch.ones(3, 2, dtype=torch.bool)
    ops.dense_decode_mq(torch.zeros(3, 2, 4, 16), cache, _t(cur), feed, entries,
                        window=None, scale=0.25)
    ops.dense_decode_mq_paged(torch.zeros(3, 2, 4, 16), pool, _t(ptab), _t(cur), feed,
                              entries, window=None, scale=0.25)
    assert all(k.launches == 0 for k in kernels.KERNELS)
    assert not any(hasattr(k, "launches_by_route") for k in kernels.KERNELS)


# -- model steps and Engine streams ----------------------------------------------


def _stacked_layers(tree):
    """Per-layer leaf dicts of a JAX cache tree with one stacked block."""
    leaves = tree["blocks"][0]["self"]
    n = np.asarray(leaves["pos"]).shape[0]
    return [{k: np.asarray(v)[i] for k, v in leaves.items()} for i in range(n)]


@pytest.mark.parametrize("layout,backend", READER_CASES)
def test_dense_steps_match_jax(model, layout, backend):
    """Prefill, a decode step, then an S = 4 verify step that reads what
    decode wrote: logits against the JAX model's (the pool holds the
    ring's pages at shuffled physical pages)."""
    cfg, params, pcfg, pp = model
    jc = dataclasses.replace(cfg, attn_backend="pallas" if backend == "kernel" else "einsum")
    pc = dataclasses.replace(pcfg, attn_backend=backend)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    lens = np.array([11, 6])
    want, jcache = jax.jit(JT.prefill, static_argnums=(0, 4))(
        jc, params, jnp.asarray(toks, jnp.int32), jnp.asarray(lens, jnp.int32), 20)
    got, cache = T.prefill(pc, pp, _t(toks), _t(lens), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    jpages = pages = None
    if layout == "pool":
        pools = [_pool(c) for c in _stacked_layers(jcache)]
        ptab = pools[0][1]
        jcache = {"prefix": (), "suffix": (), "blocks": ({"self": {
            k: jnp.stack([jnp.asarray(pl[k]) for pl, _ in pools])
            for k in ("k", "v", "pos")}},)}
        jpages, pages = (jnp.asarray(ptab), PS), (_t(ptab), PS)
    cache = caches_from_jax(pc, jax.tree.map(np.asarray, jcache), device="cpu")
    tok = rng.integers(0, cfg.vocab_size, 2)
    want, jcache = JT.decode_step(jc, params, jcache, jnp.asarray(tok, jnp.int32),
                                  jnp.asarray(lens, jnp.int32), pages=jpages)
    got, cache = T.decode_step(pc, pp, cache, _t(tok), _t(lens), pages=pages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    fed = rng.integers(0, cfg.vocab_size, (2, 4))
    mask = np.array([[True] * 4, [True, True, False, False]])
    cur = lens + 1
    want, _ = JT.verify_step(jc, params, jcache, jnp.asarray(fed, jnp.int32),
                             jnp.asarray(cur, jnp.int32), jnp.asarray(mask), pages=jpages)
    got, _ = T.verify_step(pc, pp, cache, _t(fed), _t(cur), _t(mask), pages=pages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


SAMPLED = dict(temperature=0.9, top_k=32, top_p=0.9, seed=11)
MIXED_KW = dict(max_slots=2, max_len=40, sync_every=4, prefill_chunk=8)
ENGINE_CASES = {
    # name: (engine keywords, sampled)
    "ring_greedy_einsum": (dict(backend="einsum"), False),
    "ring_sampled_kernel": (dict(backend="kernel"), True),
    "paged_greedy_kernel": (dict(backend="kernel", cache_layout="paged", page_size=4),
                            False),
    "ngram_ring_kernel": (dict(backend="kernel", spec_depth=3, draft="ngram"), False),
    "ngram_paged_sampled": (dict(backend="kernel", spec_depth=3, draft="ngram",
                                 cache_layout="paged", page_size=4), True),
}


def _serve(eng, prompts, sampling, max_new=6):
    port = isinstance(eng, Engine)
    R = Request if port else JRequest
    sp = None
    if sampling is not None:
        sp = SamplingParams(**sampling) if port else JSamplingParams(**sampling)
    for i, pr in enumerate(prompts):
        eng.submit(R(uid=i, prompt=pr.copy(), max_new_tokens=max_new, sampling=sp))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_dense_engine_streams_match_jax(model, case):
    """Five requests of mixed lengths on two slots (two chunked): the
    port's dense engine emits the JAX dense engine's streams."""
    cfg, params, pcfg, pp = model
    kw, sampled = ENGINE_CASES[case]
    kw = dict(MIXED_KW, **kw)
    jkw = dict(kw, backend="pallas" if kw["backend"] == "kernel" else "einsum")
    g = np.random.default_rng(3)
    prompts = [g.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 7, 12, 3)]
    sampling = SAMPLED if sampled else None
    want = _serve(JEngine(cfg, params, **jkw), prompts, sampling)
    got = _serve(Engine(pcfg, pp, device="cpu", **kw), prompts, sampling)
    assert got == want


COUNTERS = ("prefill_calls", "prefill_calls_saved", "pages_shared", "cow_forks",
            "prefix_resurrections", "preemptions", "pages_peak")


def test_dense_pool_shares_and_preempts_like_jax(model):
    """The dense pool moves "k" / "v" through the page code: six requests
    sharing an 8-token prefix, prefix-affinity admission, lazy pages in a
    13-page pool (page_size 4) that runs dry mid-decode.  Streams and the
    sharing / preemption counters equal the JAX dense engine's, and the
    port preempts at least once."""
    cfg, params, pcfg, pp = model
    g = np.random.default_rng(7)
    shared = g.integers(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([shared, g.integers(0, cfg.vocab_size, 1 + 2 * i)
                               .astype(np.int32)]) for i in range(6)]
    kw = dict(max_slots=4, max_len=40, sync_every=2, cache_layout="paged", page_size=4,
              n_pages=13, lazy_pages=True, policy="prefix-affinity")
    jeng = JEngine(cfg, params, backend="pallas", **kw)
    peng = Engine(pcfg, pp, device="cpu", backend="kernel", **kw)
    want = _serve(jeng, prompts, None, max_new=16)
    got = _serve(peng, prompts, None, max_new=16)
    assert got == want
    jm, pm = jeng.metrics(), peng.metrics()
    assert {k: pm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert pm["preemptions"] > 0 and pm["pages_shared"] > 0
