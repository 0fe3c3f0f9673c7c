"""deepseek-v3-671b in the port — MLA (``layers.mla_attention``, the
absorbed readers ``kv_cache.decode_attn_mla`` / ``verify_attn_mla``), the
``attn_dense`` prefix and the shared expert — against the JAX package at
its smoke size (1 ``attn_dense`` + 2 MoE layers of 8 experts top-2 and 1
shared; r_kv 16, dr 8, dn 8, dv 16), float32 with TF32 off, rtol 1e-4 /
atol 1e-5 (as JAX's own ``test_mla_and_sliding_window_verify_match``):

* the registry: FULL and SMOKE equal JAX's config dicts (``MLAConfig``
  included) and round-trip through ``to_dict`` / ``from_dict``;
  ``check_supported`` takes them, on a CUDA device with the kernel backend
  too, and a Mamba config as well (ported); ``recalkv_ratio`` raises JAX's
  ValueError;
* params and caches cross both ways in JAX's split layout (an unrolled
  ``attn_dense`` prefix, stacked ``blocks``), and ``init_params`` gives
  JAX's leaves, shapes and scales;
* ``mla_attention`` and the readers on numpy-seeded weights, on a ring and
  on a ragged page pool (its gathered view equal to the ring bit for bit),
  with their deferred entries committed by both packages' writers;
* prefill, decode and verify logits through both port backends against
  one jitted JAX run, on the ring and on a pool;
* ``Engine`` streams token for token against the JAX engine run once per
  flag set (greedy and sampled requests in one run): the sync ring, the
  paged pool with depth-2 ``"layers:1"`` (a draft of the ``attn_dense``
  layer), overlapped + continuous with depth-2 ``"ngram"`` (the ring's
  installs);
  the ``RuntimeWarning`` and ``metrics()["verify_backend"]`` as JAX's;
* ``compress`` refuses with JAX's ValueError.
"""

import dataclasses
import functools
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import compress as JC
from repro.models import kv_cache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
import repro_torch.api as A
from repro_torch import configs as PC
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import weights
from repro_torch.models.config import MambaConfig, ModelConfig, check_supported
from repro_torch.models.weights import (caches_from_jax, caches_to_jax, init_params,
                                        params_from_jax, params_to_jax)
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.engine import _merge_slot_paged

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-4, atol=1e-5)
MAX_LEN, PAGE = 48, 8
ENGINE = dict(max_slots=4, max_len=MAX_LEN, sync_every=4)
SAMPLED = dict(temperature=0.8, top_k=20, seed=3)
JAX_STEPS = types.SimpleNamespace(
    prefill=jax.jit(JT.prefill, static_argnums=(0, 4)),
    decode_step=jax.jit(JT.decode_step, static_argnums=(0,)),
    verify_step=jax.jit(JT.verify_step, static_argnums=(0,)))
JAX_MLA = jax.jit(JL.mla_attention, static_argnums=(2,))   # one compile, not one per op
_MODEL, _RUNS = [], {}


def _model():
    """(JAX cfg, JAX params, port cfg, port params) of the float32 smoke
    config, once per module."""
    if not _MODEL:
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=jnp.float32)
        params = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(13))
        pcfg = ModelConfig.from_dict(cfg.to_dict())
        _MODEL.extend([cfg, params, pcfg, params_from_jax(
            pcfg, jax.tree.map(np.asarray, params), device="cpu")])
    return _MODEL


def _t(a):
    return torch.from_numpy(np.array(a))


def test_registry_and_check_supported():
    """FULL and SMOKE equal JAX's config dicts and survive the dict round
    trip; ``check_supported`` takes them (the CPU, and a CUDA device with
    the kernel backend: MLA's readers launch no kernel), and with a Mamba
    config as well (ported); a ReCalKV ratio raises JAX's error.
    No card is needed: the check reads the config."""
    assert ARCH in PC.ARCHS and not PC.RECALKV_APPLICABLE[ARCH]
    for smoke in (False, True):
        got = PC.get_config(ARCH, smoke=smoke)
        assert got.to_dict() == get_config(ARCH, smoke=smoke).to_dict()
        assert ModelConfig.from_dict(got.to_dict()) == got
        check_supported(got)
        check_supported(dataclasses.replace(got, attn_backend="kernel"), torch.device("cuda"))
    full = PC.get_config(ARCH)
    assert full.expanded_layers()[:4] == ("attn_dense",) * 3 + ("attn",)
    assert (full.mla.kv_lora_rank, full.mla.qk_rope_dim, full.moe.num_shared) == (512, 64, 1)
    check_supported(dataclasses.replace(full, mamba=MambaConfig()))   # ported since
    with pytest.raises(ValueError) as want:
        get_config(ARCH, recalkv_ratio=0.5)
    with pytest.raises(ValueError, match="ReCalKV inapplicable") as got:
        PC.get_config(ARCH, recalkv_ratio=0.5)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("draw_bytes", [None, 2048])
def test_params_cross_both_ways_and_init_matches_jax(draw_bytes, monkeypatch):
    """JAX's split tree (the unrolled ``attn_dense`` prefix, stacked MoE
    ``blocks``) survives ``params_from_jax`` / ``params_to_jax`` leaf for
    leaf, and the port's ``init_params`` has its leaves, shapes, dtypes
    and scales (the norm scales and the router float32), also when every
    leaf past ``draw_bytes`` of float32 is drawn in slices along its first
    axis (as deepseek's expert leaves are at full width)."""
    if draw_bytes is not None:
        monkeypatch.setattr(weights, "DRAW_BYTES", draw_bytes)
    cfg, params, pcfg, pp = _model()
    tree = jax.tree.map(np.asarray, params)
    back = params_to_jax(pcfg, pp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert pp["layers"][0]["mlp"]["wi"].shape == (64, 128)        # attn_dense: d_ff
    assert pp["layers"][1]["mlp"]["shared"]["wi"].shape == (64, 32)
    got = params_to_jax(pcfg, init_params(pcfg, torch.Generator().manual_seed(0),
                                          device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.3, atol=1e-6, err_msg=str(path))


def _attn_params(rng, d=64, H=4, qr=32, r=16, dr=8, dn=8, dv=16):
    f = lambda *sh, s: (rng.standard_normal(sh) * s).astype(np.float32)
    return {"wq_a": f(d, qr, s=d ** -0.5), "q_a_norm": f(qr, s=0.1),
            "wq_b": f(qr, H * (dn + dr), s=qr ** -0.5),
            "wkv_a": f(d, r + dr, s=d ** -0.5), "kv_a_norm": f(r, s=0.1),
            "wkv_b": f(r, H * (dn + dv), s=r ** -0.5), "wo": f(H * dv, d, s=(H * dv) ** -0.5)}


def test_mla_attention_matches_jax():
    """The full-sequence (non-absorbed) form on seeded weights and inputs,
    T = 40 over chunks of 16 (one pass: 16 does not divide 40) and T = 32
    (two chunks): the output and the cached (c_kv, k_pe) within 1e-4."""
    cfg, _, pcfg, _ = _model()
    rng = np.random.default_rng(3)
    p = _attn_params(rng)
    for Tn in (40, 32):
        x = rng.standard_normal((2, Tn, 64)).astype(np.float32)
        pos = np.broadcast_to(np.arange(Tn), (2, Tn))
        want = JAX_MLA(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg, jnp.asarray(pos))
        got = L.mla_attention({k: _t(v) for k, v in p.items()}, _t(x), pcfg, _t(pos))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert got[1][0].shape == (2, Tn, 16) and got[1][1].shape == (2, Tn, 8)


def _mla_pool(rng, ps=4, n_pages=10, B=3, n_sp=4):
    """A ragged MLA pool: row 0 maps three pages, row 1 four (sharing row
    0's first), row 2 one; page 9 unmapped with stale positions.  Returns
    (ptab, pool, cur), each row's positions below cur valid and the
    steps' positions inside its table."""
    ptab = np.zeros((B, n_sp), np.int32)
    ptab[0, :3] = [7, 3, 6]
    ptab[1, :4] = [7, 5, 1, 8]
    ptab[2, :1] = [2]
    cur = np.array([2 * ps + 1, 3 * ps - 1, 2])
    pos = np.full((n_pages, ps), -1, np.int32)
    for b in range(B):
        for j in range(n_sp):
            if ptab[b, j]:
                t = j * ps + np.arange(ps)
                pos[ptab[b, j]] = np.where(t < cur[b], t, -1)
    pos[9] = np.arange(ps)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return ptab, {"ckv": f(n_pages, ps, 16), "krope": f(n_pages, ps, 8), "pos": pos}, cur


def _one_layer(cache):
    return {"prefix": ({"self": cache},), "blocks": None, "suffix": ()}


@functools.partial(jax.jit, static_argnums=(0, 9))
def _jax_readers(cfg, p, x1, xs, cache, cur, feed, active, accept, ps, ptab):
    """JAX's decode and verify readers on ``cache`` (through ``ptab`` when
    given), then their entries written by its writers: decode at ``cur``
    where ``active``, the verify columns at cur + 1 where ``accept``."""
    pages = None if ptab is None else (ptab, ps)
    dec = JKC.decode_attn_mla(p, x1, cache, cfg, cur, pages=pages)
    ver = JKC.verify_attn_mla(p, xs, cache, cfg, cur, feed, pages=pages)
    out = JKC.apply_decode_writes(_one_layer(cache), _one_layer(dec[1]), cur, active,
                                  pages=pages)
    out = JKC.apply_verify_writes(out, _one_layer(ver[1]), cur + 1, accept, pages=pages)
    return dec, ver, out["prefix"][0]["self"]


@pytest.mark.parametrize("layout", ["ring", "pool"])
def test_readers_and_writes_match_jax(layout):
    """``decode_attn_mla`` and ``verify_attn_mla`` (S 3, one unfed column)
    on the ring JAX's ``paged_view`` gathers from a ragged pool, or on the
    pool through its page table: outputs and deferred entries within
    1e-4 of JAX's; on the pool equal to the ring bit for bit; the entries
    committed by ``apply_decode_writes`` / ``apply_verify_writes`` (MLA
    leaves: no head axis) equal to JAX's writes."""
    cfg, _, pcfg, _ = _model()
    rng = np.random.default_rng(11)
    ps = 4
    p = _attn_params(rng)
    ptab, pool, cur = _mla_pool(rng, ps)
    ring = {k: np.asarray(v) for k, v in JKC.paged_view(
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(ptab), ps).items()}
    cache = ring if layout == "ring" else pool
    x1 = rng.standard_normal((3, 1, 64)).astype(np.float32)
    xs = rng.standard_normal((3, 3, 64)).astype(np.float32)
    feed = np.array([[True] * 3, [True, True, False], [True, True, True]])
    active = np.array([True, False, True])
    accept = np.array([[True, True, False], [True, False, False], [True, True, True]])
    want_d, want_v, want_w = _jax_readers(
        cfg, *jax.tree.map(jnp.asarray, (p, x1, xs, cache)), jnp.asarray(cur, jnp.int32),
        *map(jnp.asarray, (feed, active, accept)), ps,
        None if layout == "ring" else jnp.asarray(ptab))
    tp = {k: _t(v) for k, v in p.items()}
    tc = {k: _t(v).long() if k == "pos" else _t(v) for k, v in cache.items()}
    tpages = None if layout == "ring" else (_t(ptab), ps)
    got_d = KC.decode_attn_mla(tp, _t(x1), tc, pcfg, _t(cur), pages=tpages)
    got_v = KC.verify_attn_mla(tp, _t(xs), tc, pcfg, _t(cur), _t(feed), pages=tpages)
    for got, want in ((got_d, want_d), (got_v, want_v)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
        for k in ("ckv", "krope", "pos"):
            np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]), **TOL)
    if layout == "pool":   # the pool reads its gathered view: the ring's bits
        tr = {k: _t(v).long() if k == "pos" else _t(v) for k, v in ring.items()}
        assert torch.equal(got_d[0], KC.decode_attn_mla(tp, _t(x1), tr, pcfg, _t(cur))[0])
        assert torch.equal(got_v[0], KC.verify_attn_mla(tp, _t(xs), tr, pcfg, _t(cur),
                                                        _t(feed))[0])
    caches = [{"self": tc}]
    KC.apply_decode_writes(caches, [{"self": got_d[1]}], _t(cur), _t(active), pages=tpages)
    KC.apply_verify_writes(caches, [{"self": got_v[1]}], _t(cur) + 1, _t(accept),
                           pages=tpages)
    for k, v in want_w.items():
        np.testing.assert_allclose(caches[0]["self"][k].numpy(), np.asarray(v), **TOL,
                                   err_msg=k)


def _steps(mod, cfg, params, conv, paged=False):
    """Prompts of 20 / 13 / 7 tokens, two greedy decode steps, then one
    S = 4 verify step with a -1 pad and masked columns: the logits of each
    (prefill and decode (3, V), verify (3, 4, V)) and the prefill caches
    (the port's are written in place by the steps after it).
    ``paged`` (the port) moves the prefilled rings into a page-8 pool at
    shuffled physical pages and steps through the page table."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 20))
    lens = np.array([20, 13, 7])
    logits, caches = mod.prefill(cfg, params, conv(toks), conv(lens), MAX_LEN)
    prefilled, pages = caches, None
    if paged:
        n_sp = MAX_LEN // PAGE
        phys = np.random.default_rng(6).permutation(3 * n_sp) + 1
        pool = T.init_decode_cache(cfg, 3, MAX_LEN, "cpu", pages=(3 * n_sp + 1, PAGE))
        _merge_slot_paged(pool, caches, _t(np.repeat(np.arange(3), n_sp)),
                          _t(np.tile(np.arange(n_sp), 3)), _t(phys), PAGE)
        caches, pages = pool, (_t(phys.reshape(3, n_sp).astype(np.int32)), PAGE)
    outs, cur = [np.asarray(logits)], lens.copy()
    for _ in range(2):
        kw = {} if pages is None else dict(pages=pages)
        logits, caches = mod.decode_step(cfg, params, caches, conv(outs[-1].argmax(-1)),
                                         conv(cur), **kw)
        outs.append(np.asarray(logits))
        cur = cur + 1
    fed = rng.integers(0, cfg.vocab_size, (3, 4))
    fed[1, 3] = -1
    mask = np.array([[True] * 4, [True, True, True, False], [True, False, False, False]])
    kw = {} if pages is None else dict(pages=pages)
    vlog, _ = mod.verify_step(cfg, params, caches, conv(fed), conv(cur), conv(mask), **kw)
    return np.stack(outs), np.asarray(vlog), prefilled


def _jconv(a):
    a = np.asarray(a)
    return jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, jnp.int32)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("layout", ["ring", "pool"])
def test_logits_match_jax(layout, backend):
    """Prefill, decode and verify logits within 1e-4 of one jitted JAX run
    (its MLA path is the same under either JAX backend), through both port
    backends (MLA takes no kernel: the same einsum readers), on the ring
    and on a page-8 pool (equal to the ring bit for bit); the prefill's
    caches cross to and from JAX's split tree."""
    cfg, params, pcfg, pp = _model()
    if "logits" not in _RUNS:
        _RUNS["logits"] = _steps(JAX_STEPS, cfg, params, _jconv)
    want = _RUNS["logits"]
    pcfg = dataclasses.replace(pcfg, attn_backend=backend)
    got = _steps(T, pcfg, pp, torch.as_tensor, paged=layout == "pool")
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, **TOL)
    if layout == "pool":
        for a, b in zip(got[:2], _steps(T, pcfg, pp, torch.as_tensor)[:2]):
            np.testing.assert_array_equal(a, b)
        return
    # the port's steps wrote into its prefill caches in place: prefill anew
    rng = np.random.default_rng(5)
    _, caches = T.prefill(pcfg, pp, torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 20))),
                          torch.tensor([20, 13, 7]), MAX_LEN)
    jtree = jax.tree.map(np.asarray, want[2])
    assert jax.tree.structure(caches_to_jax(pcfg, caches)) == jax.tree.structure(jtree)
    for a, b in zip(caches_from_jax(pcfg, jtree, device="cpu"), caches):
        for k, v in b["self"].items():
            np.testing.assert_allclose(a["self"][k].numpy(), v.numpy(), **TOL, err_msg=k)


def _prompts(vocab):
    """Five prompts (one more than the slots), one a repeated motif for the
    n-gram draft."""
    rng = np.random.default_rng(7)
    motif = rng.integers(0, vocab, 6)
    return [rng.integers(0, vocab, 27), np.tile(motif, 4), rng.integers(0, vocab, 19),
            rng.integers(0, vocab, 30), rng.integers(0, vocab, 22)]


def _serve(eng, prompts, port=True):
    """Odd uids sample (temperature 0.8, top-k 20), even ones are greedy."""
    R, SP = (Request, SamplingParams) if port else (JRequest, JSamplingParams)
    for i, p in enumerate(prompts):
        eng.submit(R(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=8,
                     sampling=SP(**SAMPLED) if i % 2 else None))
    done = eng.run()
    eng.close()
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}, eng.metrics()


VARIANTS = {"sync": {},
            # the draft is the attn_dense prefix layer alone, over the pool
            "paged_layers1": dict(cache_layout="paged", page_size=PAGE, spec_depth=2,
                                  draft="layers:1"),
            # inline admission: the sync engine's waves, so every MoE call
            # has JAX's rows
            "overlap_continuous_ngram2": dict(overlap=True, continuous=True,
                                              pipeline_depth=2, admission_thread=False,
                                              spec_depth=2, draft="ngram")}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_streams_match_jax(variant):
    """Streams of the port's engine on the kernel backend equal the JAX
    engine's on its Pallas backend with the same flags, token for token,
    greedy and sampled; both warn once that MLA's kinds fall back to
    einsum, and ``verify_backend`` reads as JAX's ("einsum" under
    speculation, None without)."""
    cfg, params, pcfg, pp = _model()
    flags = VARIANTS[variant]
    with pytest.warns(RuntimeWarning, match=r"layer kinds \['attn', 'attn_dense'\]"):
        jeng = JEngine(dataclasses.replace(cfg, attn_backend="pallas"), params, **ENGINE,
                       **flags)
    want, jm = _serve(jeng, _prompts(cfg.vocab_size), port=False)
    with pytest.warns(RuntimeWarning, match=r"backend='kernel': layer kinds "
                                            r"\['attn', 'attn_dense'\] have no"):
        eng = Engine(dataclasses.replace(pcfg, attn_backend="kernel"), pp, device="cpu",
                     **ENGINE, **flags)
    got, m = _serve(eng, _prompts(cfg.vocab_size))
    assert got == want
    assert m["verify_backend"] == jm["verify_backend"] == (
        "einsum" if flags.get("spec_depth") else None)
    if flags.get("continuous"):
        assert m["slot_swaps"] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the einsum backend asked for nothing else
        Engine(pcfg, pp, device="cpu", **ENGINE).close()


def test_compress_refuses_mla():
    """``compress`` of an MLA model raises JAX's ValueError (DeepSeek
    already caches trained latents), from the model level and the API,
    after ``calibrate`` has captured its statistics."""
    cfg, _, pcfg, pp = _model()
    with pytest.raises(ValueError, match="MLA models already cache latents") as want:
        JC.compress_model(dataclasses.replace(cfg, scan_layers=False), None, [], None)
    batches = [{"tokens": np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))}]
    calib = A.calibrate(pcfg, pp, batches)
    assert len(calib.stats) == cfg.num_layers
    for spec in ("recalkv", A.CompressionSpec("recalkv",
                                              rank_policy=A.RankPolicy(keep_ratio=0.5))):
        with pytest.raises(ValueError) as got:
            A.compress(pcfg, pp, spec, calib)
        assert str(got.value) == str(want.value)
