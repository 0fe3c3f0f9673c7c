"""The recurrent models in the port — ``falcon-mamba-7b`` (Mamba-1 blocks
alone) and ``recurrentgemma-9b`` (RG-LRU blocks with a dense FFN, and
``local`` MQA attention every third layer) — against the JAX package at
their smoke sizes, float32 with TF32 off, on numpy-seeded inputs and
weights carried by ``params_from_jax``:

* the registry: FULL and SMOKE equal JAX's config dicts (recurrentgemma
  with and without a ReCalKV ratio; falcon-mamba's ratio raises JAX's
  ValueError); ``check_supported`` takes them, on a CUDA device with the
  kernel backend too;
* ``_causal_conv1d`` with and without a state, ``_ssm_chunk_scan``,
  ``mamba_mixer`` at T 1, 64 and 256 (two chunks of 128), with and without
  an incoming state, and ``rglru_mixer`` at T 1 and 24, with and without
  one: outputs and new states (1e-5);
* prefill then step-by-step decode reproducing the forward (2e-3, as JAX's
  ``test_decode_matches_forward``), and prefill and decode logits and
  caches against JAX's on right-padded rows (the state after the pads, as
  JAX leaves it), through both port backends;
* ``params_*`` / ``caches_*`` round trips with the mixers' leaves, the
  state leaves and recurrentgemma's unrolled suffix, unrolled and
  scanned (bit for bit), and ``init_params``'s leaves against JAX's;
* ``capture_calibration`` walking past the mixers and ``compress_model``
  on recurrentgemma's ``local`` layers at s = 1 (1e-4);
* ``Engine`` streams, greedy and sampled, token for token against the JAX
  engine run once per flag set: falcon-mamba dense and recurrentgemma
  dense, each sync, overlapped and continuous; recurrentgemma compressed
  sync and continuous, and on the int8 ring.  Six prompts of 3 to 13
  tokens on four slots, so a wave pads its shorter rows (the padded-state
  quirk); the overlapped engines admit inline (a threaded admission forms
  other waves, and so other pads);
* the refusals with JAX's messages: ``spec_depth > 0``, the paged pool,
  the ``layers:K`` draft, a verify step; and the compression of
  falcon-mamba.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import pipeline as JP
from repro.models import compress as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import draft as JD
import repro.api as JA
import repro_torch.api as A
from repro_torch import configs as PC
from repro_torch.core import pipeline as P
from repro_torch.models import compress as C
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import BLOCK_KINDS, PORTED_KINDS, ModelConfig, check_supported
from repro_torch.models.weights import (caches_from_jax, caches_to_jax, init_params,
                                        params_from_jax, params_to_jax)
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving import draft as D

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
MAMBA, RG = "falcon-mamba-7b", "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)
FWD = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_slots=4, max_len=48, sync_every=4)
SAMPLED = dict(temperature=0.8, top_k=20, seed=3)
# one compile per config and shape, not one dispatch per op
J_PREFILL = jax.jit(JT.prefill, static_argnums=(0, 4))
J_DECODE = jax.jit(JT.decode_step, static_argnums=0)
J_FORWARD = jax.jit(JT.forward_hidden, static_argnums=0)
_RUNS = {}


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


def _mixer(arch):
    """(JAX cfg, JAX mixer params, port cfg, port mixer params) of layer 0."""
    cfg, params, pcfg, pp = _model(arch)
    return cfg, params["prefix"][0]["mixer"], pcfg, pp["layers"][0]["mixer"]


def test_registry_and_check_supported():
    """Every block kind is ported; FULL and SMOKE equal JAX's config dicts
    (recurrentgemma also at ratio 0.5: G 1 of s 1, r 128 at full width),
    and ``check_supported`` takes them, FULL on a CUDA device with the kernel backend too (recurrentgemma:
    dh 256, q_per_kv 16); falcon-mamba's ratio raises JAX's ValueError."""
    assert set(PORTED_KINDS) == set(BLOCK_KINDS)
    for arch in (MAMBA, RG):
        assert arch in PC.ARCHS
        assert PC.RECALKV_APPLICABLE[arch] == (arch == RG)
        for smoke in (False, True):
            for ratio in (None, 0.5) if arch == RG else (None,):
                got = PC.get_config(arch, smoke=smoke, recalkv_ratio=ratio)
                assert got.to_dict() == get_config(arch, smoke=smoke,
                                                   recalkv_ratio=ratio).to_dict()
                assert ModelConfig.from_dict(got.to_dict()) == got
                check_supported(got)
                if not smoke:
                    check_supported(dataclasses.replace(got, attn_backend="kernel"),
                                    torch.device("cuda"))
    full = PC.get_config(RG, recalkv_ratio=0.5)
    assert (full.recalkv.num_groups(1), full.recalkv.slots(1), full.recalkv.rank_k) == (1, 1, 128)
    assert full.suffix_pattern == ("rglru", "rglru") and full.num_periods == 12
    with pytest.raises(ValueError) as want:
        get_config(MAMBA, recalkv_ratio=0.5)
    with pytest.raises(ValueError, match="ReCalKV inapplicable to falcon-mamba-7b") as got:
        PC.get_config(MAMBA, recalkv_ratio=0.5)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_and_chunk_scan_match_jax(with_state):
    """``_causal_conv1d`` (its output and its new state, from zeros or a
    given state) and ``_ssm_chunk_scan`` (every step and the last, from a
    given h0) against JAX's (1e-5)."""
    g = np.random.default_rng(1)
    x = g.normal(size=(2, 7, 12)).astype(np.float32)
    w = g.normal(size=(4, 12)).astype(np.float32)
    b = g.normal(size=(12,)).astype(np.float32)
    st = g.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    want = JL._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    got = L._causal_conv1d(_t(x), _t(w), _t(b), None if st is None else _t(st))
    for a, o in zip(want, got):
        np.testing.assert_allclose(_np(o), np.asarray(a), **TOL)
    decay = np.exp(-g.uniform(0, 2, size=(2, 9, 5, 3))).astype(np.float32)
    drive = g.normal(size=(2, 9, 5, 3)).astype(np.float32)
    h0 = (g.normal(size=(2, 5, 3)) if with_state else np.zeros((2, 5, 3))).astype(np.float32)
    want = JL._ssm_chunk_scan(jnp.asarray(decay), jnp.asarray(drive), jnp.asarray(h0))
    got = L._ssm_chunk_scan(_t(decay), _t(drive), _t(h0))
    for a, o in zip(want, got):
        np.testing.assert_allclose(_np(o), np.asarray(a), **TOL)


def _state(kind, cfg, rng, B):
    if kind == "mamba":
        h, w = (B, cfg.mamba_d_inner, cfg.mamba.d_state), cfg.mamba_d_inner
        k = cfg.mamba.d_conv
    else:
        h, w, k = (B, cfg.lru_width), cfg.lru_width, cfg.rglru.conv_width
    return {"h": rng.normal(size=h).astype(np.float32),
            "conv": rng.normal(size=(B, k - 1, w)).astype(np.float32)}


@pytest.mark.parametrize("T_", [1, 64, 256])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_mixer_matches_jax(T_, with_state):
    """``mamba_mixer`` at T 1 (one step), 64 (one chunk) and 256 (two chunks
    of 128 scanned in order), from zeros or a given state: output and new
    state (h, conv) against JAX's (1e-5)."""
    cfg, jp, pcfg, p = _mixer(MAMBA)
    g = np.random.default_rng(T_ + with_state)
    x = g.normal(size=(2, T_, cfg.d_model)).astype(np.float32)
    st = _state("mamba", cfg, g, 2) if with_state else None
    want = jax.jit(JL.mamba_mixer, static_argnums=2)(
        jp, jnp.asarray(x), cfg, None if st is None else jax.tree.map(jnp.asarray, st))
    got = L.mamba_mixer(p, _t(x), pcfg, None if st is None else
                        {k: _t(v) for k, v in st.items()})
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(got[1][k]), np.asarray(want[1][k]), **TOL, err_msg=k)
    assert got[1]["h"].dtype == torch.float32


@pytest.mark.parametrize("T_", [1, 24])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_mixer_matches_jax(T_, with_state):
    """``rglru_mixer`` at T 1 and 24, from zeros or a given state: output
    and new state against JAX's (1e-5; the gate's GELU is the tanh form,
    softplus JAX's logaddexp)."""
    cfg, jp, pcfg, p = _mixer(RG)
    g = np.random.default_rng(10 + T_ + with_state)
    x = g.normal(size=(2, T_, cfg.d_model)).astype(np.float32)
    st = _state("rglru", cfg, g, 2) if with_state else None
    want = jax.jit(JL.rglru_mixer, static_argnums=2)(
        jp, jnp.asarray(x), cfg, None if st is None else jax.tree.map(jnp.asarray, st))
    got = L.rglru_mixer(p, _t(x), pcfg, None if st is None else
                        {k: _t(v) for k, v in st.items()})
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(got[1][k]), np.asarray(want[1][k]), **TOL, err_msg=k)


@pytest.mark.parametrize("arch,latent", [(MAMBA, False), (RG, False), (RG, True)])
def test_prefill_then_decode_reproduces_forward(arch, latent):
    """Prefill of 8 tokens then 4 decode steps give the full forward's
    logits at each position (2e-3, as JAX's ``test_decode_matches_forward``);
    ``forward_hidden`` equals JAX's (1e-4), its aux 0; a verify step raises
    JAX's NotImplementedError on a recurrent block."""
    cfg, params, pcfg, pp = _model(arch, latent)
    B, Tn, Lp = 2, 12, 8
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, Tn))
    hidden, aux = T.forward_hidden(pcfg, pp, _t(toks))
    want, _ = J_FORWARD(cfg, params, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(_np(hidden), np.asarray(want), **FWD)
    assert float(aux) == 0.0 and aux.dtype == torch.float32
    full = T.logits_for(pcfg, pp, hidden)
    lg, cache = T.prefill(pcfg, pp, _t(toks[:, :Lp]), torch.full((B,), Lp), Tn + 4)
    np.testing.assert_allclose(_np(lg), _np(full[:, Lp - 1]), rtol=1e-3, atol=1e-3)
    for t in range(Lp, Tn):
        lg, cache = T.decode_step(pcfg, pp, cache, _t(toks[:, t]), torch.full((B,), t))
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), rtol=2e-3, atol=2e-3)
    with pytest.raises(NotImplementedError, match="speculative verify is unsupported "
                                                  "for recurrent"):
        T.verify_step(pcfg, pp, cache, _t(toks[:, :2]), torch.full((B,), Tn),
                      torch.ones((B, 2), dtype=torch.bool))


@pytest.mark.parametrize("arch,latent", [(MAMBA, False), (RG, False), (RG, True)])
@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_steps_and_caches_match_jax(arch, latent, backend):
    """Prefill of right-padded rows (lengths 21 / 13 / 5 in a 24-token
    bucket, past recurrentgemma's 16-token window) and 3 greedy decode
    steps with one row idle on the last: logits and every cache leaf
    against JAX's (1e-4).  The prefill runs the mixers over the pads, so
    a short row's state is the state after them, as JAX leaves it; an
    idle row keeps its state."""
    cfg, params, pcfg, pp = _model(arch, latent)
    pcfg = dataclasses.replace(pcfg, attn_backend=backend)
    rng = np.random.default_rng(5)
    toks, lens = rng.integers(0, cfg.vocab_size, (3, 24)), np.array([21, 13, 5])
    want, jc = J_PREFILL(cfg, params, jnp.asarray(toks, jnp.int32), jnp.asarray(lens), 32)
    got, pc = T.prefill(pcfg, pp, _t(toks), _t(lens), 32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    cur, active = lens.copy(), np.array([True, True, True])
    for step in range(3):
        if step == 2:
            active[1] = False
        nxt = np.asarray(jnp.argmax(want, -1))
        before = [{k: v.clone() for k, v in c["state"].items()} for c in pc if "state" in c]
        want, jc = J_DECODE(cfg, params, jc, jnp.asarray(nxt, jnp.int32), jnp.asarray(cur),
                            jnp.asarray(active))
        got, pc = T.decode_step(pcfg, pp, pc, _t(nxt), _t(cur), _t(active))
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
        cur = cur + active
    assert all(torch.equal(b[k][1], c["state"][k][1])
               for b, c in zip(before, [c for c in pc if "state" in c]) for k in b)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(caches_to_jax(pcfg, pc))):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_allclose(b, np.asarray(a), **FWD)


@pytest.mark.parametrize("arch", [MAMBA, RG])
@pytest.mark.parametrize("scan", [False, True])
def test_params_and_caches_round_trip(arch, scan):
    """``params_from_jax`` / ``params_to_jax`` and ``caches_from_jax`` /
    ``caches_to_jax`` carry the mixers' leaves (``A_log``, ``dt_bias``,
    ``D``, ``a_param`` float32), the one-level ``{"h", "conv"}`` state and
    recurrentgemma's unrolled suffix both ways, bit for bit, unrolled and
    scanned; the port's ``init_params`` draws JAX's leaves, shapes and
    dtypes, and its constants (``A_log`` = log(1..d_state), ``dt_bias``
    -4, ``D`` 1, ``a_param`` 0.65) exactly."""
    cfg, params, pcfg, pp = _model(arch, scan=scan)
    back = params_to_jax(pcfg, pp)
    jl = jax.tree_util.tree_leaves_with_path(params)
    bl = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [jax.tree_util.keystr(k) for k, _ in bl]
    for (_, a), (_, b) in zip(jl, bl):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)
    mine = params_to_jax(pcfg, init_params(pcfg, torch.Generator().manual_seed(0),
                                           device="cpu"))
    assert jax.tree.map(lambda a: (a.shape, a.dtype.name), mine) == jax.tree.map(
        lambda a: (a.shape, a.dtype.name), params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine), jax.tree.leaves(params)):
        name = jax.tree_util.keystr(path)
        if any(c in name for c in ("A_log", "dt_bias", "'D'", "a_param")):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 6))
    _, cache = J_PREFILL(cfg, params, jnp.asarray(toks, jnp.int32), jnp.full((2,), 6), 16)
    cache = jax.tree.map(np.asarray, cache)
    got = caches_from_jax(pcfg, cache, device="cpu")
    assert [sorted(c) for c in got] == [["self"] if k == "local" else ["state"]
                                        for k in pcfg.expanded_layers()]
    again = caches_to_jax(pcfg, got)
    assert jax.tree.structure(again) == jax.tree.structure(cache)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(again)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    fresh = T.init_decode_cache(pcfg, 2, 16, "cpu")
    assert [{k: (tuple(v.shape), v.dtype) for k, v in c["state"].items()}
            for c in fresh if "state" in c] == [
        {k: (tuple(v.shape), v.dtype) for k, v in c["state"].items()}
        for c in got if "state" in c]


@functools.lru_cache(maxsize=None)
def _jax_compressed():
    """JAX's ``compress_model`` of recurrentgemma's dense smoke model (keep
    0.5; one kv head, so s = 1) on its statistics: (cfg, params, stats)."""
    cfg, params, _, _ = _model(RG)
    stats = JC.capture_calibration(cfg, params, [{"tokens": jnp.asarray(b["tokens"])}
                                                 for b in _calib_batches(cfg)])
    rc = JP.ReCalKVConfig(keep_ratio=0.5, use_fisher=False)
    ccfg, cparams = JC.compress_model(cfg, params, stats, rc)
    return ccfg, cparams, stats


def _calib_batches(cfg, n=2):
    g = np.random.default_rng(5)
    return [{"tokens": g.integers(0, cfg.vocab_size, (2, 16))} for _ in range(n)]


def test_calibration_and_compression_match_jax(tmp_path):
    """``capture_calibration`` walks past the RG-LRU blocks (JAX's
    statistics of the ``local`` layers, 1e-4) and ``compress_model`` gives
    JAX's params at s = 1 (HSR degenerates to one group of one head, then
    whitened SVD and OCMF; the mixers untouched) and its ranks (1e-4);
    through ``repro_torch.api``, falcon-mamba (no attention layer) is
    refused by ``calibrate``, ``compress`` and ``serve`` (of the rank-0
    artifact JAX's ``compress`` writes for it)."""
    cfg, params, pcfg, pp = _model(RG)
    ccfg, cparams, jstats = _jax_compressed()
    stats = C.capture_calibration(pcfg, pp, _calib_batches(cfg))
    assert len(stats) == len(jstats) == 1
    for a, b in zip(stats, jstats):
        np.testing.assert_allclose(_np(a.cov), np.asarray(b.cov), rtol=1e-4, atol=1e-3)
        assert a.count == b.count
    pccfg, got = C.compress_model(pcfg, pp, stats, P.ReCalKVConfig(keep_ratio=0.5,
                                                                   use_fisher=False))
    assert pccfg.recalkv.ranks_by_layer == ccfg.recalkv.ranks_by_layer
    assert pccfg.recalkv.group_size == ccfg.recalkv.group_size == 1
    want = params_to_jax(pccfg, got)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(cparams),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert got["layers"][0]["mixer"] is pp["layers"][0]["mixer"]
    _, _, mcfg, mp = _model(MAMBA)
    batches = _calib_batches(mcfg)
    jcfg, jparams, _, _ = _model(MAMBA)
    JA.save_artifact(JA.compress(jcfg, jparams, "recalkv", [
        {"tokens": jnp.asarray(b["tokens"])} for b in batches]), str(tmp_path / "fm"))
    for call in (lambda: A.calibrate(mcfg, mp, batches),
                 lambda: A.compress(mcfg, mp, "recalkv", batches),
                 lambda: A.serve(str(tmp_path / "fm"), device="cpu", **ENGINE)):
        with pytest.raises(ValueError, match="ReCalKV inapplicable to falcon-mamba-7b"):
            call()


def _prompts(vocab):
    """Six prompts of 3 to 13 tokens: a wave of four pads its short rows."""
    g = np.random.default_rng(11)
    return [g.integers(0, vocab, n).astype(np.int32) for n in (13, 5, 9, 3, 11, 7)]


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
    """(JAX cfg, JAX params, port cfg, port params): dense, compressed (JAX's
    ``compress_model``) or compressed on the int8 ring."""
    if cache == "dense":
        return _model(arch)
    ccfg, cparams, _ = _jax_compressed()
    if cache == "int8":
        ccfg = dataclasses.replace(ccfg, cache_quant_bits=8)
    pcfg = ModelConfig.from_dict(ccfg.to_dict())
    return ccfg, cparams, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, cparams),
                                                device="cpu")


# the overlapped engines admit inline: a worker thread forms waves as
# requests arrive, and a wave's bucket sets how many pads a row's state
# has run over (so does the JAX engine's)
VARIANTS = {"sync": {},
            "overlap": dict(overlap=True, admission_thread=False),
            "continuous": dict(overlap=True, continuous=True, admission_thread=False)}
CASES = ([(a, "dense", v) for a in (MAMBA, RG) for v in VARIANTS]
         + [(RG, "compressed", "sync"), (RG, "compressed", "continuous"),
            (RG, "int8", "sync")])


@pytest.mark.parametrize("arch,cache,variant", CASES)
def test_engine_streams_match_jax(arch, cache, variant):
    """The port's engine (kernel backend: plain versions on the CPU) serves
    six requests of mixed lengths on four slots, greedy and sampled, with
    the streams of the JAX engine (Pallas backend, interpret mode) run with
    the same flags, token for token; continuous batching installs as many
    times as JAX's."""
    cfg, params, pcfg, pp = _engine_model(arch, cache)
    flags = VARIANTS[variant]
    key = (arch, cache, variant)
    if key not in _RUNS:
        _RUNS[key] = _serve(JEngine(dataclasses.replace(cfg, attn_backend="pallas"), params,
                                    **ENGINE, **flags), _prompts(cfg.vocab_size), port=False)
    want, jm = _RUNS[key]
    eng = Engine(dataclasses.replace(pcfg, attn_backend="kernel"), pp, device="cpu",
                 **ENGINE, **flags)
    got, m = _serve(eng, _prompts(cfg.vocab_size))
    assert got == want
    assert len(got) == 6
    if flags.get("continuous"):
        assert m["slot_swaps"] > 0 and m["slot_swaps"] == jm["slot_swaps"]


@pytest.mark.parametrize("arch", [MAMBA, RG])
def test_engine_refusals(arch):
    """``spec_depth > 0``, the paged pool and a ``layers:K`` draft over a
    recurrent layer raise JAX's ValueError, word for word; the kernel
    backend warns of nothing (the mixers are not attention)."""
    cfg, params, pcfg, pp = _model(arch)
    for bad in (dict(spec_depth=2), dict(spec_depth=2, draft="layers:1"),
                dict(cache_layout="paged", page_size=8)):
        with pytest.raises(ValueError) as want:
            JEngine(cfg, params, **ENGINE, **bad)
        with pytest.raises(ValueError) as got:
            Engine(pcfg, pp, device="cpu", **ENGINE, **bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JD.make_layer_draft(cfg, params, 1)
    with pytest.raises(ValueError, match="layers draft cannot include recurrent") as got:
        D.make_layer_draft(pcfg, pp, 1)
    assert str(got.value) == str(want.value)
    assert KC.kernel_fallback_kinds(pcfg) == []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Engine(pcfg, pp, device="cpu", backend="kernel", **ENGINE).close()
