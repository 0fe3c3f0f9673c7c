"""The three dense families the port serves beside qwen3-4b — minicpm-2b
(MHA, 36 kv heads at full width), gemma3-12b (5 ``local`` : 1 global
layers, per-kind RoPE theta, qk-norm, ``embed_scale``) and h2o-danube-1.8b
(every layer ``local``, untied embeddings) — against the JAX package, at
their smoke sizes (window 16), dense and at ``recalkv_ratio=0.5``:

* the registry: each config equals JAX's, field for field;
* ``check_supported``: the CPU and a CUDA device with the kernel backend
  take all three (gemma3's d_head 256, minicpm's 64, danube's 80); a
  d_head no Hopper body takes stays refused (ROADMAP.md Queue 3 item 2);
  a Mamba block or an RG-LRU config, ported since, is taken;
* prefill and decode logits on prompts longer than the window, through
  the port's einsum and kernel backends (the plain versions on the CPU),
  against JAX's einsum (dense) and its Pallas kernels in interpret mode
  (latent);
* greedy ``Engine`` streams, sync, ``spec_depth=3`` with ``"ngram"``, and
  overlapped with continuous batching, each equal to the JAX engine's
  sync streams token for token (one JAX run per config); minicpm also on
  the paged pool; gemma3 and danube refuse the pool with JAX's message;
* ``compress("recalkv", keep_ratio=0.5)`` on the dense model: the same
  config and ``ranks_by_layer`` as JAX's, logits within 1e-4.

Float32 with TF32 off.  Logits atol 1e-4; streams compared exactly.
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
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
import repro_torch.api as A
from repro_torch import configs as PC
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, RGLRUConfig, check_supported
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.serving import Engine, Request

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
LOGITS = dict(atol=1e-4, rtol=0)
ARCHS = ("minicpm-2b", "gemma3-12b", "h2o-danube-1.8b")
RATIOS = {"dense": None, "latent": 0.5}
JAX_STEPS = types.SimpleNamespace(prefill=jax.jit(JT.prefill, static_argnums=(0, 4)),
                                  decode_step=jax.jit(JT.decode_step, static_argnums=(0,)))
MAX_LEN = 64
ENGINE = dict(max_slots=4, max_len=MAX_LEN, sync_every=4)
_MODELS, _STREAMS = {}, {}


def _model(arch, kind, backend="einsum"):
    """(JAX cfg, JAX params, port cfg, port params) of a smoke config, once
    per (arch, kind); ``backend`` rebinds only the configs."""
    key = (arch, kind)
    if key not in _MODELS:
        cfg = dataclasses.replace(get_config(arch, smoke=True, recalkv_ratio=RATIOS[kind]),
                                  dtype=jnp.float32)
        params = JT.init_params(cfg, jax.random.PRNGKey(11))
        pcfg = ModelConfig.from_dict(cfg.to_dict())
        _MODELS[key] = (cfg, params, pcfg,
                        params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                        device="cpu"))
    cfg, params, pcfg, pp = _MODELS[key]
    return (dataclasses.replace(cfg, attn_backend=backend), params,
            dataclasses.replace(pcfg, attn_backend="kernel" if backend == "pallas"
                                else "einsum"), pp)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_matches_jax(arch):
    """FULL and SMOKE, dense and at ratio 0.5 (minicpm: G 9 groups of 4,
    r 128; gemma3: G 2, r 512), equal JAX's config dicts."""
    assert arch in PC.ARCHS
    for smoke in (False, True):
        for ratio in RATIOS.values():
            got = PC.get_config(arch, smoke=smoke, recalkv_ratio=ratio)
            assert got.to_dict() == get_config(arch, smoke=smoke,
                                               recalkv_ratio=ratio).to_dict()
    rt = PC.get_config(arch, recalkv_ratio=0.5).recalkv
    full = PC.get_config(arch)
    expect = {"minicpm-2b": (9, 128), "gemma3-12b": (2, 512), "h2o-danube-1.8b": (2, 160)}
    assert (rt.num_groups(full.num_kv_heads), rt.rank_k) == expect[arch]


def test_check_supported_takes_the_families():
    """The CPU takes all three (dense and latent), and so does a CUDA device
    with the kernel backend: gemma3 (d_head 256), minicpm (64, q_per_kv 1)
    and danube (80).  A d_head no Hopper body takes (96) is refused by
    name on the card, naming Queue 3 item 2; a Mamba block or an RG-LRU
    config, which the port serves since Queue 1 item 4 closed, is taken.
    No card is needed: the check reads the config."""
    cuda = torch.device("cuda")
    for arch in ARCHS:
        for ratio in RATIOS.values():
            cfg = PC.get_config(arch, recalkv_ratio=ratio)
            check_supported(cfg)
            check_supported(cfg, torch.device("cpu"))
            check_supported(dataclasses.replace(cfg, attn_backend="einsum"), cuda)
            check_supported(dataclasses.replace(cfg, attn_backend="kernel"), cuda)
    wide = dataclasses.replace(PC.get_config("h2o-danube-1.8b"), d_head=96,
                               attn_backend="kernel")
    with pytest.raises(NotImplementedError,
                       match=r"h2o-danube-1\.8b: d_head 96.*Queue 3 item 2"):
        check_supported(wide, cuda)
    check_supported(wide, torch.device("cpu"))
    base = PC.get_config("gemma3-12b", smoke=True)
    for ported in (dict(layer_pattern=("local", "mamba")), dict(rglru=RGLRUConfig())):
        check_supported(dataclasses.replace(base, **ported))


def _prefill_decode(mod, cfg, params, conv, steps=3):
    """Prompts of 40 / 23 / 9 tokens (past the smoke window of 16), then
    ``steps`` greedy decode steps; the logits of each."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 40))
    lens = np.array([40, 23, 9])
    logits, caches = mod.prefill(cfg, params, conv(toks), conv(lens), MAX_LEN)
    outs, cur = [np.asarray(logits)], lens.copy()
    for _ in range(steps):
        tok = outs[-1].argmax(-1)
        logits, caches = mod.decode_step(cfg, params, caches, conv(tok), conv(cur))
        outs.append(np.asarray(logits))
        cur = cur + 1
    return np.stack(outs)


# The JAX reference of each cache: einsum for the dense model, the Pallas
# kernels in interpret mode for the latent one (each JAX run compiles
# prefill and decode, ~3 s at these sizes); both port backends are held to
# it, so every arch meets both JAX paths and every port path meets JAX.
JAX_BACKEND = {"dense": "einsum", "latent": "pallas"}
_LOGITS = {}


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("kind", sorted(RATIOS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_jax(arch, kind, backend):
    """The port's einsum and kernel backends (the plain versions on the
    CPU) against JAX's einsum (dense) or its Pallas kernels in interpret
    mode (latent), one JAX run per config: ring wrap on the local layers,
    the window masks, per-kind theta."""
    jb = JAX_BACKEND[kind]
    cfg, params, _, pp = _model(arch, kind, jb)
    if (arch, kind) not in _LOGITS:
        _LOGITS[arch, kind] = _prefill_decode(JAX_STEPS, cfg, params,
                                              lambda a: jnp.asarray(a, jnp.int32))
    pcfg = dataclasses.replace(_model(arch, kind)[2], attn_backend=backend)
    got = _prefill_decode(T, pcfg, pp, torch.as_tensor)
    np.testing.assert_allclose(got, _LOGITS[arch, kind], **LOGITS)


def _prompts(vocab):
    """Four prompts, two past the window, one motif repeated for the
    n-gram draft."""
    rng = np.random.default_rng(7)
    motif = rng.integers(0, vocab, 6)
    return [rng.integers(0, vocab, 27), np.tile(motif, 4), rng.integers(0, vocab, 9),
            rng.integers(0, vocab, 18)]


def _serve(eng, prompts, port=True):
    R = Request if port else JRequest
    for i, p in enumerate(prompts):
        eng.submit(R(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=8))
    done = eng.run()
    eng.close()
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}


def _jax_streams(arch, kind):
    """The JAX sync engine's greedy streams, once per config."""
    if (arch, kind) not in _STREAMS:
        cfg, params, _, _ = _model(arch, kind)
        _STREAMS[arch, kind] = _serve(JEngine(cfg, params, **ENGINE),
                                      _prompts(cfg.vocab_size), port=False)
    return _STREAMS[arch, kind]


VARIANTS = {"sync": {}, "ngram3": dict(spec_depth=3, draft="ngram"),
            "overlap_continuous": dict(overlap=True, continuous=True, pipeline_depth=2),
            "paged": dict(cache_layout="paged", page_size=8)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", sorted(RATIOS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, kind, variant):
    """Greedy streams of the port's engine equal the JAX engine's, token for
    token; the paged pool on minicpm (full-length rings) only, and on the
    local families it is refused with the JAX engine's message."""
    cfg, params, pcfg, pp = _model(arch, kind)
    flags = VARIANTS[variant]
    if variant == "paged" and arch != "minicpm-2b":
        with pytest.raises(ValueError, match="needs full-length rings") as mine:
            Engine(pcfg, pp, device="cpu", **ENGINE, **flags)
        with pytest.raises(ValueError, match="needs full-length rings") as theirs:
            JEngine(cfg, params, **ENGINE, **flags)
        assert str(mine.value) == str(theirs.value)
        return
    want = _jax_streams(arch, kind)
    got = _serve(Engine(pcfg, pp, device="cpu", **ENGINE, **flags), _prompts(cfg.vocab_size))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_compress_recalkv_matches_jax(arch):
    """``calibrate`` + ``compress("recalkv", keep_ratio=0.5)`` of the dense
    smoke model (``scan_layers=False``): the same compressed config and
    ranks as JAX's, prefill and decode logits within 1e-4."""
    cfg, _, pcfg, pp = _model(arch, "dense")
    cfg = dataclasses.replace(cfg, scan_layers=False)
    pcfg = dataclasses.replace(pcfg, scan_layers=False)
    params = jax.tree.map(jnp.asarray, params_to_jax(pcfg, pp))   # the same weights, unrolled
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
    np.testing.assert_allclose(
        _prefill_decode(T, got.cfg, got.params, torch.as_tensor, steps=1),
        _prefill_decode(JAX_STEPS, want.cfg, want.params,
                        lambda a: jnp.asarray(a, jnp.int32), steps=1), **LOGITS)
