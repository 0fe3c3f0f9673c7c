"""The port's serving path against the JAX package: Engine streams, the
sampler's filters, artifacts saved by JAX, and the port's import and
device rules.

Float32 (TF32 off).  Streams are compared token for token; filtered
logits and prefill logits with the tolerances stated at each test.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CompressionArtifact, save_artifact
from repro.configs import get_config
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving.sampler import filtered_logits as jax_filtered_logits
from repro_torch.api import load_artifact
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import init_params, params_from_jax
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.sampler import filtered_logits

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(dtype=jnp.float32):
    return dataclasses.replace(get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5),
                               dtype=dtype)


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return cfg, params, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                              device="cpu")


def _serve(engine, prompts, max_new=6, sampling=None):
    R = Request if isinstance(engine, Engine) else JRequest
    for i, pr in enumerate(prompts):
        engine.submit(R(uid=i, prompt=pr.copy(), max_new_tokens=max_new,
                        sampling=sampling))
    return {r.uid: [int(t) for t in r.out_tokens] for r in engine.run()}


MIXED_KW = dict(max_slots=2, max_len=40, sync_every=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def mixed(model):
    """Five prompts of mixed lengths and the JAX Engine's streams for them
    (one JAX run, shared by both port backends)."""
    cfg, params, _, _ = model
    g = np.random.default_rng(3)
    prompts = [g.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 7, 12, 3)]
    return prompts, _serve(JEngine(cfg, params, **MIXED_KW), prompts)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_engine_streams_match_jax_engine(model, mixed, backend):
    """Mixed prompt lengths, a prompt longer than prefill_chunk (streamed
    through the ingest buffer), five requests on two slots (freed slots
    are reused), a sync_every that does not divide the work."""
    _, _, pcfg, pp = model
    prompts, want = mixed
    eng = Engine(pcfg, pp, backend=backend, device="cpu", **MIXED_KW)
    got = _serve(eng, prompts)
    assert got == want
    m = eng.metrics()
    assert m["tokens"] == 30 and m["backend"] == backend and m["host_syncs"] > 0


def test_engine_ring_cap_stop_matches_jax(model):
    """A prompt of max_len - 1 tokens chunked through the ingest path:
    generation stops where the next write would wrap the ring."""
    cfg, params, pcfg, pp = model
    pr = [np.random.default_rng(4).integers(0, cfg.vocab_size, 23).astype(np.int32)]
    kw = dict(max_slots=2, max_len=24, sync_every=3, prefill_chunk=5)
    want = _serve(JEngine(cfg, params, **kw), pr, max_new=8)
    assert _serve(Engine(pcfg, pp, device="cpu", **kw), pr, max_new=8) == want


def test_sampled_streams_reproducible(model):
    """Sampled rows draw with per-slot keys folded from (seed, uid): the
    same submissions give the same streams run to run."""
    cfg, _, pcfg, pp = model
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(3)]
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=11)
    kw = dict(max_slots=2, max_len=32, sync_every=4, device="cpu")
    a = _serve(Engine(pcfg, pp, **kw), prompts, sampling=sp)
    b = _serve(Engine(pcfg, pp, **kw), prompts, sampling=sp)
    assert a == b and all(len(v) == 6 for v in a.values())


def test_filtered_logits_matches_jax():
    """Distinct logits (no ties), mixed top-k / top-p per row; kept
    entries equal exactly, masked entries are NEG_INF on both sides.  The
    logit spread (28) drives the float32 cumulative probability to 1
    before the last sorted entry, so at top_p = 1 the tail entries kept
    depend on the softmax's exp and row sum: the CPU path computes both
    in XLA's CPU order, and the kept sets are equal."""
    rng = np.random.default_rng(0)
    logits = rng.permutation(4 * 50).reshape(4, 50).astype(np.float32) * np.float32(0.14)
    top_k = np.array([0, 5, 0, 12], np.int32)
    top_p = np.array([1.0, 1.0, 0.6, 0.3], np.float32)
    want = np.asarray(jax_filtered_logits(jnp.asarray(logits), jnp.asarray(top_k),
                                          jnp.asarray(top_p)))
    got = filtered_logits(torch.from_numpy(logits), torch.from_numpy(top_k),
                          torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_jax_saved_artifact_loads_and_prefills_equal(tmp_path):
    """save_artifact (JAX) -> load_artifact (port): same config, same
    weights bit for bit in f32 and bf16, and equal prefill logits in f32
    (atol 1e-4)."""
    cfg = _cfg()
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    save_artifact(CompressionArtifact(cfg, params, {"method": "recalkv"}),
                  str(tmp_path / "f32"))
    art = load_artifact(str(tmp_path / "f32"), device="cpu")
    assert art.method == "recalkv" and art.cfg.to_dict() == cfg.to_dict()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10))
    lens = np.array([10, 7])
    want, _ = JT.prefill(cfg, params, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(lens, jnp.int32), 16)
    got, _ = T.prefill(art.cfg, art.params, torch.as_tensor(toks),
                       torch.as_tensor(lens), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)

    bcfg = _cfg(jnp.bfloat16)
    bparams = JT.init_params(bcfg, jax.random.PRNGKey(1))
    save_artifact(CompressionArtifact(bcfg, bparams), str(tmp_path / "bf16"))
    bart = load_artifact(str(tmp_path / "bf16"), device="cpu")
    assert bart.params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bart.params["embed"].float().numpy(),
                                  np.asarray(bparams["embed"], np.float32))
    wq = np.asarray(bparams["blocks"][0]["attn"]["wq"], np.float32)
    for i, layer in enumerate(bart.params["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].float().numpy(), wq[i])
    eng = Engine.from_artifact(str(tmp_path / "f32"), max_slots=2, max_len=24,
                               device="cpu")
    assert len(_serve(eng, [toks[0].astype(np.int32)], max_new=3)[0]) == 3


def test_port_imports_no_jax_and_no_repro():
    """Every module of repro_torch — the compression subpackages (core,
    data, api, models.compress, quant.hadamard) among them — and
    chip_smoke import with ``jax`` and ``repro`` blocked on sys.meta_path."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                for root in ("jax", "jaxlib", "repro"):
                    if name == root or name.startswith(root + "."):
                        raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                      "repro_torch.")]
        for m in mods + ["chip_smoke"]:
            importlib.import_module(m)
        bad = [m for m in sys.modules if m in ("jax", "repro")
               or m.startswith(("jax.", "repro."))]
        assert not bad, bad
        new = {"repro_torch.core.pipeline", "repro_torch.core.svd",
               "repro_torch.core.reorder", "repro_torch.data.synthetic",
               "repro_torch.api.strategies", "repro_torch.api.facade",
               "repro_torch.models.compress", "repro_torch.quant.hadamard"}
        assert new <= set(mods), new - set(mods)
        import tempfile, torch
        if not torch.cuda.is_available():      # the new entry points default to cuda
            from repro_torch import api
            from repro_torch.configs import get_config
            from repro_torch.models.weights import init_params
            def raises_cuda(call):
                try:
                    call()
                except RuntimeError as e:
                    assert "cuda" in str(e)
                    return
                raise AssertionError("no error without a GPU")
            cfg = get_config("qwen3-4b", smoke=True)          # dense
            raises_cuda(lambda: init_params(cfg, torch.Generator()))
            pp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            with tempfile.TemporaryDirectory() as d:
                api.compress(cfg, pp, "grouped-svd").save(d)
                raises_cuda(lambda: api.load_artifact(d))
                raises_cuda(lambda: api.serve(d, max_slots=1, max_len=8))
        print(len(mods))
    """)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(REPO, "src"), REPO])}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 44


def test_default_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = ModelConfig.from_dict(_cfg().to_dict())
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_decode_cache(cfg, 1, 8)
    pp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, pp, max_slots=1, max_len=8)
