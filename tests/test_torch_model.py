"""The port's config, weights bridge, attention layers and transformer
against the JAX package, on the same numpy-seeded inputs.

Float32 with TF32 off.  Tolerances: module outputs atol = rtol = 1e-5;
logits atol = 1e-4 (36 reductions deep at smoke size); greedy streams
equal token for token.  The JAX side runs ``attn_backend="pallas"`` in
interpret mode (``ops.default_interpret``), as its own tests do.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import kv_cache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ReCalKVRuntime as JRuntime
from repro_torch.configs import get_config as pt_get_config
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
MOD = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=0)
# The JAX reference jitted as its Engine runs it (cfg and max_len static):
# one compile per case instead of an eager dispatch per op and layer.
JAX_JIT = types.SimpleNamespace(
    prefill=jax.jit(JT.prefill, static_argnums=(0, 4)),
    decode_step=jax.jit(JT.decode_step, static_argnums=(0,)))


def _jax_cfg(backend="einsum", group_size=None, scan=True):
    cfg = get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5)
    if group_size is not None:
        rt = cfg.recalkv
        cfg = dataclasses.replace(cfg, recalkv=JRuntime(
            rank_k=rt.rank_k, rank_v=rt.rank_v, group_size=group_size))
    return dataclasses.replace(cfg, dtype=jnp.float32, attn_backend=backend,
                               scan_layers=scan)


def _jax_params(cfg, seed=0):
    """JAX init with the zero norm scales perturbed, so q_norm / k_norm
    and the layer norms are exercised."""
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def bump(path, x):
        name = getattr(path[-1], "key", "")
        if name in ("q_norm", "k_norm", "ln1", "ln2", "final_norm"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(bump, params)


def _port(cfg, params):
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")


def test_config_round_trip_and_registry():
    jcfg = get_config("qwen3-4b", recalkv_ratio=0.5)
    pcfg = ModelConfig.from_dict(jcfg.to_dict())
    assert pcfg.dtype == torch.bfloat16 and pcfg.attn_backend == "einsum"
    assert pcfg.to_dict() == jcfg.to_dict()
    assert ModelConfig.from_dict(pcfg.to_dict()) == pcfg
    kern = ModelConfig.from_dict(dataclasses.replace(
        jcfg, attn_backend="pallas").to_dict())
    assert kern.attn_backend == "kernel"
    assert pt_get_config("qwen3-4b", recalkv_ratio=0.5).to_dict() == jcfg.to_dict()
    assert (pt_get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5).to_dict()
            == get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5).to_dict())
    rt = pcfg.recalkv
    assert (rt.rank_k, rt.rank_v, rt.num_groups(8)) == (256, 256, 2)


def test_params_from_jax_stacked_and_unrolled_agree():
    """scan_layers=True (stacked blocks) and False (unrolled prefix) trees
    of the same weights land on identical per-layer params."""
    cfg = _jax_cfg()
    stacked = _jax_params(cfg)
    unrolled = dict(stacked)
    unrolled["prefix"] = tuple(
        jax.tree.map(lambda a, i=i: a[i], stacked["blocks"][0])
        for i in range(cfg.num_layers))
    unrolled["blocks"] = ()
    a = _port(cfg, stacked)[1]
    b = _port(dataclasses.replace(cfg, scan_layers=False), unrolled)[1]
    assert len(a["layers"]) == cfg.num_layers
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves(b)
    for (path, x), y in zip(flat_a, flat_b):
        assert torch.equal(x, y), path
    assert a["layers"][1]["attn"]["k_norm"].dtype == torch.float32


def test_self_attention_latent_matches_jax():
    cfg = _jax_cfg()
    params = _jax_params(cfg)
    pcfg, pp = _port(cfg, params)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    p0 = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
    y, (zk, zv) = JL.self_attention_latent(p0, jnp.asarray(x), cfg,
                                           jnp.asarray(pos), None)
    yt, (zkt, zvt) = L.self_attention_latent(pp["layers"][0]["attn"],
                                             torch.from_numpy(x), pcfg,
                                             torch.from_numpy(pos.copy()), None)
    for a, b in ((y, yt), (zk, zkt), (zv, zvt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **MOD)


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_decode_attn_latent_matches_jax(backend):
    cfg = _jax_cfg(backend)
    params = _jax_params(cfg)
    pcfg, pp = _port(cfg, params)
    rng = np.random.default_rng(2)
    B, Lr = 2, 20
    G, r = cfg.recalkv.num_groups(cfg.num_kv_heads), cfg.recalkv.rank_k
    pos = np.stack([np.arange(Lr), np.where(np.arange(Lr) < 9, np.arange(Lr), -1)])
    cache = {"zk": rng.standard_normal((B, Lr, G, r)).astype(np.float32),
             "zv": rng.standard_normal((B, Lr, G, r)).astype(np.float32),
             "pos": pos}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cur = np.array([Lr, 9])
    p0 = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
    y, upd = JKC.decode_attn_latent(p0, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in cache.items()},
                                    cfg, jnp.asarray(cur), None)
    yt, updt = KC.decode_attn_latent(pp["layers"][0]["attn"], torch.from_numpy(x),
                                     {k: torch.from_numpy(v) for k, v in cache.items()},
                                     pcfg, torch.from_numpy(cur), None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **MOD)
    for k in ("zk", "zv", "pos"):
        np.testing.assert_allclose(updt[k].numpy(), np.asarray(upd[k]), **MOD)


def _prefill_decode(mod, cfg, params, toks, lens, max_len, steps, conv):
    logits, caches = mod.prefill(cfg, params, conv(toks), conv(lens), max_len)
    outs = [np.asarray(logits)]
    cur, tok = lens.copy(), np.asarray(logits).argmax(-1)
    for _ in range(steps):
        logits, caches = mod.decode_step(cfg, params, caches, conv(tok), conv(cur))
        outs.append(np.asarray(logits))
        tok, cur = np.asarray(logits).argmax(-1), cur + 1
    return outs


PREFILL_CASES = {
    # name: (jax backend, group_size override)
    "einsum": ("einsum", None),
    "kernel": ("pallas", None),
    "einsum_groups2": ("einsum", 1),
    "kernel_groups2": ("pallas", 1),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_decode_logits_match_jax(case):
    """prefill + 4 decode steps, ring length 37 (no tile multiple).  The
    smoke model has G = 1 at group_size 2; group_size 1 gives G = 2."""
    backend, gs = PREFILL_CASES[case]
    cfg = _jax_cfg(backend, group_size=gs)
    params = _jax_params(cfg, seed=3)
    pcfg, pp = _port(cfg, params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    lens = np.array([9, 6])
    want = _prefill_decode(JAX_JIT, cfg, params, toks, lens, 37, 4,
                           lambda a: jnp.asarray(a, jnp.int32))
    got = _prefill_decode(T, pcfg, pp, toks, lens, 37, 4, torch.as_tensor)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, err_msg=f"{case} step {i}", **LOGITS)


def test_prefill_wraps_ring_like_jax():
    """A prompt longer than the ring wraps per row, last write wins, and
    padded columns never write (write_prefill / prefill_pos)."""
    rng = np.random.default_rng(6)
    vals = rng.standard_normal((3, 11, 2)).astype(np.float32)
    lens = np.array([11, 4, 8])
    empty = np.zeros((3, 5, 2), np.float32)
    want = JKC.write_prefill(jnp.asarray(empty), jnp.asarray(vals), jnp.asarray(lens))
    got = KC.write_prefill(torch.from_numpy(empty), torch.from_numpy(vals),
                           torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        KC.prefill_pos(torch.from_numpy(lens), 11, 5).numpy(),
        np.asarray(JKC.prefill_pos(jnp.asarray(lens), 11, 5)))


def test_greedy_decode_loop_stream_matches_jax():
    cfg = _jax_cfg()
    params = _jax_params(cfg, seed=7)
    pcfg, pp = _port(cfg, params)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 7))
    lens = np.array([7, 5])
    logits, caches = JT.prefill(cfg, params, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(lens, jnp.int32), 32)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    _, _, _, want = JT.decode_loop(cfg, params, caches, first,
                                   jnp.asarray(lens, jnp.int32), 10)
    logits_t, caches_t = T.prefill(pcfg, pp, torch.as_tensor(toks),
                                   torch.as_tensor(lens), 32)
    _, _, _, got = T.decode_loop(pcfg, pp, caches_t, logits_t.argmax(-1),
                                 torch.as_tensor(lens), 10)
    assert got.tolist() == np.asarray(want).tolist()
