"""The port's threefry PRNG and sampler against ``jax.random`` and the JAX
sampler, and sampled Engine streams against the JAX engine's.

Keys, split keys, random bits and uniforms are compared bit for bit; the
Gumbel noise within atol 2e-6 / rtol 1e-6 (the two ``log`` implementations
round differently in the last bits: ~5e-7 at most); categorical draws and
token streams token for token.  Float32, TF32 off.
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
from repro.serving import sampler as JS
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving import prng as P
from repro_torch.serving import sampler as S

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
TINY = float(np.finfo(np.float32).tiny)
SEEDS_UIDS = [(0, 0), (0, 7), (11, 1), (2 ** 31 + 5, 123456), (-3, 2)]


def _key(seed, uid):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), uid),
            P.fold_in(P.prng_key(seed), uid))


def _i64(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed,uid", SEEDS_UIDS)
def test_keys_fold_in_and_split_bit_equal(seed, uid):
    assert (_i64(jax.random.PRNGKey(seed)) == P.prng_key(seed).numpy()).all()
    jk, tk = _key(seed, uid)
    assert (_i64(jk) == tk.numpy()).all()
    assert (_i64(jax.random.split(jk, 2)) == P.split(tk).numpy()).all()
    np.testing.assert_array_equal(SamplingParams(seed=seed).slot_key(uid),
                                  JS.SamplingParams(seed=seed).slot_key(uid))


@pytest.mark.parametrize("seed,uid", SEEDS_UIDS)
def test_bits_uniform_gumbel_and_draws_match(seed, uid):
    jk, tk = _key(seed, uid)
    assert (_i64(jax.random.bits(jk, (37,), jnp.uint32))
            == P.random_bits(tk, 37).numpy()).all()
    np.testing.assert_array_equal(
        P.uniform(tk, 1000, TINY).numpy(),
        np.asarray(jax.random.uniform(jk, (1000,), minval=TINY)))
    np.testing.assert_allclose(
        P.gumbel(tk, 1000).numpy(), np.asarray(jax.random.gumbel(jk, (1000,))),
        atol=2e-6, rtol=1e-6)
    rows = np.random.default_rng(uid % 97).standard_normal((6, 300)).astype(np.float32)
    rows[1, ::2] = -1e30                       # masked entries, as filtered rows
    keys = jax.random.split(jk, 6)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(rows)))
    got = P.categorical(torch.from_numpy(_i64(keys)), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_blocked_cumsum_is_xla_cpu_order():
    """jnp.cumsum on the CPU: 16-wide blocks and the recursive scan of
    their totals, bit for bit, at lengths up to the full vocabulary."""
    rng = np.random.default_rng(0)
    for n in (5, 16, 17, 50, 257, 4099, 151936):
        x = (rng.random((2, n)) * rng.choice([1e-3, 1.0, 1e3], (2, n))).astype(np.float32)
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
        np.testing.assert_array_equal(S.blocked_cumsum(torch.from_numpy(x)).numpy(),
                                      want, err_msg=f"n={n}")


@pytest.mark.parametrize("lo,hi", [(-88.0, 0.0), (-1e30, -88.0), (-1e-2, 1e-2),
                                   (0.0, 88.0)])
def test_xla_cpu_exp_matches_jnp_exp(lo, hi):
    """XLA's CPU float32 exp (Cephes reduction, fused degree-5 polynomial,
    flushed subnormals), bit for bit on a million-point sweep."""
    x = np.linspace(lo, hi, 1_000_001, dtype=np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(S.xla_cpu_exp(torch.from_numpy(x)).numpy(), want)


def test_xla_cpu_sum_is_xla_cpu_order():
    """jnp.sum on the CPU: 32-wide windows, zero-padded evenly on both
    sides, summed recursively, bit for bit up to the full vocabulary."""
    rng = np.random.default_rng(4)
    for n in (5, 32, 33, 50, 1000, 4099, 151936):
        x = (rng.random((3, n)) * np.exp(rng.normal(size=(3, n)))).astype(np.float32)
        want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=-1))(jnp.asarray(x)))
        np.testing.assert_array_equal(S.xla_cpu_sum(torch.from_numpy(x)).numpy(), want,
                                      err_msg=f"n={n}")


def test_sample_tokens_matches_jax_on_mixed_rows():
    """Greedy, sub-floor temperature, top-k, top-p and unfiltered rows in
    one batch, with per-row split keys."""
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((6, 257))).astype(np.float32)
    temp = np.array([0.0, 1e-8, 0.8, 1.0, 0.7, 1.3], np.float32)
    top_k = np.array([0, 0, 20, 0, 5, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.5, 1.0, 1.0], np.float32)
    keys = np.stack([JS.SamplingParams(seed=3).slot_key(u) for u in range(6)])
    for _ in range(3):                       # three steps of the key chain
        jks = JS.split_keys(jnp.asarray(keys))
        want = np.asarray(JS.sample_tokens(jnp.asarray(logits), jnp.asarray(temp),
                                           jnp.asarray(top_k), jnp.asarray(top_p),
                                           jks[:, 1]))
        tks = S.split_keys(torch.from_numpy(_i64(keys)))
        np.testing.assert_array_equal(tks.numpy(), _i64(jks))
        got = S.sample_tokens(torch.from_numpy(logits), torch.from_numpy(temp),
                              torch.from_numpy(top_k), torch.from_numpy(top_p),
                              tks[:, 1])
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[0] == logits[0].argmax() and got[1] == logits[1].argmax()
        keys = np.asarray(jks[:, 0])
        logits = np.roll(logits, 7, axis=1)
    # an all-greedy batch draws nothing: the keys are not even read
    g = S.sample_tokens(torch.from_numpy(logits), torch.zeros(6), torch.zeros(6),
                        torch.ones(6), None)
    np.testing.assert_array_equal(g.numpy(), logits.argmax(-1))


SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
MIXED_KW = dict(max_slots=2, max_len=40, sync_every=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def served():
    """The JAX engine's sampled streams for five mixed-length prompts (one
    longer than prefill_chunk), and the port's model."""
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5),
                              dtype=jnp.float32)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    g = np.random.default_rng(3)
    prompts = [g.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 7, 12, 3)]
    eng = JEngine(cfg, params, **MIXED_KW)
    for i, pr in enumerate(prompts):
        eng.submit(JRequest(uid=i, prompt=pr.copy(), max_new_tokens=6,
                            sampling=JS.SamplingParams(**SAMPLED)))
    want = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
    return pcfg, pp, prompts, want


def _serve(eng, prompts):
    for i, pr in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=pr.copy(), max_new_tokens=6,
                           sampling=SamplingParams(**SAMPLED)))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_sampled_engine_streams_match_jax_engine(served, backend):
    pcfg, pp, prompts, want = served
    got = _serve(Engine(pcfg, pp, backend=backend, device="cpu", **MIXED_KW), prompts)
    assert got == want and all(len(v) == 6 for v in got.values())


@pytest.mark.parametrize("kw", [dict(sync_every=1, prefill_chunk=None),
                                dict(sync_every=3, prefill_chunk=4),
                                dict(sync_every=7, prefill_chunk=16)])
def test_sampled_streams_invariant_to_window_and_chunk(served, kw):
    """Keys advance once per emitted token: neither the window length nor
    how the prompt is chunked changes a request's sampled stream."""
    pcfg, pp, prompts, want = served
    got = _serve(Engine(pcfg, pp, device="cpu", max_slots=2, max_len=40, **kw), prompts)
    assert got == want
