"""The port's speculative-decoding verify path against the JAX package: the
multi-query glue, K5's and K6's plain versions against the Pallas kernels
in interpret mode, ``verify_step`` logits on float and int8 rings, and
partial commits.

Float32 with TF32 off.  Tolerances: masks and layouts exactly equal;
kernel outputs atol = rtol = 1e-5 (f32 summation order differs); logits
atol 1e-4 (as the decode tests).
"""

import dataclasses
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.kernels.latent_decode import latent_decode_attention_mq as jax_k5
from repro.kernels.latent_decode_q import latent_decode_attention_mq_quant as jax_k6
from repro.models import transformer as JT
from repro.quant import quantize as jquant
from repro_torch.kernels import latent_decode as K1
from repro_torch.kernels import latent_decode_q as KQ
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as KC
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=0)
THETA = 1e4
JAX_JIT = types.SimpleNamespace(
    prefill=jax.jit(JT.prefill, static_argnums=(0, 4)),
    decode_step=jax.jit(JT.decode_step, static_argnums=(0,)),
    verify_step=jax.jit(JT.verify_step, static_argnums=(0,)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_verify_bias_and_query_layout_match_jax():
    rng = np.random.default_rng(0)
    B, S, nq, H, G, dh = 3, 9, 4, 8, 2, 4
    pos = np.stack([np.arange(S), np.where(np.arange(S) < 5, np.arange(S), -1),
                    np.full(S, -1)])
    cur = np.array([S, 5, 0])
    pos_q = cur[:, None] + np.arange(nq)
    feed = rng.random((B, nq)) > 0.3
    pos_ext = np.concatenate([pos, pos_q], axis=1)
    for window in (None, 3):
        want = jops.verify_bias(jnp.asarray(pos_ext), jnp.asarray(pos_q),
                                jnp.asarray(feed), window, S)
        got = ops.verify_bias(_t(pos_ext), _t(pos_q), _t(feed), window, S)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = rng.standard_normal((B, nq, H, dh)).astype(np.float32)
    g = ops.group_queries_mq(_t(q), G)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jops.group_queries_mq(jnp.asarray(q), G)))
    np.testing.assert_array_equal(ops.ungroup_outputs_mq(g, nq).numpy(), q)


def _mq_inputs(seed, nq, B=2, S=13, G=2, s=2, qpk=2, dh=16, rk=8, rv=12,
               window=None, drop=False):
    """Ring + nq verify columns: K5's operands both as the Pallas kernel
    takes them (self columns appended to the ring) and as the port's
    (self columns as operands).  ``drop`` removes the last feed column of
    row 0."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos = np.stack([np.arange(S), np.where(np.arange(S) < 7, np.arange(S), -1)])
    cur = np.array([S, 7])
    pos_q = cur[:, None] + np.arange(nq)
    feed = np.ones((B, nq), bool)
    if drop:
        feed[0, -1] = False
    pos_ext = np.concatenate([pos, pos_q], axis=1)
    half = dh // 2
    freq = THETA ** (-np.arange(half, dtype=np.float32) / half)
    ang = np.maximum(pos_ext, 0)[..., None].astype(np.float32) * freq
    bias = np.array(jops.verify_bias(jnp.asarray(pos_ext), jnp.asarray(pos_q),
                                     jnp.asarray(feed), window, S))
    return dict(q=f(B, G, nq * s * qpk, dh), zk=f(B, S + nq, G, rk),
                zv=f(B, S + nq, G, rv), r_k=f(G, rk, s * dh) / np.sqrt(rk),
                cos=np.cos(ang).astype(np.float32), sin=np.sin(ang).astype(np.float32),
                bias=bias, k_norm=0.3 * f(dh), S=S)


def _split_self(a, keys):
    """Ring-only operands and the self-column keyword operands."""
    S = a["S"]
    ring = {k: _t(a[k][:, :S]) for k in keys}
    selfs = {k: _t(a[k][:, S:]) for k in keys}
    return ring, selfs


MQ_CASES = {
    # name: (nq, window, drop a feed column, dh)
    "nq1": (1, None, False, 16),
    "nq3_drop": (3, None, True, 16),
    "nq3_window": (3, 5, False, 16),
    "nq3_window_dh256": (3, 5, False, 256),   # gemma3-12b's head width
    "nq3_window_dh80": (3, 5, False, 80),     # h2o-danube-1.8b's
    "nq3_drop_qpk16": (3, None, True, 16, 16),   # qwen3-moe's 16 q heads a kv head
}


@pytest.mark.parametrize("case", sorted(MQ_CASES))
def test_k5_plain_matches_pallas_interpret(case):
    """S + nq = 14 or 16 columns at block 8 (a tail tile), a causal self
    block, a dropped feed column and a window."""
    nq, window, drop, dh, *qpk = MQ_CASES[case]
    a = _mq_inputs(zlib.crc32(case.encode()), nq, window=window, drop=drop, dh=dh,
                   qpk=qpk[0] if qpk else 2)
    scale = a["q"].shape[-1] ** -0.5
    want = np.asarray(jax_k5(*[jnp.asarray(a[k]) for k in ("q", "zk", "zv", "r_k", "cos",
                                                           "sin", "bias")],
                             scale=scale, block_s=8, interpret=True,
                             k_norm=jnp.asarray(a["k_norm"])))
    ring, selfs = _split_self(a, ("zk", "zv", "cos", "sin"))
    kw = dict(scale=scale, k_norm=_t(a["k_norm"]))
    got = K1.latent_decode_attention_mq(
        _t(a["q"]), ring["zk"], ring["zv"], _t(a["r_k"]), ring["cos"], ring["sin"],
        _t(a["bias"]), self_zk=selfs["zk"], self_zv=selfs["zv"], self_cos=selfs["cos"],
        self_sin=selfs["sin"], **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    appended = K1.latent_decode_attention_mq(
        *[_t(a[k]) for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")], **kw)
    np.testing.assert_allclose(appended.numpy(), want, **TOL)
    if nq == 1:
        # one query is K1 with its self column at bias 0
        one = K1.latent_decode_attention(
            _t(a["q"]), ring["zk"], ring["zv"], _t(a["r_k"]), ring["cos"], ring["sin"],
            _t(a["bias"][:, 0, :a["S"]]), self_zk=selfs["zk"][:, 0],
            self_zv=selfs["zv"][:, 0], self_cos=selfs["cos"][:, 0],
            self_sin=selfs["sin"][:, 0], **kw)
        np.testing.assert_allclose(one.numpy(), got, **TOL)


@pytest.mark.parametrize("case", sorted(MQ_CASES))
def test_k6_plain_matches_pallas_interpret(case):
    """K5's cases over int8 latents; at nq = 1 it equals K3."""
    nq, window, drop, dh, *qpk = MQ_CASES[case]
    a = _mq_inputs(zlib.crc32(case.encode()) + 1, nq, window=window, drop=drop, dh=dh,
                   qpk=qpk[0] if qpk else 2)
    for k in ("zk", "zv"):
        qv, sc = jquant(jnp.asarray(a[k]), 8)
        a[k + "_q"], a[k + "_s"] = np.asarray(qv), np.asarray(sc)[..., 0]
    scale = a["q"].shape[-1] ** -0.5
    order = ("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin", "bias")
    want = np.asarray(jax_k6(*[jnp.asarray(a[k]) for k in order], scale=scale,
                             block_s=8, interpret=True, k_norm=jnp.asarray(a["k_norm"])))
    ring, selfs = _split_self(a, ("zk_q", "zk_s", "zv_q", "zv_s", "cos", "sin"))
    kw = dict(scale=scale, k_norm=_t(a["k_norm"]))
    got = KQ.latent_decode_attention_mq_quant(
        _t(a["q"]), ring["zk_q"], ring["zk_s"], ring["zv_q"], ring["zv_s"], _t(a["r_k"]),
        ring["cos"], ring["sin"], _t(a["bias"]), self_zk_q=selfs["zk_q"],
        self_zk_s=selfs["zk_s"], self_zv_q=selfs["zv_q"], self_zv_s=selfs["zv_s"],
        self_cos=selfs["cos"], self_sin=selfs["sin"], **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if nq == 1:
        one = KQ.latent_decode_attention_quant(
            _t(a["q"]), ring["zk_q"], ring["zk_s"], ring["zv_q"], ring["zv_s"],
            _t(a["r_k"]), ring["cos"], ring["sin"], _t(a["bias"][:, 0, :a["S"]]),
            self_zk_q=selfs["zk_q"][:, 0], self_zk_s=selfs["zk_s"][:, 0],
            self_zv_q=selfs["zv_q"][:, 0], self_zv_s=selfs["zv_s"][:, 0],
            self_cos=selfs["cos"][:, 0], self_sin=selfs["sin"][:, 0], **kw)
        np.testing.assert_allclose(one.numpy(), got, **TOL)


def test_k5_dead_row_is_exact_zero():
    """A batch row masked for every query (an idle slot) returns exact 0."""
    a = _mq_inputs(3, 3)
    a["bias"][1] = -1e30
    out = K1.latent_decode_attention_mq(
        *[_t(a[k]) for k in ("q", "zk", "zv", "r_k", "cos", "sin", "bias")],
        scale=0.25).numpy()
    assert (out[1] == 0).all() and np.isfinite(out).all()


def _model(bits=None, backend="einsum", seed=3):
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5),
                              dtype=jnp.float32, attn_backend=backend,
                              cache_quant_bits=bits)
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def bump(path, x):
        if getattr(path[-1], "key", "") in ("q_norm", "k_norm", "ln1", "ln2"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    params = jax.tree_util.tree_map_with_path(bump, params)
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return cfg, params, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                              device="cpu")


VERIFY_CASES = {
    # name: (cache_quant_bits, jax backend)
    "float_einsum": (None, "einsum"),
    "float_kernel": (None, "pallas"),
    "int8_einsum": (8, "einsum"),
    "int8_kernel": (8, "pallas"),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_verify_step_logits_match_jax(case):
    """Prefill, then one S = 4 verify step with a -1 pad and a masked
    column: logits and the deferred (B, S, ...) entries."""
    bits, backend = VERIFY_CASES[case]
    cfg, params, pcfg, pp = _model(bits, backend)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 6))
    lens = np.array([6, 4])
    fed = rng.integers(0, cfg.vocab_size, (2, 4))
    fed[1, 3] = -1
    mask = np.array([[True, True, True, False], [True, True, False, False]])
    _, jc = JAX_JIT.prefill(cfg, params, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(lens, jnp.int32), 37)
    want, jupd = JAX_JIT.verify_step(cfg, params, jc, jnp.asarray(fed, jnp.int32),
                                     jnp.asarray(lens, jnp.int32), jnp.asarray(mask))
    _, pc = T.prefill(pcfg, pp, _t(toks), _t(lens), 37)
    got, pupd = T.verify_step(pcfg, pp, pc, _t(fed), _t(lens), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    j0 = jax.tree.map(lambda a: a[0], jupd["blocks"][0]["self"])
    assert set(pupd[0]["self"]) == set(j0)
    np.testing.assert_array_equal(pupd[0]["self"]["pos"].numpy(), np.asarray(j0["pos"]))


@pytest.mark.parametrize("bits", [None, 8])
def test_partial_commit_equals_shorter_sequential(bits):
    """Committing an accepted prefix leaves the ring as decoding just
    those tokens would: the next step's logits agree."""
    _, _, pcfg, pp = _model(bits)
    rng = np.random.default_rng(8)
    toks = _t(rng.integers(0, pcfg.vocab_size, (2, 5)))
    lens = torch.tensor([5, 5])
    fed = _t(rng.integers(0, pcfg.vocab_size, (2, 4)))
    _, caches = T.prefill(pcfg, pp, toks, lens, 37)
    _, seq = T.prefill(pcfg, pp, toks, lens, 37)
    _, updates = T.verify_step(pcfg, pp, caches, fed, lens, torch.ones(2, 4, dtype=torch.bool))
    keep = torch.tensor([[True, True, False, False], [True, False, False, False]])
    T.commit_verify_writes(caches, updates, lens, keep)
    for j in range(2):
        T.decode_step(pcfg, pp, seq, fed[:, j], lens + j, keep[:, j])
    nxt = _t(rng.integers(0, pcfg.vocab_size, (2,)))
    cur = lens + keep.sum(1)
    a, _ = T.decode_step(pcfg, pp, caches, nxt, cur)
    b, _ = T.decode_step(pcfg, pp, seq, nxt, cur)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    for name, leaf in caches[0]["self"].items():
        torch.testing.assert_close(leaf, seq[0]["self"][name], atol=1e-5, rtol=1e-5)


def test_invalidate_positions_strikes_only_masked_rows():
    caches = [{"self": {"pos": torch.arange(10).repeat(2, 1)}} for _ in range(2)]
    KC.invalidate_positions(caches, torch.tensor([13, 4]), torch.tensor([True, False]))
    assert caches[1]["self"]["pos"][0, 3] == -1
    assert (caches[1]["self"]["pos"][1] == torch.arange(10)).all()


def test_new_wrappers_count_nothing_on_cpu_and_raise_elsewhere():
    """K3, K5 and K6 take their plain versions for CPU tensors without
    counting a launch, and raise for a device that has no kernel instead
    of falling back."""
    a = _mq_inputs(4, 2)
    for k in ("zk", "zv"):
        qv, sc = jquant(jnp.asarray(a[k]), 8)
        a[k + "_q"], a[k + "_s"] = np.asarray(qv), np.asarray(sc)[..., 0]
    f = ("q", "zk", "zv", "r_k", "cos", "sin", "bias")
    q8 = ("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin", "bias")
    one = ("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin")
    calls = [(K1.latent_decode_attention_mq, [_t(a[k]) for k in f]),
             (KQ.latent_decode_attention_mq_quant, [_t(a[k]) for k in q8]),
             (KQ.latent_decode_attention_quant,
              [_t(a[k]) for k in one] + [_t(a["bias"][:, 0])])]
    for fn, args in calls:
        before = fn.launches
        assert torch.isfinite(fn(*args, scale=0.25)).all()
        assert fn.launches == before
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*[t.to("meta") for t in args], scale=0.25)
