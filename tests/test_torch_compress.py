"""The port's compression (``core``, ``models.compress``, ``quant.hadamard``,
``data.synthetic`` and ``api``) against the JAX package, on numpy-seeded
inputs.

Float32 with TF32 off.  SVD column signs and the orthogonal freedom ALS
carries through are arbitrary, so factors are compared by product, never
entry by entry.  Tolerances: SVD products rtol 1e-4 of the product's
largest entry; CKA 1e-5; HSR groups
exactly (weights with planted head pairs, a clear margin); ALS error
traces rtol 1e-4, and monotone; fusion 1e-6; calibration covariances rtol
1e-5; compressed-model logits atol 1e-4 (``quantized-latent``'s factor
quantizer on JAX's own factors atol 1e-6; the whole strategy, whose
rounding does not commute with the factors' signs once a Hadamard
rotation mixes columns, atol 5e-2).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as JA
import repro.api.strategies as JS
from repro import checkpoint as jckpt
from repro.configs import get_config
from repro.core import calibrate as jcal
from repro.core import cka as jcka
from repro.core import fusion as jfus
from repro.core import pipeline as JP
from repro.core import reorder as jreo
from repro.core import svd as jsvd
from repro.data import synthetic as jsyn
from repro.models import compress as JC
from repro.models import transformer as JT
from repro.quant import hadamard as jhad
import repro_torch.api as A
import repro_torch.api.strategies as S
from repro_torch import checkpoint as ckpt
from repro_torch.core import calibrate as cal
from repro_torch.core import cka
from repro_torch.core import fusion as fus
from repro_torch.core import pipeline as P
from repro_torch.core import svd
from repro_torch.data import synthetic as syn
from repro_torch.models import compress as C
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.quant import hadamard as had
from repro_torch.serving import Request

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
LOGITS = dict(atol=1e-4, rtol=0)
SVD_FAMILY = ("recalkv", "recalkv-hsr", "recalkv-calib", "whitened-svd", "grouped-svd")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=msg)


def _product(got, want, rtol, msg=""):
    """A factor product within ``rtol`` of the JAX one, relative to the
    product's largest entry (entries near 0 carry the SVD's f32 noise)."""
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"{msg}: max |diff| / max |want| = {err:.3e} > {rtol}"


def _cov(rng, n=400, d=48):
    X = rng.standard_normal((n, d)) @ (np.eye(d) + 0.3 * rng.standard_normal((d, d)))
    return (X.T @ X).astype(np.float32), X.astype(np.float32)


def _planted(rng, d=48, Hq=16, Hkv=8, dh=8):
    """Dense attention weights whose kv heads come in similar pairs at
    scattered positions: HSR's pairs are clear of the rest."""
    mat = lambda m, n: (rng.standard_normal((m, n)) * m ** -0.5).astype(np.float32)
    base = [rng.standard_normal((d, dh)) for _ in range(Hkv // 2)]
    order = rng.permutation(Hkv)
    cols = [None] * Hkv
    for i, b in enumerate(base):
        for pos in order[2 * i:2 * i + 2]:
            cols[pos] = b + 0.15 * rng.standard_normal((d, dh))
    Wk = (np.concatenate(cols, 1) * d ** -0.5).astype(np.float32)
    pairs = {frozenset(order[2 * i:2 * i + 2].tolist()) for i in range(Hkv // 2)}
    return dict(W_q=mat(d, Hq * dh), W_k=Wk, W_v=mat(d, Hkv * dh),
                W_o=mat(Hq * dh, d), num_q_heads=Hq, num_kv_heads=Hkv), pairs


# -- core -------------------------------------------------------------------------


def test_svd_matches_jax():
    rng = np.random.default_rng(0)
    cov, _ = _cov(rng)
    W = rng.standard_normal((48, 32)).astype(np.float32)
    for name, jf, pf in (("truncated", jsvd.truncated_svd(jnp.asarray(W), 12),
                          svd.truncated_svd(_t(W), 12)),
                         ("whitened", jsvd.whitened_svd(jnp.asarray(W), jnp.asarray(cov), 12),
                          svd.whitened_svd(_t(W), _t(cov), 12))):
        _product(pf.L @ pf.R, jf.L @ jf.R, 1e-4, name)
        _close(svd.data_weighted_error(_t(W), pf, _t(cov)),
               jsvd.data_weighted_error(jnp.asarray(W), jf, jnp.asarray(cov)), 1e-4)
    groups = [[3, 0], [1, 2]]
    jg = jsvd.grouped_svd(jnp.asarray(W), groups, [6, 8], 4, cov=jnp.asarray(cov))
    pg = svd.grouped_svd(_t(W), groups, [6, 8], 4, cov=_t(cov))
    for a, b in zip(pg, jg):
        _product(a.L @ a.R, b.L @ b.R, 1e-4, "grouped")
    assert [svd.effective_rank_for_ratio(w, k) for w, k in ((512, .5), (40, .3), (8, .1))] \
        == [jsvd.effective_rank_for_ratio(w, k) for w, k in ((512, .5), (40, .3), (8, .1))]


def test_cka_matches_jax():
    rng = np.random.default_rng(1)
    cov, X = _cov(rng)
    W = rng.standard_normal((48, 32)).astype(np.float32)
    Y = rng.standard_normal((400, 5)).astype(np.float32)
    _close(cka.linear_cka(_t(X), _t(Y)), jcka.linear_cka(jnp.asarray(X), jnp.asarray(Y)),
           1e-5)
    mu = X.mean(0)
    cc = cov - X.shape[0] * np.outer(mu, mu)
    _close(cka.head_cka_from_cov(_t(W), _t(cc), 4),
           jcka.head_cka_from_cov(jnp.asarray(W), jnp.asarray(cc), 4), 1e-5, 1e-6)
    reps = rng.standard_normal((4, 50, 6)).astype(np.float32)
    _close(cka.head_cka_matrix(_t(reps)), jcka.head_cka_matrix(jnp.asarray(reps)),
           1e-5, 1e-6)


@pytest.mark.parametrize("group_size", [2, 4])
def test_hsr_groups_match_jax_on_planted_pairs(group_size):
    """The greedy grouping over each package's CKA is the same, and at
    group size 2 it finds the planted pairs."""
    rng = np.random.default_rng(2)
    w, pairs = _planted(rng)
    cov, X = _cov(rng)
    cc = cov - X.shape[0] * np.outer(X.mean(0), X.mean(0))
    jsim = np.asarray(jcka.head_cka_from_cov(jnp.asarray(w["W_k"]), jnp.asarray(cc), 8))
    psim = cka.head_cka_from_cov(_t(w["W_k"]), _t(cc), 8).double().numpy()
    want = jreo.greedy_group_heads(jsim, group_size)
    assert P._reorder.greedy_group_heads(psim, group_size) == want
    if group_size == 2:
        assert {frozenset(g) for g in want} == pairs


def test_calibration_matches_jax_and_is_monotone():
    rng = np.random.default_rng(3)
    cov, _ = _cov(rng)
    W = rng.standard_normal((48, 16)).astype(np.float32)
    jinit = jsvd.truncated_svd(jnp.asarray(W), 6)
    init = svd.LowRankFactors(L=_t(jinit.L), R=_t(jinit.R))
    want = jcal.calibrate_factors(jnp.asarray(W), jnp.asarray(cov), jinit, num_iters=8)
    got = cal.calibrate_factors(_t(W), _t(cov), init, num_iters=8)
    _close(np.array(got.errors), np.array(want.errors), 1e-4)
    assert all(b <= a * (1 + 1e-5) for a, b in zip(got.errors, got.errors[1:]))
    assert got.final_error < got.initial_error
    _product(got.factors.L @ got.factors.R, want.factors.L @ want.factors.R, 1e-4, "ALS")


def test_fusion_matches_jax():
    rng = np.random.default_rng(4)
    w, _ = _planted(rng)
    R_v = rng.standard_normal((4, 6, 16)).astype(np.float32)
    _close(fus.fuse_output_projection(_t(R_v), _t(w["W_o"]), 16, 8),
           jfus.fuse_output_projection(jnp.asarray(R_v), jnp.asarray(w["W_o"]), 16, 8),
           1e-6, 1e-6)
    perm = rng.permutation(8)
    got = fus.fold_head_permutation(*(_t(w[k]) for k in ("W_q", "W_k", "W_v", "W_o")),
                                    perm, 16, 8)
    want = jfus.fold_head_permutation(*(jnp.asarray(w[k]) for k in
                                        ("W_q", "W_k", "W_v", "W_o")), perm, 16, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(fus.inverse_permutation(perm),
                                  jfus.inverse_permutation(perm))


@pytest.mark.parametrize("use_hsr,use_calibration", [(True, True), (False, True),
                                                     (True, False)])
def test_compress_attention_layer_matches_jax(use_hsr, use_calibration):
    """Products L_k R_k and L_v R_v per group, L_v[g] W~_o[h] per query
    head, the data-weighted value error, and the permutation."""
    rng = np.random.default_rng(5)
    w, _ = _planted(rng)
    cov, X = _cov(rng)
    rc = dict(keep_ratio=0.5, group_size=2, use_hsr=use_hsr,
              use_calibration=use_calibration, use_fisher=False)
    jw = JP.AttnWeights(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                           for k, v in w.items()})
    pw = P.AttnWeights(**{k: _t(v) if isinstance(v, np.ndarray) else v
                          for k, v in w.items()})
    jst = JP.collect_stats(jnp.asarray(X))
    pst = P.collect_stats(_t(X))
    _close(pst.cov, jst.cov, 1e-5, 1e-3)
    want = JP.compress_attention_layer(jw, jst, JP.ReCalKVConfig(**rc), 8, 8)
    got = P.compress_attention_layer(pw, pst, P.ReCalKVConfig(**rc), 8, 8)
    assert got.perm == want.perm
    np.testing.assert_array_equal(_np(got.W_q), np.asarray(want.W_q))
    for g in range(4):
        _product(got.L_k[g] @ got.R_k[g], want.L_k[g] @ want.R_k[g], 1e-4, "keys")
    for h in range(16):
        g = (h // 2) // 2
        _product(got.L_v[g] @ got.W_o_fused[h], want.L_v[g] @ want.W_o_fused[h], 1e-4,
                 "values")
    if use_calibration:
        assert len(got.report["value_errors"]) == 4
        assert all(e[1] <= e[0] * (1 + 1e-5) for e in got.report["value_errors"])
    if use_hsr:
        assert got.report["cka_hsr"] >= got.report["cka_identity"]


def test_quant_hadamard_matches_jax():
    rng = np.random.default_rng(6)
    for shape in ((3, 64), (2, 5, 24)):
        x = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(had.rademacher_diag(shape[-1]),
                                      jhad.rademacher_diag(shape[-1]))
        _close(had.hadamard_transform(_t(x)), jhad.hadamard_transform(jnp.asarray(x)),
               1e-6, 1e-6)
        _close(had.hadamard_inverse(had.hadamard_transform(_t(x))), x, 1e-5, 1e-5)


def test_synthetic_batches_identical():
    for cfg in (dict(vocab_size=97, seq_len=64), dict(vocab_size=300, seq_len=160,
                                                      copy_frac=0.9)):
        for split, step in (("calib", 0), ("train", 3)):
            got = syn.batch(syn.DataConfig(**cfg), split, step, 3)
            want = jsyn.batch(jsyn.DataConfig(**cfg), split, step, 3)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


# -- models.compress and api --------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), dtype=jnp.float32,
                              scan_layers=False)
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    batches = [syn.batch(syn.DataConfig(vocab_size=cfg.vocab_size, seq_len=32), "calib",
                         i, 2) for i in range(2)]
    return cfg, params, pcfg, pp, batches


@pytest.fixture(scope="module")
def calibrations(dense):
    cfg, params, pcfg, pp, batches = dense
    return (JA.calibrate(cfg, params, [{"tokens": jnp.asarray(b["tokens"])}
                                       for b in batches]),
            A.calibrate(pcfg, pp, batches))


def test_capture_calibration_matches_jax(dense, calibrations):
    want, got = calibrations
    assert got.token_count == want.token_count == 128
    assert len(got.stats) == len(want.stats) == 3
    for a, b in zip(got.stats, want.stats):
        assert a.count == b.count
        _close(a.cov, b.cov, 1e-5, 1e-4)
        _close(a.mean, b.mean, 1e-5, 1e-6)
    assert C.attn_layer_indices(dense[2]) == JC.attn_layer_indices(dense[0])


JAX_STEPS = types.SimpleNamespace(prefill=jax.jit(JT.prefill, static_argnums=(0, 4)),
                                  decode_step=jax.jit(JT.decode_step, static_argnums=(0,)))


def _logits(mod, cfg, params, conv):
    """Prefill logits and one decode step's, B = 2 (``mod``: the port's
    transformer, or the JAX package's steps, jitted)."""
    toks = np.arange(22).reshape(2, 11) * 7 % cfg.vocab_size
    lens = np.array([11, 8])
    a, caches = mod.prefill(cfg, params, conv(toks), conv(lens), 16)
    b, _ = mod.decode_step(cfg, params, caches, conv(np.array([3, 5])), conv(lens))
    return np.stack([np.asarray(a), np.asarray(b)])


def _jconv(a):
    return jnp.asarray(a, jnp.int32)


@pytest.mark.parametrize("method", SVD_FAMILY)
def test_compress_model_logits_match_jax(dense, calibrations, method):
    cfg, params, pcfg, pp, _ = dense
    jcal_, pcal_ = calibrations
    want = JA.compress(cfg, params, JA.CompressionSpec(method,
                       rank_policy=JA.RankPolicy(keep_ratio=0.5)), jcal_)
    got = A.compress(pcfg, pp, A.CompressionSpec(method,
                     rank_policy=A.RankPolicy(keep_ratio=0.5)), pcal_)
    assert got.cfg.to_dict() == want.cfg.to_dict()
    np.testing.assert_allclose(_logits(T, got.cfg, got.params, torch.as_tensor),
                               _logits(JAX_STEPS, want.cfg, want.params, _jconv), **LOGITS)
    assert got.provenance["ranks_by_layer"] == want.provenance["ranks_by_layer"]


@pytest.mark.parametrize("hadamard", [False, True])
def test_quantized_latent_factor_quantizer_matches_jax(dense, calibrations, hadamard):
    """The factor quantizer on JAX's own factors equals JAX's."""
    cfg, params, pcfg, _, _ = dense
    base = JA.compress(cfg, params, "recalkv", calibrations[0])
    want = JS._quantize_latent_factors(base.params, bits=8, hadamard=hadamard)
    ccfg = ModelConfig.from_dict(base.cfg.to_dict())
    got = S._quantize_latent_factors(
        params_from_jax(ccfg, jax.tree.map(np.asarray, base.params), device="cpu"),
        bits=8, hadamard=hadamard)
    got = params_to_jax(ccfg, got)
    for i, layer in enumerate(want["prefix"]):
        for k in ("l_k", "r_k", "l_v", "wo_fused"):
            _close(got["prefix"][i]["attn"][k], layer["attn"][k], 0, 1e-6, k)


@pytest.mark.parametrize("hadamard", [False, True])
def test_quantized_latent_strategy_logits_near_jax(dense, calibrations, hadamard):
    cfg, params, pcfg, pp, _ = dense
    opts = {"base": "recalkv", "bits": 8, "hadamard": hadamard}
    want = JA.compress(cfg, params, JA.CompressionSpec("quantized-latent", options=opts),
                       calibrations[0])
    got = A.compress(pcfg, pp, A.CompressionSpec("quantized-latent", options=opts),
                     calibrations[1])
    assert got.provenance["bits"] == 8 and got.provenance["hadamard"] is hadamard
    np.testing.assert_allclose(_logits(T, got.cfg, got.params, torch.as_tensor),
                               _logits(JAX_STEPS, want.cfg, want.params, _jconv),
                               atol=5e-2, rtol=0)


def test_port_artifact_loads_in_jax_and_back(dense, calibrations, tmp_path):
    """The port writes, JAX loads (same logits); JAX writes, the port
    loads (the same params)."""
    cfg, params, pcfg, pp, _ = dense
    art = A.compress(pcfg, pp, A.CompressionSpec(
        "recalkv", rank_policy=A.RankPolicy(keep_ratio=0.5), backend="pallas"),
        calibrations[1])
    assert art.cfg.attn_backend == "kernel"
    A.save_artifact(art, str(tmp_path / "port"))
    jart = JA.load_artifact(str(tmp_path / "port"))
    assert jart.cfg.attn_backend == "pallas" and jart.method == "recalkv"
    assert jart.provenance["spec"]["backend"] == "pallas"
    ecfg = lambda c: dataclasses.replace(c, attn_backend="einsum")
    np.testing.assert_allclose(
        _logits(JAX_STEPS, ecfg(jart.cfg), jart.params, _jconv),
        _logits(T, ecfg(art.cfg), art.params, torch.as_tensor), **LOGITS)
    back = A.load_artifact(str(tmp_path / "port"), device="cpu")
    for a, b in zip(jax.tree.leaves(params_to_jax(back.cfg, back.params)),
                    jax.tree.leaves(params_to_jax(art.cfg, art.params))):
        np.testing.assert_array_equal(a, b)
    want = JA.compress(cfg, params, "recalkv", calibrations[0])
    JA.save_artifact(want, str(tmp_path / "jax"))
    got = A.load_artifact(str(tmp_path / "jax"), device="cpu")
    assert got.cfg.to_dict() == want.cfg.to_dict()
    for a, b in zip(jax.tree.leaves(params_to_jax(got.cfg, got.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want.params))):
        np.testing.assert_array_equal(a, b)
    eng = A.serve(str(tmp_path / "port"), max_slots=2, max_len=24, device="cpu")
    eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3))
    assert len(eng.run()[0].out_tokens) == 3


def test_error_surfaces_match_jax(dense, tmp_path):
    cfg, params, pcfg, pp, batches = dense
    with pytest.raises(KeyError, match="grouped-svd"):
        A.get_strategy("no-such-method")
    with pytest.raises(ValueError, match="unknown options"):
        A.compress(pcfg, pp, A.CompressionSpec("grouped-svd", options={"nope": 1}))
    with pytest.raises(ValueError, match="need calibration"):
        A.compress(pcfg, pp, "recalkv")
    with pytest.raises(ValueError, match="carries no Fisher scores"):
        A.compress(pcfg, pp, A.CompressionSpec(
            "grouped-svd", rank_policy=A.RankPolicy(use_fisher=True)))
    with pytest.raises(KeyError, match="labels"):
        A.calibrate(pcfg, pp, [{"tokens": b["tokens"]} for b in batches], fisher=True)
    with pytest.raises(ValueError, match="cannot wrap itself"):
        A.compress(pcfg, pp, A.CompressionSpec("quantized-latent",
                                               options={"base": "quantized-latent"}))
    art = A.compress(pcfg, pp, "grouped-svd")
    ckpt.save(str(tmp_path / "run"), 100, {"x": np.zeros(2)})
    with pytest.raises(ValueError, match="refusing to overwrite"):
        A.save_artifact(art, str(tmp_path / "run"))
    assert ckpt.latest_step(str(tmp_path / "run")) == 100
    jckpt.save(str(tmp_path / "run0"), 0, {"x": jnp.zeros((2,))})
    with pytest.raises(ValueError, match="refusing to overwrite"):
        art.save(str(tmp_path / "run0"))
    art.save(str(tmp_path / "art"))
    art.save(str(tmp_path / "art"))
    assert A.load_artifact(str(tmp_path / "art"), device="cpu").method == "grouped-svd"
    with pytest.raises(ValueError, match="not a compression artifact"):
        A.load_artifact(str(tmp_path / "run"), device="cpu")
    spec = A.CompressionSpec("recalkv", rank_policy=A.RankPolicy(keep_ratio=0.25),
                             backend="pallas")
    assert JA.CompressionSpec.from_dict(spec.to_dict()).to_dict() == spec.to_dict()
    assert A.CompressionSpec.from_dict(spec.to_dict()) == spec
