"""Fisher-guided rank allocation in the port (``core.fisher``,
``models.compress.fisher_scores``, ``calibrate(..., fisher=True)``,
``RankPolicy(use_fisher=True)``) against the JAX package, float32 with
TF32 off, on numpy-seeded inputs and weights carried by
``params_from_jax``:

* ``allocate_ratios`` / ``ratios_to_ranks`` / ``allocate`` equal JAX's
  exactly (numpy float64 in both), budgets inside and outside the clip
  box, no layers;
* ``empirical_fisher`` and ``layer_scores`` on a small tree (1e-5);
* ``fisher_scores`` of qwen3-4b and qwen3-moe (whose loss carries the
  MoE aux term) smoke models (1e-5 relative);
* a Fisher ``calibrate`` -> ``compress`` with equal ``ranks_by_layer``
  (not uniform) and the compressed model's logits within 1e-4 of JAX's;
* greedy Engine streams of JAX's Fisher-compressed model (non-uniform
  ranks through ``params_from_jax``) equal to the JAX engine's, on the
  einsum and the kernel backends;
* the refusal of ``use_fisher`` without scores, JAX's words.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as JA
from repro.configs import get_config
from repro.core import fisher as JF
from repro.models import compress as JC
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
import repro_torch.api as A
from repro_torch.core import fisher as F
from repro_torch.data import DataConfig, batch as data_batch
from repro_torch.models import compress as C
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import Engine, Request

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
ENGINE = dict(max_slots=2, max_len=40, sync_every=4)
POLICY = dict(keep_ratio=0.5, group_size=2, use_fisher=True)


def _model(arch, seed=0):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32,
                              scan_layers=False)
    params = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return cfg, params, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                              device="cpu")


def _batches(cfg, n=2, rows=2, seq=24):
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq)
    return [data_batch(dc, "calib", i, rows) for i in range(n)]


def _jax(batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


_CACHE = {}


def _fisher_run():
    """One JAX and one port Fisher calibrate + compress of the qwen3-4b
    smoke model (seed 3), shared by the tests that read it."""
    if "run" not in _CACHE:
        cfg, params, pcfg, pp = _model("qwen3-4b", seed=3)
        batches = _batches(cfg)
        jcal = JA.calibrate(cfg, params, _jax(batches), fisher=True)
        spec = JA.CompressionSpec("recalkv", rank_policy=JA.RankPolicy(**POLICY))
        jart = JA.compress(cfg, params, spec, jcal)
        pcal = A.calibrate(pcfg, pp, batches, fisher=True)
        part = A.compress(pcfg, pp, A.CompressionSpec(
            "recalkv", rank_policy=A.RankPolicy(**POLICY)), pcal)
        _CACHE["run"] = (cfg, params, pcfg, pp, jcal, jart, pcal, part)
    return _CACHE["run"]


SCORE_CASES = [
    (np.random.default_rng(0).gamma(2.0, size=12), 0.5, {}),
    (np.random.default_rng(1).gamma(0.5, size=7), 0.3, dict(alpha=1.0)),
    (np.random.default_rng(2).lognormal(size=5) * 1e-9, 0.9, dict(rho_max=0.95)),
    (np.array([1.0, 1e6, 1e-6, 3.0]), 0.25, dict(rho_min=0.1, alpha=0.7)),
    (np.array([2.0, 2.0, 2.0]), 0.02, {}),          # budget below rho_min
    (np.array([]), 0.5, {}),
]


@pytest.mark.parametrize("case", range(len(SCORE_CASES)))
def test_allocation_equals_jax(case):
    """Ratios, ranks (group widths 32 / 128 / 512, multiples 8 and 16) and
    the achieved ratios equal JAX's exactly."""
    scores, target, kw = SCORE_CASES[case]
    scores = [float(s) for s in scores]
    assert F.allocate_ratios(scores, target, **kw) == JF.allocate_ratios(scores, target,
                                                                        **kw)
    for width, mult in ((32, 8), (128, 8), (512, 16)):
        ratios = JF.allocate_ratios(scores, target, **kw)
        assert (F.ratios_to_ranks(ratios, width, multiple=mult)
                == JF.ratios_to_ranks(ratios, width, multiple=mult))
        got = F.allocate(scores, target, width, multiple=mult, **kw)
        want = JF.allocate(scores, target, width, multiple=mult, **kw)
        assert (got.ratios, got.ranks, got.fisher) == (want.ratios, want.ranks,
                                                       want.fisher)
        if scores:
            assert got.mean_ratio() == want.mean_ratio()
    with pytest.raises(ValueError, match="target_ratio"):
        F.allocate_ratios([1.0], 1.5)


def test_empirical_fisher_matches_jax():
    """Summed squared gradients of a small two-leaf loss over three
    batches, and their per-leaf scores (1e-5)."""
    g = np.random.default_rng(4)
    params = {"a": g.normal(size=(3, 4)).astype(np.float32),
              "b": g.normal(size=(4,)).astype(np.float32)}
    batches = [g.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]

    def jloss(p, x):
        return jnp.sum(jnp.tanh(x @ p["a"] + p["b"]) ** 2)

    def tloss(p, x):
        return torch.sum(torch.tanh(torch.as_tensor(x) @ p["a"] + p["b"]) ** 2)

    want = JF.empirical_fisher(jloss, jax.tree.map(jnp.asarray, params),
                               [jnp.asarray(b) for b in batches])
    got = F.empirical_fisher(tloss, {k: torch.tensor(v) for k, v in params.items()},
                             batches)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7)
    ws, gs = JF.layer_scores(want), F.layer_scores(got)
    assert set(ws) == set(gs)
    for k in ws:
        assert gs[k] == pytest.approx(ws[k], rel=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b"])
def test_fisher_scores_match_jax(arch):
    """Per-layer W_k / W_v scores of the LM loss (with the MoE aux term on
    qwen3-moe) over two labelled batches, 1e-5 relative; the leaves come
    back without ``requires_grad``."""
    cfg, params, pcfg, pp = _model(arch)
    batches = _batches(cfg)
    wk, wv = JC.fisher_scores(cfg, params, _jax(batches))
    gk, gv = C.fisher_scores(pcfg, pp, batches)
    np.testing.assert_allclose(gk, wk, rtol=1e-5)
    np.testing.assert_allclose(gv, wv, rtol=1e-5)
    assert not any(layer["attn"]["wk"].requires_grad for layer in pp["layers"])


def test_fisher_calibrate_compress_matches_jax():
    """``calibrate(fisher=True)`` scores within 1e-5; ``compress`` with
    ``RankPolicy(use_fisher=True)`` allocates JAX's per-layer ranks (not
    uniform), records ``fisher`` in the provenance, and the compressed
    model's full-forward logits are within 1e-4 of JAX's."""
    cfg, params, pcfg, pp, jcal, jart, pcal, part = _fisher_run()
    np.testing.assert_allclose(pcal.fisher_k, jcal.fisher_k, rtol=1e-5)
    np.testing.assert_allclose(pcal.fisher_v, jcal.fisher_v, rtol=1e-5)
    want = [tuple(r) for r in jart.provenance["ranks_by_layer"]]
    assert [tuple(r) for r in part.provenance["ranks_by_layer"]] == want
    assert part.cfg.recalkv.ranks_by_layer == jart.cfg.recalkv.ranks_by_layer
    assert len(set(want)) > 1, f"uniform ranks {want}: the case shows nothing"
    assert part.provenance["fisher"] is True and jart.provenance["fisher"] is True
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 20))
    wl = JT.logits_for(jart.cfg, jart.params,
                       JT.forward_hidden(jart.cfg, jart.params, jnp.asarray(toks))[0])
    with torch.no_grad():
        gl = T.logits_for(part.cfg, part.params,
                          T.forward_hidden(part.cfg, part.params, torch.as_tensor(toks))[0])
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_fisher_engine_streams_match_jax(backend):
    """JAX's Fisher-compressed model (per-layer ranks) carried into the
    port serves greedy streams equal to the JAX engine's token for token;
    its caches hold each layer's own ranks."""
    _, _, _, _, _, jart, _, _ = _fisher_run()
    pcfg = ModelConfig.from_dict(jart.cfg.to_dict())
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, jart.params), device="cpu")
    g = np.random.default_rng(8)
    prompts = [g.integers(0, jart.cfg.vocab_size, n).astype(np.int32) for n in (9, 4, 13)]
    if "streams" not in _CACHE:
        jeng = JEngine(jart.cfg, jart.params, **ENGINE)
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(uid=i, prompt=p.copy(), max_new_tokens=6))
        _CACHE["streams"] = {r.uid: [int(t) for t in r.out_tokens] for r in jeng.run()}
    eng = Engine(pcfg, pp, backend=backend, device="cpu", **ENGINE)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=6))
    assert {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()} == _CACHE["streams"]
    ranks = [c["self"]["zk"].shape[-1] for c in eng.cache]
    assert ranks == [r[0] for r in pcfg.recalkv.ranks_by_layer]


def test_use_fisher_without_scores_refused():
    """A Fisher rank policy on calibration data without scores raises
    JAX's ValueError; scores without the policy give uniform ranks."""
    cfg, params, pcfg, pp = _model("qwen3-4b")
    batches = _batches(cfg, n=1)
    spec = A.CompressionSpec("recalkv", rank_policy=A.RankPolicy(**POLICY))
    jspec = JA.CompressionSpec("recalkv", rank_policy=JA.RankPolicy(**POLICY))
    for cal, cmp, s, c, p in ((A.calibrate, A.compress, spec, pcfg, pp),
                              (JA.calibrate, JA.compress, jspec, cfg, params)):
        b = batches if c is pcfg else _jax(batches)
        with pytest.raises(ValueError, match="carries no Fisher scores"):
            cmp(c, p, s, cal(c, p, b))
    uniform = A.compress(pcfg, pp, A.CompressionSpec(
        "recalkv", rank_policy=A.RankPolicy(keep_ratio=0.5, group_size=2)),
        A.calibrate(pcfg, pp, batches, fisher=True))
    assert len({tuple(r) for r in uniform.provenance["ranks_by_layer"]}) == 1
    assert uniform.provenance["fisher"] is False
