"""The port's speculative decoding against the JAX package: the draft
module, and Engine streams with ``spec_depth`` > 0 on float and int8 rings
and both backends, which must equal the JAX sync engine's token for token
(so they are invariant to ``spec_depth`` and the draft).

Float32 with TF32 off.  Streams compared token for token; proposals and
the draft's layer view exactly.
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
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.draft import ngram_propose as jax_ngram
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.draft import DraftSpec, make_layer_draft, ngram_propose

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
MIXED_KW = dict(max_slots=2, max_len=40, sync_every=4, prefill_chunk=8)
SAMPLED = dict(temperature=0.9, top_k=32, top_p=0.9, seed=11)


def _jax_model(bits):
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5),
                              dtype=jnp.float32, cache_quant_bits=bits)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _port(cfg, params):
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")


def _prompts(vocab):
    g = np.random.default_rng(3)
    return [g.integers(0, vocab, n).astype(np.int32) for n in (5, 19, 7, 12, 3)]


def _serve(eng, prompts, max_new=6, sampling=None, eos=None):
    R = Request if isinstance(eng, Engine) else JRequest
    for i, pr in enumerate(prompts):
        eng.submit(R(uid=i, prompt=pr.copy(), max_new_tokens=max_new,
                     sampling=sampling, eos_id=eos))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


@pytest.fixture(scope="module")
def rings():
    """Per ring (float, int8): the port's model, the prompts and the JAX
    sync engine's greedy streams (and, for the float ring, sampled)."""
    out = {}
    for name, bits in (("float", None), ("int8", 8)):
        cfg, params = _jax_model(bits)
        prompts = _prompts(cfg.vocab_size)
        want = _serve(JEngine(cfg, params, **MIXED_KW), prompts)
        sampled = (_serve(JEngine(cfg, params, **MIXED_KW), prompts,
                          sampling=JSamplingParams(**SAMPLED))
                   if bits is None else None)
        out[name] = (*_port(cfg, params), prompts, want, sampled)
    return out


@pytest.mark.parametrize("ring", ["float", "int8"])
@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("draft", ["ngram", "layers:1"])
def test_spec_streams_match_jax_sync_engine(rings, ring, backend, draft):
    """spec_depth = 3 with a chunked prompt (ingest rounds verify one
    column), five requests on two slots, a window that does not divide
    the work."""
    pcfg, pp, prompts, want, _ = rings[ring]
    eng = Engine(pcfg, pp, backend=backend, device="cpu", spec_depth=3, draft=draft,
                 **MIXED_KW)
    assert _serve(eng, prompts) == want
    m = eng.metrics()
    assert m["spec_depth"] == 3 and m["draft"] == draft and m["draft_proposed"] > 0


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_sampled_spec_streams_match_jax_sync_engine(rings, backend):
    """Sampled rows: each proposal is held against the draw the slot's own
    key split gives there, so speculation leaves the sampled stream as
    the JAX sync engine's."""
    pcfg, pp, prompts, _, want = rings["float"]
    for depth, draft in ((2, "ngram"), (3, "layers:2")):
        eng = Engine(pcfg, pp, backend=backend, device="cpu", spec_depth=depth,
                     draft=draft, **MIXED_KW)
        assert _serve(eng, prompts, sampling=SamplingParams(**SAMPLED)) == want


def test_streams_invariant_to_spec_depth(rings):
    pcfg, pp, prompts, want, _ = rings["int8"]
    for depth in (1, 2, 5):
        eng = Engine(pcfg, pp, device="cpu", spec_depth=depth, **MIXED_KW)
        assert _serve(eng, prompts) == want


def test_eos_stop_mid_round(rings):
    """An EOS accepted inside a round stops the stream where sequential
    decoding stops it."""
    pcfg, pp, _, _, _ = rings["float"]
    prompt = [np.full(12, 5, np.int32)]
    full = _serve(Engine(pcfg, pp, device="cpu", max_slots=2, max_len=40), prompt,
                  max_new=10)[0]
    eos = full[3]
    ref = _serve(Engine(pcfg, pp, device="cpu", max_slots=2, max_len=40), prompt,
                 max_new=10, eos=eos)[0]
    assert ref[-1] == eos and len(ref) <= 4
    for depth, draft in ((3, "layers:2"), (4, "ngram")):
        eng = Engine(pcfg, pp, device="cpu", max_slots=2, max_len=40, spec_depth=depth,
                     draft=draft)
        assert _serve(eng, prompt, max_new=10, eos=eos)[0] == ref


def test_repetitive_prompt_accepts_draft_tokens(rings):
    """Prompt lookup on a repeated motif proposes real tokens, and the
    model's own continuation accepts some of them."""
    pcfg, pp, _, _, _ = rings["float"]
    kw = dict(device="cpu", max_slots=2, max_len=64, sync_every=2)
    eng = Engine(pcfg, pp, spec_depth=3, draft="ngram", **kw)
    ref = Engine(pcfg, pp, **kw)
    prompt = [np.full(16, 5, np.int32)]
    assert _serve(eng, prompt, max_new=16) == _serve(ref, prompt, max_new=16)
    m = eng.metrics()
    assert m["draft_proposed"] > 0 and m["accept_rate"] > 0.0
    assert m["windows"] < ref.metrics()["windows"]


def test_draft_spec_and_engine_validation(rings):
    pcfg, pp, _, _, _ = rings["float"]
    assert DraftSpec.parse(None) is None and DraftSpec.parse("none") is None
    assert DraftSpec.parse("ngram") == DraftSpec("ngram")
    assert DraftSpec.parse("layers:2") == DraftSpec("layers", 2)
    assert DraftSpec.parse("layers=3") == DraftSpec("layers", 3)
    with pytest.raises(ValueError, match="draft spec"):
        DraftSpec.parse("bogus")
    with pytest.raises(ValueError, match="spec_depth"):
        Engine(pcfg, pp, device="cpu", max_slots=1, max_len=8, spec_depth=-1)
    with pytest.raises(ValueError, match="requires spec_depth"):
        Engine(pcfg, pp, device="cpu", max_slots=1, max_len=8, draft="ngram")
    m = Engine(pcfg, pp, device="cpu", max_slots=1, max_len=8).metrics()
    assert (m["spec_depth"], m["draft"], m["accept_rate"]) == (0, None, 0.0)
    assert Engine(pcfg, pp, device="cpu", max_slots=1, max_len=8,
                  spec_depth=2).metrics()["draft"] == "ngram"


def test_make_layer_draft_is_a_view(rings):
    pcfg, pp, _, _, _ = rings["int8"]
    dcfg, dp = make_layer_draft(pcfg, pp, 2)
    assert dcfg.num_layers == 2 and dcfg.cache_quant_bits == 8
    assert dp["embed"] is pp["embed"]
    assert all(a is b for a, b in zip(dp["layers"], pp["layers"][:2]))
    with pytest.raises(ValueError, match="layers"):
        make_layer_draft(pcfg, pp, pcfg.num_layers + 1)


def test_ngram_propose_matches_jax():
    """Periodic, constant and random histories, with 3-, 2- and 1-gram
    matches, no match, and cur at 0 and 1."""
    rng = np.random.default_rng(5)
    L = 24
    hist = np.stack([np.tile([3, 1, 4, 1, 5], 5)[:L], np.full(L, 7),
                     rng.integers(0, 6, L), rng.integers(0, 50, L),
                     np.arange(L), np.arange(L)])
    cur = np.array([17, 9, 20, 12, 0, 1])
    tok_in = np.array([hist[0, 17], 7, hist[2, 5], 49, 3, 0])
    for depth in (1, 3, 5):
        want = jax_ngram(jnp.asarray(hist, jnp.int32), jnp.asarray(cur, jnp.int32),
                         jnp.asarray(tok_in, jnp.int32), depth)
        got = ngram_propose(torch.from_numpy(hist), torch.from_numpy(cur),
                            torch.from_numpy(tok_in), depth)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
