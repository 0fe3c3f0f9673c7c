"""Mesh serving of every family and flag the mesh engine accepts, against
the single-device engines: the port's and the JAX package's.

One spawn of four gloo ranks on a (2, 2) mesh (``torch.multiprocessing``,
a ``FileStore`` under the test's temporary directory) runs every case;
the spawn joins under a time limit of its own, so a hung collective
fails the test, not the suite.  While it runs, this process computes the
references: one JAX single-device engine run per (arch, cache) and one
port single-device engine run per case.

The cases: deepseek-v3 (MLA's absorbed readers merged in einsum form,
also under n-gram speculation), whisper-small and llama-3.2-vision (the
cross readers over a sharded source; whisper's encoder), dense and
latent; falcon-mamba and recurrentgemma (the state gathered over "model"
at read, each rank keeping its channels); the layer draft (its own
sharded ring, params a view over the target's shards); qwen3-4b on the
einsum backend (decode and, with n-gram speculation, verify); gemma3 and
h2o-danube (local window rings), minicpm (q_per_kv 1), qwen3-moe (the
MoE over the data ranks' gathered rows); the pool with ``lazy_pages``
and with ``pin_prefixes`` under ``prefix-affinity``; ``api.serve`` of a
saved latent whisper and recurrentgemma artifact.  The ranks also run
the serving CLI with ``--mesh 2,2``: whisper with ``--draft layers:1``
and falcon-mamba, each serving every request.

Every model is the smoke config in float32 with the port's seeded random
init (the JAX engine reads the same weights through ``params_to_jax``).
Four prompts of 9-16 tokens share an 8-token prefix (the prefix policy
then hits), so every wave pads to one 16-token bucket, whatever requests
it holds: a recurrent state runs over its wave's pads (ROADMAP Queue 3
item 10), and the mesh forms other waves than one device (two slots a
data rank).  A cross model reads one source row repeated, so any wave
reads the same source.  Odd uids sample, even ones are greedy.  A
speculative MoE stream is held to the JAX engine at the same depth: an
expert's capacity counts the tokens a step feeds, so speculation moves
its drops (JAX's own streams part there); every other case's JAX
reference is the plain engine's.
"""

import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.models.weights import init_params
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

TIME_LIMIT_S = 240
SLOTS, MAX_LEN, NEW = 4, 40, 4
SAMPLED = dict(temperature=0.9, top_k=32, top_p=0.9, seed=11)
KINDS = {"dense": {}, "latent": {"recalkv_ratio": 0.5}}
POOL = dict(cache_layout="paged", page_size=4)

# (case, arch, cache, engine keywords); the kernel backend unless a case says
CASES = [
    ("deepseek", "deepseek-v3-671b", "dense", {}),
    ("deepseek_ngram2", "deepseek-v3-671b", "dense", {"spec_depth": 2, "draft": "ngram"}),
    ("whisper_dense", "whisper-small", "dense", {}),
    ("whisper_latent", "whisper-small", "latent", {}),
    ("vision_dense", "llama-3.2-vision-11b", "dense", {}),
    ("vision_latent", "llama-3.2-vision-11b", "latent", {}),
    ("falcon_mamba", "falcon-mamba-7b", "dense", {}),
    ("recurrentgemma", "recurrentgemma-9b", "latent", {}),
    ("layer_draft", "qwen3-4b", "latent", {"spec_depth": 2, "draft": "layers:2"}),
    ("einsum", "qwen3-4b", "latent", {"backend": "einsum"}),
    ("einsum_ngram2", "qwen3-4b", "latent",
     {"backend": "einsum", "spec_depth": 2, "draft": "ngram"}),
    ("gemma3", "gemma3-12b", "latent", {}),
    ("danube", "h2o-danube-1.8b", "dense", {}),
    ("minicpm", "minicpm-2b", "latent", {}),
    ("qwen3_moe", "qwen3-moe-235b-a22b", "dense", {}),
    ("lazy_pages", "qwen3-4b", "latent", {**POOL, "n_pages": 15, "lazy_pages": True}),
    ("pin_prefixes", "qwen3-4b", "latent",
     {**POOL, "pin_prefixes": 2, "policy": "prefix-affinity"}),
    ("artifact_whisper", "whisper-small", "latent", {"artifact": True}),
    ("artifact_recurrentgemma", "recurrentgemma-9b", "latent", {"artifact": True}),
]
CLI = {"cli_whisper_layer_draft": ["--arch", "whisper-small", "--spec-depth", "2",
                                   "--draft", "layers:1"],
       "cli_falcon_mamba": ["--arch", "falcon-mamba-7b"]}
CLI_REQUESTS, CLI_NEW = 4, 3


def _model(arch, cache):
    """(port cfg, port params): the float32 smoke config, seeded init."""
    cfg = dataclasses.replace(get_config(arch, smoke=True, **KINDS[cache]),
                              dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _prompts(vocab):
    g = np.random.default_rng(3)
    prefix = g.integers(0, vocab, 8)
    return [np.concatenate([prefix, g.integers(0, vocab, n - 8)]).astype(np.int64)
            for n in (9, 12, 16, 11)]


def _source(cfg):
    """One source row, repeated over every row a wave can read."""
    if not cfg.cross_source_len:
        return None
    row = np.random.default_rng(4).normal(size=(1, cfg.cross_source_len, cfg.d_model))
    return np.repeat(row.astype(np.float32), 2 * SLOTS, axis=0)


def _serve(eng, vocab, port=True):
    if port:
        R, SP = Request, SamplingParams
    else:
        from repro.serving import Request as R
        from repro.serving.sampler import SamplingParams as SP
    for uid, pr in enumerate(_prompts(vocab)):
        eng.submit(R(uid=uid, prompt=pr.astype(np.int32 if not port else np.int64),
                     max_new_tokens=NEW, sampling=SP(**SAMPLED) if uid % 2 else None))
    return {str(r.uid): [int(t) for t in r.out_tokens] for r in eng.run()}


def _port_engine(arch, cache, kw, folder, mesh=None):
    """The port's engine for a case: built directly, or by ``api.serve``
    from the artifact :func:`_save_artifacts` wrote."""
    from repro_torch import api
    cfg, params = _model(arch, cache)
    kw = {"backend": "kernel", **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # MLA / cross: einsum readers
        if kw.pop("artifact", False):
            return cfg, api.serve(os.path.join(folder, f"{arch}-{cache}"), max_slots=SLOTS,
                                  max_len=MAX_LEN, device="cpu", source=_source(cfg),
                                  mesh=mesh, **kw)
        return cfg, Engine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN, device="cpu",
                           source=_source(cfg), mesh=mesh, **kw)


def _save_artifacts(folder):
    from repro_torch.api import CompressionArtifact
    for _, arch, cache, kw in CASES:
        if kw.get("artifact"):
            cfg, params = _model(arch, cache)
            CompressionArtifact(cfg=cfg, params=params, provenance={"method": "random"}).save(
                os.path.join(folder, f"{arch}-{cache}"))


def _cli_on_mesh(args):
    """The serving CLI with ``--mesh 2,2`` on this rank's process group:
    each finished request's token count."""
    from repro_torch.launch import serve
    argv = args + ["--smoke", "--device", "cpu", "--slots", str(SLOTS), "--max-len",
                   str(MAX_LEN), "--requests", str(CLI_REQUESTS), "--new-tokens",
                   str(CLI_NEW), "--mesh", "2,2", "--dist-backend", "gloo"]
    return sorted(len(r.out_tokens) for r in serve.main(argv))


def _rank_main(rank, world, folder):
    """One gloo rank: every case, then rank 0's results to
    ``folder/result.json``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(2, 2, store=dist.FileStore(os.path.join(folder, "store"), world),
                          rank=rank, world_size=world)
    out = {}
    for case, arch, cache, kw in CASES:
        cfg, eng = _port_engine(arch, cache, kw, folder, mesh=mesh)
        streams = _serve(eng, cfg.vocab_size)
        m = eng.metrics()
        state = next((c["state"] for c in eng.cache if "state" in c), None)
        out[case] = {"streams": streams, "mesh": m["mesh"],
                     "host_syncs": m["host_syncs"], "windows": m["windows"],
                     "admission_syncs": m["admission_syncs"],
                     "draft_proposed": m["draft_proposed"],
                     "prefix_hits": int(sum(eng._prefix_hits.values())),
                     "state_shapes": None if state is None else
                     {k: list(v.shape) for k, v in state.items()},
                     "draft_ring": None if eng.draft_cache is None else
                     list(eng.draft_cache[0]["self"]["pos"].shape)}
    for case, args in CLI.items():
        out[case] = _cli_on_mesh(args)
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(folder, "result.json"), "w") as f:
            json.dump(out, f)


def _jax_key(arch, cache, kw):
    """Which JAX run a case is held to: (arch, cache), plus the
    speculation flags for an MoE model."""
    if get_config(arch, smoke=True).moe is None or not kw.get("spec_depth"):
        return arch, cache, ()
    return arch, cache, (("spec_depth", kw["spec_depth"]), ("draft", kw["draft"]))


def _jax_streams(arch, cache, spec=()):
    """The JAX single-device engine's streams on the same weights."""
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.serving import Engine as JEngine
    from repro_torch.models.weights import params_to_jax
    pcfg, params = _model(arch, cache)
    jcfg = dataclasses.replace(jget(arch, smoke=True, **KINDS[cache]), dtype=jnp.float32)
    src = _source(pcfg)
    eng = JEngine(jcfg, params_to_jax(pcfg, params), max_slots=SLOTS, max_len=MAX_LEN,
                  **dict(spec), **({} if src is None else {"source": jnp.asarray(src)}))
    return _serve(eng, pcfg.vocab_size, port=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(mesh results, port single-device streams, JAX streams): the spawn
    runs while this process computes the references."""
    folder = str(tmp_path_factory.mktemp("mesh_families"))
    _save_artifacts(folder)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 4, folder)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        jax_ref = {k: _jax_streams(*k) for k in dict.fromkeys(
            _jax_key(a, c, kw) for _, a, c, kw in CASES)}
        port_ref = {case: _serve(_port_engine(a, c, kw, folder)[1], _model(a, c)[0].vocab_size)
                    for case, a, c, kw in CASES}
    finally:
        for p in procs:
            p.join(TIME_LIMIT_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, f"ranks still running after {TIME_LIMIT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(os.path.join(folder, "result.json")) as f:
        return json.load(f), port_ref, jax_ref


@pytest.mark.parametrize("case,arch,cache,kw", CASES, ids=[c[0] for c in CASES])
def test_mesh22_streams_equal_single_device(runs, case, arch, cache, kw):
    got, port_ref, jax_ref = runs
    got = got[case]
    assert got["mesh"] == "2x2"
    assert len(got["streams"]) == 4 and all(len(s) == NEW for s in got["streams"].values())
    assert got["streams"] == port_ref[case], case
    assert got["streams"] == jax_ref[_jax_key(arch, cache, kw)], case
    assert got["host_syncs"] == got["windows"] + got["admission_syncs"], got
    if kw.get("spec_depth"):
        assert got["draft_proposed"] > 0, got
    if case == "layer_draft":    # the draft's ring: slots over "data", positions over "model"
        assert got["draft_ring"] == [SLOTS // 2, MAX_LEN // 2], got
    if case == "pin_prefixes":
        assert got["prefix_hits"] > 0, got


@pytest.mark.parametrize("case", sorted(CLI))
def test_cli_serves_on_the_mesh(runs, case):
    """``launch.serve --mesh 2,2`` builds the mesh on the ranks' process
    group and serves every request to its budget."""
    assert runs[0][case] == [CLI_NEW] * CLI_REQUESTS


def test_mesh22_recurrent_state_is_sharded_by_slot_and_channel(runs):
    """A recurrent state rests as CACHE_RULES lay it out: slots over
    "data", ``h``'s dim 1 and ``conv``'s dim 2 over "model"."""
    fm = get_config("falcon-mamba-7b", smoke=True)
    di, ds, k = fm.mamba_d_inner, fm.mamba.d_state, fm.mamba.d_conv
    assert runs[0]["falcon_mamba"]["state_shapes"] == {
        "h": [SLOTS // 2, di // 2, ds], "conv": [SLOTS // 2, k - 1, di // 2]}
    rg = get_config("recurrentgemma-9b", smoke=True)
    w, k = rg.lru_width, rg.rglru.conv_width
    assert runs[0]["recurrentgemma"]["state_shapes"] == {
        "h": [SLOTS // 2, w // 2], "conv": [SLOTS // 2, k - 1, w // 2]}


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
