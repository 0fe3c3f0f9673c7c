"""Mesh serving in the port (``Engine(mesh=...)``) against the single-device
engines: the port's and the JAX package's.

Each mesh is one spawn of gloo ranks (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory, no TCP port); every
rank runs every case of that mesh inside the one spawn, on qwen3-4b smoke
in float32 at the JAX mesh test's sizes (``max_slots=4``, ``max_len=40``),
and rank 0 writes the streams and counters.  The spawn joins under a time
limit of its own, so a hung collective fails the test, not the suite.

On (2, 2): greedy and sampled requests (one run each for the dense, latent
and int8 caches, the two kinds mixed), chunked prefill at 7 and at 5 with
``sync_every=3`` on a cap-length prompt, the paged pool, n-gram
speculation at depth 2; ``host_syncs == windows + admission_syncs``; ring
leaves held as (slots / 2, positions / 2) shards; ``slot_shards == 2``
and a two-request wave in one slot group.  On (1, 4): latent greedy and
the pool.  Every stream equals the port's single-device engine's and the
JAX single-device engine's (which n-gram speculation and chunking leave
unchanged).  The refusals are checked in this process: a mesh's checks
run before it touches a process group; so is the construction of what a
mesh serves since its einsum readers merge (MLA, cross-attention, the
recurrent state, the layer draft, the einsum backend), whose streams
``test_torch_mesh_families.py`` holds.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

TIME_LIMIT_S = 120
SLOTS, MAX_LEN = 4, 40
SAMPLED = dict(temperature=0.9, top_k=32, top_p=0.9, seed=11)
MODELS = {"dense": {}, "latent": {"recalkv_ratio": 0.5},
          "int8": {"recalkv_ratio": 0.5, "cache_quant_bits": 8}}

# (case, model, engine keywords, which prompt set); all on the kernel backend
CASES_22 = [
    ("dense", "dense", {}, "mixed"),
    ("latent", "latent", {}, "mixed"),
    ("int8", "int8", {}, "mixed"),
    ("chunk7", "latent", {"prefill_chunk": 7}, "cap"),
    ("chunk5_sync3", "latent", {"prefill_chunk": 5, "sync_every": 3}, "cap"),
    ("pool", "latent", {"cache_layout": "paged"}, "mixed"),
    ("ngram2", "latent", {"spec_depth": 2, "draft": "ngram"}, "mixed"),
]
CASES_14 = [
    ("latent", "latent", {}, "mixed"),
    ("pool", "latent", {"cache_layout": "paged"}, "mixed"),
]


def _prompts(vocab):
    """(uid, prompt, sampled): six prompts of 5-15 tokens, odd uids
    sampled; and one cap-length (max_len - 1) prompt, sampled, uid 6 (a
    sampled stream's key is folded from its uid)."""
    g = np.random.default_rng(3)
    mixed = [(i, g.integers(0, vocab, 5 + 2 * i).astype(np.int64), i % 2 == 1)
             for i in range(6)]
    cap = [(6, np.random.default_rng(9).integers(0, vocab, MAX_LEN - 1).astype(np.int64),
            True)]
    return {"mixed": mixed, "cap": cap}


def _serve(cfg, params, prompts, mesh=None, device="cpu", **kw):
    eng = Engine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN, backend="kernel",
                 device=device, mesh=mesh, **kw)
    for uid, pr, sampled in prompts:
        eng.submit(Request(uid=uid, prompt=pr.copy(), max_new_tokens=6,
                           sampling=SamplingParams(**SAMPLED) if sampled else None))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}, eng


def _config(name):
    kw = dict(MODELS[name])
    bits = kw.pop("cache_quant_bits", None)
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True, **kw), dtype=torch.float32,
                              cache_quant_bits=bits)
    return cfg


def _rank_main(rank, world, shape, cases, folder):
    """One gloo rank: every case of this mesh, then rank 0's results to
    ``folder/result.json``."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(*shape, store=dist.FileStore(os.path.join(folder, "store"), world),
                          rank=rank, world_size=world)
    params = {k: torch.load(os.path.join(folder, f"{k}.pt")) for k in ("dense", "latent")}
    out = {}
    for case, model, kw, pset in cases:
        cfg = _config(model)
        prompts = _prompts(cfg.vocab_size)[pset]
        streams, eng = _serve(cfg, params["dense" if model == "dense" else "latent"],
                              prompts, mesh=mesh, **kw)
        m = eng.metrics()
        ring = eng.cache[0]["self"]
        out[case] = {"streams": {str(k): v for k, v in streams.items()},
                     "host_syncs": m["host_syncs"], "windows": m["windows"],
                     "admission_syncs": m["admission_syncs"], "tokens": m["tokens"],
                     "mesh": m["mesh"], "slot_shards": eng.scheduler.slot_shards,
                     "ring_shape": list(ring["pos"].shape), "layout": eng.cache_layout,
                     "draft_proposed": m["draft_proposed"]}
    # a two-request wave lands in one slot group
    cfg = _config("latent")
    eng = Engine(cfg, params["latent"], max_slots=SLOTS, max_len=MAX_LEN, backend="kernel",
                 device="cpu", mesh=mesh)
    g = np.random.default_rng(5)
    for i in range(2):
        eng.submit(Request(uid=i, prompt=g.integers(0, cfg.vocab_size, 5), max_new_tokens=20))
    eng.step()
    out["wave"] = [i for i, r in enumerate(eng.scheduler.slot_req) if r is not None]
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(folder, "result.json"), "w") as f:
            json.dump(out, f)


def _spawn(shape, cases, folder):
    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, shape, cases, folder))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIME_LIMIT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"mesh {shape}: ranks still running after {TIME_LIMIT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(os.path.join(folder, "result.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def models():
    """The JAX models (params from one PRNG key) and the port's copies."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro_torch.models.weights import params_from_jax
    out = {}
    for name in ("dense", "latent"):
        jcfg = dataclasses.replace(jget("qwen3-4b", smoke=True, **MODELS[name]),
                                   dtype=jnp.float32)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        pcfg = ModelConfig.from_dict(jcfg.to_dict())
        out[name] = (jcfg, jp, params_from_jax(pcfg, jax.tree.map(np.asarray, jp),
                                               device="cpu"))
    return out


@pytest.fixture(scope="module")
def references(models):
    """The JAX single-device engine's streams: one run per cache on the
    mixed prompts plus the cap-length one (greedy and sampled requests
    together)."""
    import dataclasses as dc
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving.sampler import SamplingParams as JSampling
    out = {}
    for name in MODELS:
        jcfg, jp, _ = models["dense" if name == "dense" else "latent"]
        if name == "int8":
            jcfg = dc.replace(jcfg, cache_quant_bits=8)
        sets = _prompts(jcfg.vocab_size)
        eng = JEngine(jcfg, jp, max_slots=SLOTS, max_len=MAX_LEN)
        for uid, pr, sampled in sets["mixed"] + sets["cap"]:
            eng.submit(JRequest(uid=uid, prompt=pr.astype(np.int32).copy(), max_new_tokens=6,
                                sampling=JSampling(**SAMPLED) if sampled else None))
        streams = {str(r.uid): [int(t) for t in r.out_tokens] for r in eng.run()}
        out[name] = {k: {str(uid): streams[str(uid)] for uid, *_ in v}
                     for k, v in sets.items()}
    return out


@pytest.fixture(scope="module")
def saved(models, tmp_path_factory):
    folder = tmp_path_factory.mktemp("mesh_params")
    for name in ("dense", "latent"):
        torch.save(models[name][2], folder / f"{name}.pt")
    return folder


def _mesh_results(saved, tmp_path_factory, shape, cases):
    folder = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    for name in ("dense", "latent"):
        os.link(saved / f"{name}.pt", folder / f"{name}.pt")
    return _spawn(shape, cases, str(folder))


@pytest.fixture(scope="module")
def mesh22(saved, tmp_path_factory):
    return _mesh_results(saved, tmp_path_factory, (2, 2), CASES_22)


@pytest.fixture(scope="module")
def mesh14(saved, tmp_path_factory):
    return _mesh_results(saved, tmp_path_factory, (1, 4), CASES_14)


def _single_device(models, model, kw, pset):
    cfg = _config(model)
    params = models["dense" if model == "dense" else "latent"][2]
    streams, _ = _serve(cfg, params, _prompts(cfg.vocab_size)[pset], **kw)
    return {str(k): v for k, v in streams.items()}


@pytest.mark.parametrize("case,model,kw,pset", CASES_22, ids=[c[0] for c in CASES_22])
def test_mesh22_streams_equal_single_device(mesh22, references, models, case, model, kw,
                                            pset):
    got = mesh22[case]
    assert got["mesh"] == "2x2" and got["layout"] == kw.get("cache_layout", "ring")
    assert got["streams"] == _single_device(models, model, kw, pset), case
    assert got["streams"] == references[model][pset], case
    assert got["host_syncs"] == got["windows"] + got["admission_syncs"], got
    if pset == "mixed":      # (the cap-length prompt ingests for windows)
        assert got["host_syncs"] < got["tokens"], got
    if case == "ngram2":
        assert got["draft_proposed"] > 0


def test_mesh22_ring_is_sharded_on_both_axes_and_waves_fill_one_group(mesh22):
    lat = mesh22["latent"]
    assert lat["ring_shape"] == [SLOTS // 2, MAX_LEN // 2], lat
    assert lat["slot_shards"] == 2
    assert mesh22["wave"] in ([0, 1], [2, 3]), mesh22["wave"]
    # the pool keeps every page on each data rank and splits its offsets
    pool = mesh22["pool"]
    assert pool["ring_shape"][1] == 8 // 2, pool


@pytest.mark.parametrize("case,model,kw,pset", CASES_14, ids=[c[0] for c in CASES_14])
def test_mesh14_streams_equal_single_device(mesh14, references, models, case, model, kw,
                                            pset):
    got = mesh14[case]
    assert got["mesh"] == "1x4" and got["slot_shards"] == 1
    assert got["streams"] == _single_device(models, model, kw, pset), case
    assert got["streams"] == references[model][pset], case
    assert got["host_syncs"] == got["windows"] + got["admission_syncs"], got
    if case == "latent":
        assert got["ring_shape"] == [SLOTS, MAX_LEN // 4]


# -- refusals, by name --------------------------------------------------------

REFUSED = [
    ("overlap", "qwen3-4b", {"overlap": True}, "overlap=True is not ported to a mesh"),
    ("continuous", "qwen3-4b", {"overlap": True, "continuous": True},
     "continuous=True is not ported to a mesh"),
    ("aot", "qwen3-4b", {"aot": True}, "aot=True is not ported to a mesh"),
    ("uneven_slots", "qwen3-4b", {"max_slots": 3}, "does not split over 2 data ranks"),
    ("pool_pages_split", "qwen3-4b", {"cache_layout": "paged", "n_pages": 20},
     "would split the pool's pages"),
    ("uneven_ring", "qwen3-4b", {"max_len": 41}, r"ring lengths \[41\] do not split"),
    ("uneven_page", "qwen3-4b", {"cache_layout": "paged", "page_size": 5},
     "page_size=5 does not split over 2 model ranks"),
]


def _smoke(arch):
    from repro_torch.models.weights import init_params
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("case,arch,kw,msg", REFUSED, ids=[r[0] for r in REFUSED])
def test_mesh_refusals_name_their_roadmap_item(case, arch, kw, msg):
    cfg, params = _smoke(arch)
    kw = {"backend": "kernel", "max_slots": SLOTS, "max_len": MAX_LEN, **kw}
    with pytest.raises(ValueError, match=msg) as e:
        Engine(cfg, params, device="cpu", mesh=Mesh(2, 2), **kw)
    assert "ROADMAP.md Queue 1 item 5" in str(e.value)


# Paths the mesh refused before the einsum readers merged over "model": built
# on a (2, 2) mesh here, no process group touched (their streams are held in
# tests/test_torch_mesh_families.py).
SERVED = [
    ("mla", "deepseek-v3-671b", {}),
    ("cross", "llama-3.2-vision-11b", {}),
    ("encoder_decoder", "whisper-small", {}),
    ("recurrent", "falcon-mamba-7b", {}),
    ("layer_draft", "qwen3-4b", {"spec_depth": 2, "draft": "layers:1"}),
    ("einsum", "qwen3-4b", {"backend": "einsum"}),
]


@pytest.mark.parametrize("case,arch,kw", SERVED, ids=[r[0] for r in SERVED])
def test_mesh_accepts_what_it_now_serves(case, arch, kw):
    import warnings
    cfg, params = _smoke(arch)
    src = (np.zeros((SLOTS, cfg.cross_source_len, cfg.d_model), np.float32)
           if cfg.cross_source_len else None)
    kw = {"backend": "kernel", **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng = Engine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN, device="cpu",
                     source=src, mesh=Mesh(2, 2), **kw)
    assert eng.mesh_str == "2x2" and eng.mesh.stats["all_gather"] == 0
    leaves = [leaf for c in eng.cache for part in c.values() for leaf in part.values()]
    assert leaves and all(leaf.shape[0] == SLOTS // 2 for leaf in leaves)


def test_single_device_mesh_launches_no_collective(models):
    """The (1, 1) mesh is the single-device engine, with no process group."""
    cfg = _config("latent")
    streams, eng = _serve(cfg, models["latent"][2], _prompts(cfg.vocab_size)["mixed"],
                          mesh=Mesh(1, 1))
    m = eng.metrics()
    assert m["mesh"] == "1x1" and m["mesh_stats"]["all_reduce"] == 0
    assert m["mesh_stats"]["all_gather"] == 0


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
