"""The overlapped and continuous engines on a mesh (``Engine(mesh=...,
overlap=True)``) against the single-device engines: the port's sync
engine and the JAX package's.

One spawn of four gloo ranks on a (2, 2) mesh (``torch.multiprocessing``,
a ``FileStore`` under the test's temporary directory) runs every case;
the spawn joins under a time limit of its own, so a hung collective fails
the test, not the suite.  While it runs, this process computes the
references: one JAX single-device engine run and one run of the port's
single-device sync engine, on the prompts of ``test_torch_mesh.py`` (six
of 5-15 tokens, odd uids sampled, 6 new tokens each) over 4 slots of 40
positions: a stream depends on its request only, so every case is held
to the same two.

The cases, on qwen3-4b smoke (latent, float32, the kernel backend):
the overlapped engine at depth 2 with the admission thread; with n-gram
speculation at depth 2 and ``adaptive_spec`` (the per-slot draft
counts ride the gathered status); the continuous engine at depth 3 (each data
rank installs into its own slots); the overlapped engine on the pool with
lazy pages (page 4, 11 pages, windows of one step: the pool runs dry
and preempts, and the preempted row is read across the data ranks); and
``skewed``, the overlapped continuous engine at depth 3 where rank 1's
admission worker sleeps before every wave it prepares.  On a design
whose decisions followed the worker's timing, the ranks would adopt
waves at different boundaries and their collectives would part; here
each wave is formed on the main thread and adopted at the next boundary
(``AdmissionWorker(lockstep=True)``), so the streams stay equal and
nothing hangs.  Every overlapped case keeps ``host_syncs == windows +
admission_syncs``.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.serving import Engine, Request, SamplingParams
from test_torch_mesh import MAX_LEN, MODELS, SAMPLED, SLOTS, _config, _prompts

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

TIME_LIMIT_S = 150
SKEW_S = 0.05
POOL = dict(cache_layout="paged", page_size=4, n_pages=11, lazy_pages=True, sync_every=1)

# (case, engine keywords); every case overlapped, with the admission thread
CASES = [
    ("overlap", {"overlap": True}),
    ("overlap_ngram2", {"overlap": True, "spec_depth": 2, "draft": "ngram",
                        "adaptive_spec": True}),
    ("continuous3", {"overlap": True, "continuous": True, "pipeline_depth": 3}),
    ("pool_lazy", {"overlap": True, **POOL}),
    ("skewed", {"overlap": True, "continuous": True, "pipeline_depth": 3}),
]


def _serve(cfg, params, mesh=None, **kw):
    eng = Engine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN, backend="kernel",
                 device="cpu", mesh=mesh, **kw)
    for uid, pr, sampled in _prompts(cfg.vocab_size)["mixed"]:
        eng.submit(Request(uid=uid, prompt=pr.copy(), max_new_tokens=6,
                           sampling=SamplingParams(**SAMPLED) if sampled else None))
    done = eng.run()
    eng.close()
    return {str(r.uid): [int(t) for t in r.out_tokens] for r in done}, eng


def _rank_main(rank, world, folder):
    """One gloo rank of the (2, 2) mesh: every case, then rank 0's results
    to ``folder/result.json``."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(2, 2, store=dist.FileStore(os.path.join(folder, "store"), world),
                          rank=rank, world_size=world)
    params = torch.load(os.path.join(folder, "latent.pt"))
    cfg = _config("latent")
    out = {}
    for case, kw in CASES:
        if case == "skewed" and rank == 1:
            # this rank's admission worker lags every wave behind the others'
            real = Engine._prepare_wave

            def slow(self, reqs, stream=None):
                wave = real(self, reqs, stream)
                time.sleep(SKEW_S)
                return wave
            Engine._prepare_wave = slow
        streams, eng = _serve(cfg, params, mesh=mesh, **kw)
        m = eng.metrics()
        out[case] = {"streams": streams, "host_syncs": m["host_syncs"],
                     "windows": m["windows"], "admission_syncs": m["admission_syncs"],
                     "slot_swaps": m["slot_swaps"], "preemptions": m["preemptions"],
                     "draft_proposed": m["draft_proposed"], "mesh": m["mesh"],
                     "admission_thread": m["admission_thread"],
                     "waves": eng._admission.waves_prepared,
                     "slot_shards": eng.scheduler.slot_shards}
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(folder, "result.json"), "w") as f:
            json.dump(out, f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The mesh's results (the spawn) and the two references (computed in
    this process while the ranks run)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving.sampler import SamplingParams as JSampling
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.weights import params_from_jax
    jcfg = dataclasses.replace(jget("qwen3-4b", smoke=True, **MODELS["latent"]),
                               dtype=jnp.float32)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(ModelConfig.from_dict(jcfg.to_dict()),
                             jax.tree.map(np.asarray, jp), device="cpu")
    folder = tmp_path_factory.mktemp("mesh_async")
    torch.save(params, folder / "latent.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 4, str(folder))) for r in range(4)]
    for p in procs:
        p.start()
    try:
        port, _ = _serve(_config("latent"), params)
        eng = JEngine(jcfg, jp, max_slots=SLOTS, max_len=MAX_LEN)
        for uid, pr, sampled in _prompts(jcfg.vocab_size)["mixed"]:
            eng.submit(JRequest(uid=uid, prompt=pr.astype(np.int32).copy(),
                                max_new_tokens=6,
                                sampling=JSampling(**SAMPLED) if sampled else None))
        jax_streams = {str(r.uid): [int(t) for t in r.out_tokens] for r in eng.run()}
    finally:
        deadline = time.monotonic() + TIME_LIMIT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, f"mesh (2, 2): ranks still running after {TIME_LIMIT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(folder / "result.json") as f:
        return json.load(f), port, jax_streams


@pytest.mark.parametrize("case,kw", CASES, ids=[c[0] for c in CASES])
def test_overlapped_mesh_streams_equal_single_device(results, case, kw):
    mesh, port, jax_streams = results
    got = mesh[case]
    assert got["mesh"] == "2x2" and got["slot_shards"] == 2 and got["admission_thread"]
    assert port == jax_streams
    assert got["streams"] == port, case
    assert got["host_syncs"] == got["windows"] + got["admission_syncs"], got
    assert got["waves"] >= 1, got
    if kw.get("continuous"):
        assert got["slot_swaps"] > 0, got
    if kw.get("spec_depth"):
        assert got["draft_proposed"] > 0, got
    if kw.get("lazy_pages"):
        assert got["preemptions"] > 0, got


def test_lockstep_worker_hands_back_every_submitted_wave_in_order():
    """``AdmissionWorker(lockstep=True)``: ``collect`` returns every wave
    submitted before it, in order, waiting for those not prepared yet;
    ``busy`` moves with submit / collect only; ``close`` prepares what was
    submitted first (a mesh's other ranks wait on its collectives)."""
    from repro_torch.serving.pipeline import AdmissionWorker
    order = []

    def prepare(reqs):
        time.sleep(0.01 * (reqs[0] % 3))
        order.append(reqs[0])
        return list(reqs)
    w = AdmissionWorker(None, prepare, lockstep=True)
    assert not w.busy and w.collect() == []
    for i in range(5):
        w.submit([i, i + 10])
    assert w.busy
    assert w.collect() == [[i, i + 10] for i in range(5)] and not w.busy
    w.submit([7])
    w.close()
    assert order == [0, 1, 2, 3, 4, 7]
    assert not w.started


def test_mesh_counters_and_lanes_under_threads():
    """The counters the main thread and the admission worker share hold
    every update (a short switch interval, more threads than cores), and
    each thread's lane picks its own group."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.place import MeshParams
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params
    import threading
    cfg = get_config("qwen3-4b", smoke=True)
    mp_ = MeshParams(cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                     Mesh(1, 1))
    mesh = Mesh(2, 2, groups={"main": {"model": "m-main"}, "admission": {"model": "m-adm"}})
    t = torch.zeros(4, dtype=torch.int64)
    embed = mp_["embed"].numel() * mp_["embed"].element_size()
    mp_.gathered_bytes, n, reps, seen = 0, 16, 200, []
    old = sys.getswitchinterval()

    def work(i):
        with mesh.lane("admission" if i % 2 else "main"):
            seen.append((i % 2, mesh._group("model")))
            for _ in range(reps):
                mesh._count("all_gather", t, time.perf_counter())
                mp_["embed"]
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert mesh.stats["all_gather"] == n * reps and mesh.stats["bytes"] == n * reps * 32
    assert mp_.gathered_bytes == n * reps * embed
    assert sorted(set(seen)) == [(0, "m-main"), (1, "m-adm")]
    assert mesh._group("model") == "m-main"
    view = mesh.without("data").with_whole_layers([0])
    mesh.stats = dict.fromkeys(mesh.stats, 0)      # a reset reaches every view
    view.layer(0)._count("all_reduce", t, time.perf_counter())
    assert mesh.stats["all_reduce"] == 1 and view.layer(0).shape["model"] == 1
    with mp_.step():        # one step: a top-level leaf is gathered once
        mp_["embed"], mp_["embed"]
    assert mp_.gathered_bytes == (n * reps + 1) * embed


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
