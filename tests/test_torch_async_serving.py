"""The port's overlapped serving (``Engine(overlap=True)``: windows in
flight, a backlog thread, an admission thread), ``adaptive_spec`` and
``aot`` against the JAX package and against the port's sync engine.

Per model case (dense, float latents, int8 latents) the JAX engine serves
the prompts once with ``overlap=True`` and the same flags; every port
variant of that case must equal its streams token for token: the port's
sync engine, the overlapped one at pipeline depth 1 / 2 / 3 with and
without the admission thread, the paged pool, speculation with the n-gram
and the layer draft.  JAX's own tests hold its streams invariant to the
pipeline depth, the admission thread, the layout and speculation, so one
JAX run per case is the reference for all of them.  Sampled streams with
chunked prefill are held to one JAX run of their own, and
``adaptive_spec`` to the JAX engine's streams and ``spec_degraded``.

Also the pipeline's contracts (one host sync per harvested window plus
one per admission wave, the profile block, the refusals), its lifecycle
(the backlog thread joins on close, ``run`` with a timeout flushes,
``on_token`` order), the ``TokenBacklog`` and ``AdmissionWorker``
primitives, ``aot`` on the CPU (nothing captured, streams unchanged) and
``check_supported``'s refusal of widths no Hopper body serves.

Float32 with TF32 off; smoke ``qwen3-4b``; streams and counters compared
exactly.
"""

import collections
import dataclasses
import sys
import threading
import time
import warnings

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
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.pipeline import AdmissionWorker, TokenBacklog

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
CASES = {"dense": {}, "latent": {"recalkv_ratio": 0.5},
         "int8_latent": {"recalkv_ratio": 0.5, "cache_quant_bits": 8}}
SAMPLED = dict(temperature=0.9, top_k=32, top_p=0.9, seed=11)
KW = dict(max_slots=4, max_len=40)
CHUNKED = dict(max_slots=4, max_len=40, prefill_chunk=6, sync_every=4)
_MODELS, _REFS = {}, {}


def _model(case):
    """(JAX cfg, JAX params, port cfg, port params), once per case."""
    if case not in _MODELS:
        extra = CASES[case]
        cfg = get_config("qwen3-4b", smoke=True,
                         **{k: v for k, v in extra.items() if k == "recalkv_ratio"})
        cfg = dataclasses.replace(cfg, dtype=jnp.float32,
                                  cache_quant_bits=extra.get("cache_quant_bits"))
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
        pcfg = ModelConfig.from_dict(cfg.to_dict())
        _MODELS[case] = (cfg, params, pcfg,
                         params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                         device="cpu"))
    return _MODELS[case]


def _prompts(vocab, n=6, seed=3):
    g = np.random.default_rng(seed)
    return [g.integers(0, vocab, 5 + 2 * i).astype(np.int32) for i in range(n)]


def _mixed(vocab):
    """Ragged prompts (3-29 tokens), every other one sampled."""
    g = np.random.default_rng(21)
    return [(g.integers(0, vocab, int(g.integers(3, 30))).astype(np.int32), i % 2 == 1)
            for i in range(6)]


def _owed(eng) -> bool:
    """Whether the JAX engine's admission worker has taken requests off the
    queue that it has not handed over yet as a wave."""
    held = sum(len(w.reqs) - w.merged for w in eng._staged_waves)
    return len(eng.scheduler.staged) > held


def _drive_jax(eng):
    """Serve a JAX engine to drain as ``JEngine.run`` does, waiting for its
    admission worker instead of timing out on it.  ``run`` stops after B +
    3 steps without progress, and such a step waits at most 1 s for the
    worker's wave, so a wave prefill slower than a few seconds (its first
    compile on a loaded machine) ended the run before the wave was
    admitted.  Here a step without progress blocks until the worker
    delivers the wave it prepares or owes (it always does, or fails, which
    the next step raises); only steps with nothing owed count toward the
    same idle bound."""
    adm, idle = eng._admission, 0
    while eng.scheduler.has_work or eng._inflight:
        before = (eng.windows, eng.host_syncs, eng._dispatch_index)
        eng.step()
        if (eng.windows, eng.host_syncs, eng._dispatch_index) != before:
            idle = 0
        elif adm is not None and (adm.busy or _owed(eng)):
            adm.wait()
        else:
            idle += 1
            if idle > eng.B + 2:
                break
    eng.flush()
    return eng.finished


def _serve(eng, prompts, max_new=6, sampled=(), on_token=None):
    """Submit, run, close; the streams by uid.  ``sampled`` holds the uids
    that sample (the others are greedy).  A JAX engine is driven by
    ``_drive_jax``, so its admission thread's timing cannot end the run."""
    port = isinstance(eng, Engine)
    R = Request if port else JRequest
    sp = SamplingParams(**SAMPLED) if port else JSamplingParams(**SAMPLED)
    for i, pr in enumerate(prompts):
        eng.submit(R(uid=i, prompt=pr.copy(), max_new_tokens=max_new,
                     sampling=sp if i in sampled else None, on_token=on_token))
    done = eng.run() if port else _drive_jax(eng)
    eng.close()
    assert not eng.scheduler.has_work
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}


def _port(case, prompts=None, max_new=6, sampled=(), kw=KW, **flags):
    _, _, pcfg, pparams = _model(case)
    eng = Engine(pcfg, pparams, device="cpu", **kw, **flags)
    prompts = _prompts(pcfg.vocab_size) if prompts is None else prompts
    return _serve(eng, prompts, max_new, sampled), eng


def _jax(key, case, prompts=None, max_new=6, sampled=(), kw=KW, **flags):
    """One JAX run per ``key``, shared by every test that names it."""
    if key not in _REFS:
        cfg, params, _, _ = _model(case)
        prompts = _prompts(cfg.vocab_size) if prompts is None else prompts
        eng = JEngine(cfg, params, **kw, **flags)
        _REFS[key] = (_serve(eng, prompts, max_new, sampled), eng.metrics())
    return _REFS[key]


@pytest.mark.parametrize("case,backend", [("dense", "kernel"), ("latent", "einsum"),
                                          ("latent", "kernel"), ("int8_latent", "kernel")])
def test_overlap_streams_match_jax_and_sync(case, backend):
    """Greedy, ring: the port's sync and overlapped engines equal the JAX
    overlapped engine, on the dense cache and the float and int8 latent
    rings (the kernel backend runs its plain versions on the CPU)."""
    want, _ = _jax(case, case, overlap=True)
    sync, _ = _port(case, backend=backend)
    got, eng = _port(case, backend=backend, overlap=True)
    assert sync == want, case
    assert got == want, case
    m = eng.metrics()
    assert m["overlap"] is True and m["pipeline_depth"] == 2
    assert m["host_syncs"] == m["windows"] + m["admission_syncs"], m


@pytest.mark.parametrize("depth,thread", [(1, True), (2, False), (3, True), (3, False)])
def test_pipeline_depth_and_admission_thread(depth, thread):
    """Any pipeline depth, with admission prefill on the worker thread or
    inline on the dispatch loop: streams equal the JAX engine's."""
    want, _ = _jax("latent", "latent", overlap=True)
    got, eng = _port("latent", overlap=True, pipeline_depth=depth,
                     admission_thread=thread)
    assert got == want
    m = eng.metrics()
    assert m["pipeline_depth"] == depth and m["admission_thread"] is thread
    assert m["host_syncs"] == m["windows"] + m["admission_syncs"], m


def test_sampled_chunked_matches_jax_and_sync():
    """Mixed greedy / sampled requests through chunked prefill: the first
    tokens sampled at staging and every later one equal the JAX overlapped
    engine's and the port's sync engine's."""
    vocab = _model("latent")[2].vocab_size
    mixed = _mixed(vocab)
    prompts = [p for p, _ in mixed]
    sampled = {i for i, (_, s) in enumerate(mixed) if s}
    want, _ = _jax("sampled", "latent", prompts, sampled=sampled, kw=CHUNKED,
                   overlap=True)
    sync, _ = _port("latent", prompts, sampled=sampled, kw=CHUNKED)
    got, _ = _port("latent", prompts, sampled=sampled, kw=CHUNKED, overlap=True,
                   pipeline_depth=3)
    assert sync == want
    assert got == want


@pytest.mark.parametrize("spec_depth", [0, 2])
def test_paged_overlap_matches_jax_ring(spec_depth):
    """The paged pool under overlap (with n-gram speculation at depth 2)
    equals the JAX overlapped ring engine: layout, pipeline and speculation
    are invisible in the streams."""
    want, _ = _jax("latent", "latent", overlap=True)
    got, eng = _port("latent", overlap=True, cache_layout="paged",
                     spec_depth=spec_depth, draft="ngram" if spec_depth else None)
    assert got == want
    if spec_depth:
        assert eng.metrics()["draft_proposed"] > 0


LAZY = dict(max_slots=4, max_len=40, sync_every=2, cache_layout="paged", page_size=4,
            lazy_pages=True)


@pytest.mark.parametrize("policy", ["fifo", "prefix-affinity"])
def test_lazy_pages_preempt_under_overlap(policy):
    """Lazy pages in a pool too small for the load: the overlapped engine
    preempts (reading the victim's row off the device carry) and re-admits
    (scattering it back, rebuilding recycled pages), with the streams and
    preemption count of the JAX overlapped engine and the streams of the
    port's sync engine; at pipeline depth 3 too.  Under
    prefix-affinity the prompts share a 16-token system prompt and one
    prefix page is pinned.  Both overlapped engines admit inline
    (``admission_thread=False``): the preemption count depends on the
    boundary at which each admission wave merges, and a worker thread
    forms and hands over its waves on its own schedule, so only inline
    admission fixes those boundaries in both packages."""
    vocab = _model("latent")[2].vocab_size
    g = np.random.default_rng(5)
    if policy == "fifo":
        prompts = [g.integers(0, vocab, 7 + 2 * i).astype(np.int32) for i in range(6)]
        kw = dict(LAZY, n_pages=13)
    else:
        sysp = g.integers(0, vocab, 16)
        prompts = [np.concatenate([sysp, g.integers(0, vocab, 3 + i)]).astype(np.int32)
                   for i in range(6)]
        kw = dict(LAZY, n_pages=20, policy=policy, pin_prefixes=1)
    want, jm = _jax(f"lazy-{policy}", "latent", prompts, max_new=16, kw=kw, overlap=True,
                    admission_thread=False)
    sync, _ = _port("latent", prompts, max_new=16, kw=kw)
    got, eng = _port("latent", prompts, max_new=16, kw=kw, overlap=True,
                     admission_thread=False)
    m = eng.metrics()
    assert sync == want
    assert got == want
    assert m["preemptions"] == jm["preemptions"] > 0, (m["preemptions"], jm["preemptions"])
    assert m["pages_free"] + m["pages_parked"] == m["pages_total"] - 1
    # three windows in flight: a rebuild needs the tokens of windows still
    # in flight at the preemption, so it drains the pipeline first
    deep, deng = _port("latent", prompts, max_new=16, kw=kw, overlap=True, pipeline_depth=3,
                       admission_thread=False)
    assert deep == want and deng.metrics()["preemptions"] > 0


@pytest.mark.parametrize("case", ["dense", "int8_latent"])
def test_ngram_spec_overlap_matches_jax(case):
    """n-gram speculation under overlap on the dense and the int8 caches."""
    want, _ = _jax(case, case, overlap=True)
    got, eng = _port(case, overlap=True, spec_depth=2, draft="ngram")
    assert got == want
    assert eng.metrics()["draft_proposed"] > 0


@pytest.mark.parametrize("sampled", [False, True])
def test_layer_draft_overlap_matches_jax(sampled):
    """The layer draft (layers:2) under overlap, greedy and sampled with
    chunked prefill: the accept walk rides the packed-status harvest."""
    if sampled:
        mixed = _mixed(_model("latent")[2].vocab_size)
        prompts = [p for p, _ in mixed]
        uids = {i for i, (_, s) in enumerate(mixed) if s}
        want, _ = _jax("sampled", "latent", prompts, sampled=uids, kw=CHUNKED,
                       overlap=True)
        got, eng = _port("latent", prompts, sampled=uids, kw=CHUNKED, overlap=True,
                         spec_depth=2, draft="layers:2")
    else:
        want, _ = _jax("latent", "latent", overlap=True)
        got, eng = _port("latent", overlap=True, spec_depth=2, draft="layers:2")
    assert got == want
    assert eng.metrics()["draft_proposed"] > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_adaptive_spec_matches_jax(overlap):
    """adaptive_spec with the layer draft over random weights (acceptance
    near 0, so slots degrade): streams and ``spec_degraded`` equal the JAX
    engine's with the same flags, and the streams equal plain decoding."""
    flags = dict(spec_depth=2, draft="layers:2", adaptive_spec=True, overlap=overlap)
    want, jm = _jax(f"adaptive-{overlap}", "latent", max_new=16, **flags)
    plain, _ = _port("latent", max_new=16)
    got, eng = _port("latent", max_new=16, **flags)
    m = eng.metrics()
    assert got == want == plain
    assert m["adaptive_spec"] is True
    assert m["spec_degraded"] == jm["spec_degraded"] > 0, (m["spec_degraded"], jm)


def test_one_sync_per_trailing_window():
    """One host sync per harvested window plus one per admission wave, and
    busy windows keep the one-sync-per-sync_every-tokens bound."""
    _, eng = _port("latent", max_new=16, kw=dict(KW, sync_every=4), overlap=True)
    m = eng.metrics()
    assert m["host_syncs"] == m["windows"] + m["admission_syncs"], m
    assert m["host_syncs"] < m["tokens"], m
    decode_tokens = round(m["windows"] / m["decode_syncs_per_token"])
    busy = (m["windows"] - m["windows_idle"]) / max(decode_tokens, 1)
    assert busy <= 1.0 / 4 + 1e-9, m


def test_counters_hold_under_fast_thread_switches():
    """The backlog and admission threads share the token, first-token and
    prefill counters with the main thread (under the engine's lock): with
    the interpreter switching threads every microsecond, every token and
    every request's first token is counted once, and the streams hold."""
    want, _ = _jax("latent", "latent", overlap=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, eng = _port("latent", overlap=True, pipeline_depth=3)
    finally:
        sys.setswitchinterval(old)
    m = eng.metrics()
    assert got == want
    assert m["tokens"] == sum(len(v) for v in got.values())
    assert eng._ttft_n == len(got)
    assert m["prefill_calls"] == eng._admission.waves_prepared


def test_overlap_metrics_and_profile():
    _, eng = _port("latent", overlap=True, profile=True)
    m = eng.metrics()
    assert m["overlap"] is True and m["aot"] is False and m["captures"] == 0
    assert 0.0 <= m["window_overlap"] <= 1.0
    assert m["ttft_s"] > 0.0 and m["tokens_per_s"] > 0.0
    assert m["windows_idle"] >= 0
    prof = m["profile"]
    for stage in ("dispatch", "harvest", "bookkeep", "admission_stage",
                  "backlog_drain", "admission_worker"):
        assert prof["seconds"][stage] >= 0.0, prof
    assert sum(prof["shares"].values()) == pytest.approx(1.0)
    assert eng._prof_events
    assert all(set(e) == {"stage", "t", "dur"} for e in eng._prof_events)
    _, eng2 = _port("latent", _prompts(_model("latent")[2].vocab_size, n=2),
                    overlap=True)
    assert eng2.metrics()["profile"]["seconds"]["dispatch"] >= 0.0
    assert not eng2._prof_events


def test_aot_on_cpu_captures_nothing():
    """aot=True on the CPU builds nothing and serves the eager window."""
    want, _ = _jax("latent", "latent", overlap=True)
    got, eng = _port("latent", overlap=True, aot=True)
    sync, seng = _port("latent", aot=True)
    assert got == want and sync == want
    for m in (eng.metrics(), seng.metrics()):
        assert m["aot"] is True and m["captures"] == 0 and m["graphs"] == {}


def test_bad_configs_rejected():
    _, _, pcfg, pparams = _model("latent")
    mk = lambda **kw: Engine(pcfg, pparams, max_slots=2, max_len=40, device="cpu", **kw)
    with pytest.raises(ValueError, match="pipeline_depth"):
        mk(overlap=True, pipeline_depth=0)
    with pytest.raises(ValueError, match="overlap=True"):
        mk(pipeline_depth=3)
    with pytest.raises(ValueError, match="admission_thread"):
        mk(admission_thread=True)
    with pytest.raises(ValueError, match="spec_depth"):
        mk(adaptive_spec=True)


def test_check_supported_refuses_kernel_widths_on_cuda():
    """On a CUDA device with the kernel backend, a d_head or q_per_kv no
    Hopper body serves is refused at construction (no card needed: the
    check reads the config); einsum, and every width on the CPU, pass.
    d_head 256 and 80 and q_per_kv 16 have Hopper bodies of their own."""
    base = ModelConfig.from_dict(get_config("qwen3-4b").to_dict())   # d_head 128, q_per_kv 4
    cuda = torch.device("cuda")
    for good in (dict(), dict(d_head=256), dict(d_head=80),
                 dict(num_heads=16 * base.num_kv_heads)):
        check_supported(dataclasses.replace(base, attn_backend="kernel", **good), cuda)
    for bad in (dict(d_head=96), dict(d_head=112),
                dict(num_heads=32 * base.num_kv_heads)):
        cfg = dataclasses.replace(base, attn_backend="kernel", **bad)
        with pytest.raises(NotImplementedError, match="Queue 3 item 2"):
            check_supported(cfg, cuda)
        check_supported(cfg, torch.device("cpu"))
        check_supported(dataclasses.replace(cfg, attn_backend="einsum"), cuda)
        check_supported(cfg)


class TestLifecycle:
    def test_backlog_thread_drains_and_joins_on_close(self):
        _, _, pcfg, pparams = _model("latent")
        eng = Engine(pcfg, pparams, device="cpu", overlap=True, **KW)
        for i, pr in enumerate(_prompts(pcfg.vocab_size, n=4)):
            eng.submit(Request(uid=i, prompt=pr.copy(), max_new_tokens=6))
        done = eng.run()
        assert eng._backlog.started
        eng.close()
        assert not eng._backlog.alive
        assert not [t for t in threading.enumerate()
                    if t.name in ("token-backlog", "admission-prefill")]
        assert all(r.out_tokens for r in done)
        eng.close()                          # idempotent

    def test_context_manager_closes(self):
        _, _, pcfg, pparams = _model("latent")
        with Engine(pcfg, pparams, device="cpu", overlap=True, **KW) as eng:
            eng.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=4))
            eng.run()
        assert not eng._backlog.alive

    def test_run_timeout_counts_completed_windows_and_flushes(self):
        _, _, pcfg, pparams = _model("latent")
        eng = Engine(pcfg, pparams, device="cpu", max_slots=2, max_len=40,
                     overlap=True, sync_every=2)
        for i in range(4):
            eng.submit(Request(uid=i, prompt=np.arange(5), max_new_tokens=30))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng.run(max_steps=1)
        msgs = [str(x.message) for x in w if issubclass(x.category, RuntimeWarning)]
        assert any("completed windows" in m and "max_steps=1" in m for m in msgs), msgs
        assert not eng._inflight
        assert eng.windows >= 1
        emitted = sum(len(r.out_tokens) for r in eng.scheduler.slot_req if r is not None)
        assert emitted == eng.metrics()["tokens"]
        eng.close()

    def test_on_token_streaming_order(self):
        """on_token fires once per token in stream order (on the backlog
        thread under overlap): the callbacks equal out_tokens."""
        _, _, pcfg, pparams = _model("latent")
        seen = {}

        def serve(overlap):
            seen.clear()
            eng = Engine(pcfg, pparams, device="cpu", overlap=overlap, **KW)
            out = _serve(eng, _prompts(pcfg.vocab_size, n=4),
                         on_token=lambda r, t: seen.setdefault(r.uid, []).append(t))
            assert seen == out
            return out

        assert serve(True) == serve(False)

    def test_worker_crash_fails_the_run(self):
        """A prefill that raises on the admission thread fails ``run`` on
        the main thread instead of hanging it."""
        _, _, pcfg, pparams = _model("latent")
        eng = Engine(pcfg, pparams, device="cpu", overlap=True, **KW)

        def boom(*a, **k):
            raise RuntimeError("prefill exploded")

        eng._prefill = boom
        eng.submit(Request(uid=0, prompt=np.arange(5), max_new_tokens=4))
        with pytest.raises(RuntimeError, match="admission-prefill"):
            eng.run()
        eng.close()


class TestTokenBacklog:
    def test_fifo_order_and_lazy_start(self):
        bl = TokenBacklog()
        assert not bl.started
        out = []
        for i in range(100):
            bl.put(lambda i=i: out.append(i))
        bl.flush()
        assert out == list(range(100))
        bl.close()
        assert not bl.alive

    def test_worker_error_reraises_on_main_thread(self):
        bl = TokenBacklog(name="bl-err")
        bl.put(lambda: 1 / 0)
        with pytest.raises(RuntimeError, match="bl-err"):
            bl.flush()
        bl.close()

    def test_close_is_idempotent_and_put_after_close_raises(self):
        bl = TokenBacklog()
        bl.put(lambda: None)
        bl.close()
        bl.close()
        with pytest.raises(RuntimeError, match="closed"):
            bl.put(lambda: None)

    def test_worker_error_reraises_on_put(self):
        bl = TokenBacklog(name="bl-put-err")
        bl.put(lambda: 1 / 0)
        bl._q.join()
        with pytest.raises(RuntimeError, match="bl-put-err"):
            bl.put(lambda: None)
        bl.close()

    def test_worker_error_reraises_on_close(self):
        bl = TokenBacklog(name="bl-close-err")
        bl.put(lambda: 1 / 0)
        with pytest.raises(RuntimeError, match="bl-close-err"):
            bl.close()
        bl.close()

    def test_error_skips_rest_but_preserves_liveness(self):
        ran = []
        bl = TokenBacklog(name="bl-skip")
        bl.put(lambda: ran.append(0))
        bl.put(lambda: 1 / 0)
        bl.put(lambda: ran.append(1))
        with pytest.raises(RuntimeError, match="bl-skip"):
            bl.flush()
        assert ran == [0]
        bl.close()
        assert not bl.alive

    def test_close_during_flush_from_another_thread(self):
        ran = []
        bl = TokenBacklog(name="bl-race")
        for i in range(20):
            bl.put(lambda i=i: (time.sleep(0.005), ran.append(i)))
        flusher = threading.Thread(target=bl.flush)
        flusher.start()
        bl.close()
        flusher.join(timeout=10)
        assert not flusher.is_alive()
        assert ran == list(range(20))
        assert not bl.alive

    def test_fifo_under_slow_consumers(self):
        delays = np.random.default_rng(5).uniform(0.0, 0.004, 50)
        out = []
        bl = TokenBacklog()
        for i, d in enumerate(delays):
            bl.put(lambda i=i, d=d: (time.sleep(d), out.append(i)))
        bl.flush()
        assert out == list(range(50))
        bl.close()


class TestAdmissionWorker:
    def test_prepares_waves_up_to_capacity(self):
        q = collections.deque(range(10))

        def take(n):
            return [q.popleft() for _ in range(min(n, len(q)))]

        w = AdmissionWorker(take, lambda reqs: ("wave", list(reqs)), name="adm-test")
        w.kick(3)
        assert w.wait(timeout=5.0)
        assert w.poll() == [("wave", [0, 1, 2])]
        assert len(q) == 7
        w.close()

    def test_crash_reraises_on_poll_once(self):
        def boom(reqs):
            raise RuntimeError("prefill exploded")

        w = AdmissionWorker(lambda n: [1], boom, name="adm-crash")
        w.kick(1)
        assert w.wait(timeout=5.0)
        with pytest.raises(RuntimeError, match="adm-crash"):
            w.poll()
        assert w.poll() == []
        w.close()

    def test_wait_times_out_when_nothing_upstream(self):
        w = AdmissionWorker(lambda n: [], lambda reqs: reqs, name="adm-idle")
        w.kick(4)
        t0 = time.perf_counter()
        assert not w.wait(timeout=0.2)
        assert time.perf_counter() - t0 < 5.0
        w.close()
