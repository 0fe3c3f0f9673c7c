"""The port's admission policies against the JAX package's: the same
seeded queues, limits and page-budget gates go through both, round after
round, and must select the same requests in the same order and leave the
same queue; the victim choice and the engine's refusals match too.
"""

import dataclasses
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import policy as jpolicy
from repro.serving.scheduler import Request as JRequest
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving import Engine, Request
from repro_torch.serving import policy as ppolicy

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

POLICIES = ("fifo", "prefix-affinity", "reach-packing")


def _requests(seed, n=14, ps=4):
    """Prompts of 2..40 tokens; about half share one of two system
    prompts (so prefix-affinity has sharers to pull forward)."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, 99, 2 * ps) for _ in range(2)]
    out = []
    for uid in range(n):
        tail = rng.integers(0, 99, int(rng.integers(2, 32)))
        pick = rng.integers(3)
        prompt = tail if pick == 2 else np.concatenate([systems[pick], tail])
        out.append((uid, prompt.astype(np.int32), int(rng.integers(1, 9))))
    return out


def _queues(reqs):
    return (deque(JRequest(uid=u, prompt=p, max_new_tokens=m) for u, p, m in reqs),
            deque(Request(uid=u, prompt=p.astype(np.int64), max_new_tokens=m)
                  for u, p, m in reqs))


def _gate(budget):
    """A page-budget gate as the engine builds it: debit a request's
    reach in pages of 4, refuse what does not fit."""
    left = [budget]

    def fits(req):
        need = -(-(len(req.prompt) + req.max_new_tokens) // 4)
        if need > left[0]:
            return False
        left[0] -= need
        return True
    return fits


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_waves_match_jax(policy, seed):
    """Rounds of (limit, budget) until the queues drain: the same waves,
    the same remaining queue, and (reach-packing) the same bypass counts."""
    rng = np.random.default_rng(100 + seed)
    jp, pp = jpolicy.get_policy(policy), ppolicy.get_policy(policy)
    jp.configure(page_size=4)
    pp.configure(page_size=4)
    jq, pq = _queues(_requests(seed))
    rounds = 0
    while jq and rounds < 60:
        limit = int(rng.integers(1, 5))
        budget = int(rng.integers(0, 24))
        gated = rng.random() < 0.9
        want = jp.select(jq, limit, _gate(budget) if gated else None)
        got = pp.select(pq, limit, _gate(budget) if gated else None)
        assert [r.uid for r in got] == [r.uid for r in want], rounds
        assert [r.uid for r in pq] == [r.uid for r in jq], rounds
        if policy == "reach-packing":
            assert pp._bypassed == jp._bypassed
        rounds += 1
    assert not pq


def test_select_without_gate_and_victim_match_jax():
    reqs = _requests(9)
    for name in POLICIES:
        jp, pp = jpolicy.get_policy(name), ppolicy.get_policy(name)
        jp.configure(page_size=4)
        pp.configure(page_size=4)
        jq, pq = _queues(reqs)
        assert ([r.uid for r in pp.select(pq, 6)]
                == [r.uid for r in jp.select(jq, 6)])
        jc = [(s, r) for s, r in zip((3, 1, 5, 0), jq)]
        pc = [(s, r) for s, r in zip((3, 1, 5, 0), pq)]
        assert pp.pick_victim(pc) == jp.pick_victim(jc) == 0
    assert ppolicy.get_policy("prefix-affinity").groups_by_prefix
    assert not ppolicy.get_policy("reach-packing").groups_by_prefix
    inst = ppolicy.ReachPackingPolicy(max_bypass=1)
    assert ppolicy.get_policy(inst) is inst and ppolicy.get_policy(None).name == "fifo"
    with pytest.raises(ValueError, match="unknown admission policy"):
        ppolicy.get_policy("round-robin")
    with pytest.raises(ValueError, match="max_bypass"):
        ppolicy.ReachPackingPolicy(max_bypass=-1)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5),
                              dtype=jnp.float32)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    return cfg, params, pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                              device="cpu")


REFUSALS = {
    # name: (engine keywords, message) — refused by both engines
    "affinity_needs_paged": (dict(policy="prefix-affinity"), "paged"),
    "lazy_needs_paged": (dict(lazy_pages=True), "paged"),
    "lazy_rejects_layer_draft": (dict(cache_layout="paged", page_size=8,
                                      lazy_pages=True, spec_depth=2,
                                      draft="layers:1"), "layer-fraction"),
    "pins_need_paged": (dict(pin_prefixes=2), "paged"),
    "negative_pins": (dict(pin_prefixes=-1), "pin_prefixes"),
    "bad_layout": (dict(cache_layout="blocks"), "cache_layout"),
    "page_size_on_ring": (dict(page_size=8), "paged"),
    "page_size_divides": (dict(cache_layout="paged", page_size=7), "divide"),
    "pool_too_small": (dict(cache_layout="paged", page_size=8, n_pages=5),
                       "one full-length"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_engine_refusals_match_jax(model, case):
    cfg, params, pcfg, pp = model
    kw, msg = REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        JEngine(cfg, params, max_slots=2, max_len=40, **kw)
    with pytest.raises(ValueError, match=msg):
        Engine(pcfg, pp, max_slots=2, max_len=40, device="cpu", **kw)


def test_metrics_report_policy_layer(model):
    _, _, pcfg, pp = model
    eng = Engine(pcfg, pp, max_slots=4, max_len=40, device="cpu",
                 cache_layout="paged", page_size=8, n_pages=33,
                 policy="reach-packing")
    rng = np.random.default_rng(3)
    for i in range(2):
        eng.submit(Request(uid=i, prompt=rng.integers(0, pcfg.vocab_size, 5 + 2 * i),
                           max_new_tokens=4))
    eng.run()
    m = eng.metrics()
    assert (m["policy"], m["lazy_pages"], m["preemptions"]) == ("reach-packing", False, 0)
    assert m["prefill_calls"] > 0 and m["prefill_calls_saved"] == 0
    assert m["pages_free"] + m["pages_parked"] == m["pages_total"] - 1
    ring = Engine(pcfg, pp, max_slots=4, max_len=40, device="cpu").metrics()
    assert (ring["cache_layout"], ring["pages_total"], ring["policy"]) == ("ring", 0, "fifo")
    assert torch.get_default_dtype() == torch.float32
