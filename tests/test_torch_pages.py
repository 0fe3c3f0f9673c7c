"""The port's page pool and prefix registry against the JAX package's:
the same seeded operation sequences go through both, and after every
operation the free order, refcounts, alloc stamps, pins and counters must
be equal, and an operation must raise the same error on both sides.
"""

import numpy as np
import pytest

from repro.serving import pages as jpages
from repro_torch.serving import pages as ppages

OPS = ("alloc", "free", "retain", "fork", "resurrect", "pin", "unpin")


def _state(pool):
    return (list(pool._free), list(pool._ref), list(pool._last_alloc),
            sorted(pool._pinned), pool.share_events, pool.cow_forks,
            pool.peak_used, pool.prefix_resurrections, pool.free_count,
            pool.used, pool.parked, pool.pinned, pool.shared_now)


def _apply(pool, op, arg):
    """(result, exception type name) of one operation."""
    try:
        return getattr(pool, op)(arg), None
    except (ValueError, RuntimeError) as e:
        return None, type(e).__name__


def _sequence(seed, n_pages, n_ops=300):
    """Seeded operations; page arguments are drawn over [-1, n_pages] so
    out-of-range, null-page, free and double-free calls all occur."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        op = OPS[rng.integers(len(OPS))]
        arg = (int(rng.integers(-1, 4)) if op == "alloc"
               else int(rng.integers(-1, n_pages + 1)))
        ops.append((op, arg))
    return ops


@pytest.mark.parametrize("seed,n_pages", [(0, 6), (1, 9), (2, 17), (3, 4),
                                          (4, 33), (5, 12)])
def test_pool_matches_jax_under_seeded_sequences(seed, n_pages):
    jp, pp = jpages.PagePool(n_pages), ppages.PagePool(n_pages)
    errors = 0
    for op, arg in _sequence(seed, n_pages):
        want, jerr = _apply(jp, op, arg)
        got, perr = _apply(pp, op, arg)
        assert (got, perr) == (want, jerr), (op, arg)
        errors += jerr is not None
        assert _state(pp) == _state(jp), (op, arg)
        pp.assert_consistent()
        for pg in range(n_pages):
            assert pp.refcount(pg) == jp.refcount(pg)
            assert pp.alloc_stamp(pg) == jp.alloc_stamp(pg)
            assert pp.is_pinned(pg) == jp.is_pinned(pg)
            assert pp.can_alloc(pg) == jp.can_alloc(pg)
    assert errors > 0          # the sequence reached the error paths


def test_pool_refuses_what_jax_refuses():
    for n in (0, 1):
        with pytest.raises(ValueError, match="null page"):
            jpages.PagePool(n)
        with pytest.raises(ValueError, match="null page"):
            ppages.PagePool(n)
    pp = ppages.PagePool(4)
    with pytest.raises(ValueError, match="alloc"):
        pp.alloc(-1)
    with pytest.raises(RuntimeError, match="exhausted"):
        pp.alloc(4)
    with pytest.raises(ValueError, match="null page"):
        pp.free(ppages.NULL_PAGE)
    (pg,) = pp.alloc(1)
    with pytest.raises(ValueError, match="retain"):
        pp.resurrect(pg)           # a live page is retained, not resurrected


def test_registry_and_prefix_key_match_jax():
    rng = np.random.default_rng(7)
    jr, pr = jpages.PrefixRegistry(), ppages.PrefixRegistry()
    prompts = [rng.integers(0, 50, 24) for _ in range(4)]
    prompts.append(np.concatenate([prompts[0][:8], rng.integers(0, 50, 16)]))
    for ps in (1, 4, 8):
        for prompt in prompts:
            for j in range(len(prompt) // ps):
                k = ppages.prefix_key(prompt.astype(np.int64), j, ps)
                assert k == jpages.prefix_key(prompt.astype(np.int32), j, ps)
    # the shared first 8 tokens give equal keys for pages inside them only
    assert (ppages.prefix_key(prompts[0], 1, 4)
            == ppages.prefix_key(prompts[4], 1, 4))
    assert (ppages.prefix_key(prompts[0], 2, 4)
            != ppages.prefix_key(prompts[4], 2, 4))
    for step in range(60):
        prompt = prompts[rng.integers(len(prompts))]
        key = ppages.prefix_key(prompt, int(rng.integers(4)), 4)
        page = int(rng.integers(1, 12))
        op = rng.integers(3)
        if op == 0:
            jr.register(key, page)
            pr.register(key, page)
        elif op == 1:
            jr.drop_page(page)
            pr.drop_page(page)
        assert pr.lookup(key) == jr.lookup(key)
        assert len(pr) == len(jr)
        assert sorted(pr.pages()) == sorted(jr.pages())
