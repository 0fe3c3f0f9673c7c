"""The port's paged pool against the JAX package: gathered views, writes
through the page table and page wipes; K4's and K7's plain versions
against the Pallas kernels in interpret mode; the paged ops glue; and
``decode_step`` / ``verify_step`` over float and int8 pools.

Float32 with TF32 off.  Tolerances: views, writes and wipes exactly equal;
kernel outputs atol = rtol = 1e-5 (f32 summation order differs); logits
atol 1e-4 (as the ring tests).  Page tables are ragged: pages shuffled
across the pool, unmapped slot pages on the null page 0, and one physical
page shared by two rows.
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
from repro.kernels.latent_decode import latent_decode_attention_mq_paged as jax_k7
from repro.kernels.latent_decode import latent_decode_attention_paged as jax_k4
from repro.models import kv_cache as JKC
from repro.models import transformer as JT
from repro.serving.engine import _merge_slot_paged as jax_merge_paged
from repro_torch.kernels import latent_decode as K
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as KC
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import caches_from_jax, caches_to_jax, params_from_jax

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=0)
THETA = 1e4


def _t(x):
    return torch.from_numpy(np.array(x))


def _pool(seed, ps, n_pages=12, G=2, rk=8, rv=12, B=3, n_sp=5):
    """A ragged pool: row 0 holds 2.5 pages, row 1 four (sharing row 0's
    first page), row 2 nothing (all null).  Returns (ptab, pool, cur)
    with the pool's pos consistent with each row's table."""
    rng = np.random.default_rng(seed)
    ptab = np.zeros((B, n_sp), np.int32)
    ptab[0, :3] = [7, 3, 10]
    ptab[1, :4] = [7, 5, 1, 9]
    pos = np.full((n_pages, ps), -1, np.int32)
    cur = np.array([2 * ps + ps // 2, 4 * ps - 1, 0])
    for b in range(B):
        for j in range(n_sp):
            pg = ptab[b, j]
            if pg:
                t = j * ps + np.arange(ps)
                pos[pg] = np.where(t < cur[b], t, -1)
    pos[11] = np.arange(ps)              # an unmapped page with stale positions
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return ptab, {"zk": f(n_pages, ps, G, rk), "zv": f(n_pages, ps, G, rv),
                  "pos": pos}, cur


def _tables(pos, dh):
    half = dh // 2
    freq = THETA ** (-np.arange(half, dtype=np.float32) / half)
    ang = np.maximum(pos, 0)[..., None].astype(np.float32) * freq
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# -- views, writes, wipes -----------------------------------------------------

@pytest.mark.parametrize("ps", [4, 8])
def test_paged_view_writes_and_wipes_match_jax(ps):
    ptab, pool, cur = _pool(ps, ps)
    rng = np.random.default_rng(ps)
    want = JKC.paged_view({k: jnp.asarray(v) for k, v in pool.items()},
                          jnp.asarray(ptab), ps)
    got = KC.paged_view({k: _t(v) for k, v in pool.items()}, _t(ptab))
    for k in pool:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # decode writes: row 0 at its next position, row 1 inactive, row 2
    # active on an unmapped page (writes nothing)
    upd = {"zk": rng.standard_normal((3,) + pool["zk"].shape[2:]).astype(np.float32),
           "zv": rng.standard_normal((3,) + pool["zv"].shape[2:]).astype(np.float32),
           "pos": cur.astype(np.int32)}
    act = np.array([True, False, True])
    jtree = {"prefix": ({"self": {k: jnp.asarray(v) for k, v in pool.items()}},),
             "blocks": None, "suffix": ()}
    jupd = {"prefix": ({"self": {k: jnp.asarray(v) for k, v in upd.items()}},),
            "blocks": None, "suffix": ()}
    want = JKC.apply_decode_writes(jtree, jupd, jnp.asarray(cur, jnp.int32),
                                   jnp.asarray(act), pages=(jnp.asarray(ptab), ps))
    caches = caches_from_jax_tree(jtree)
    KC.apply_decode_writes(caches, [{"self": {k: _t(v) for k, v in upd.items()}}],
                           _t(cur), _t(act), pages=(_t(ptab), ps))
    _assert_pool_equal(caches[0]["self"], want["prefix"][0]["self"])
    # verify writes: S = 3 columns per row, a partial accept mask; row 1's
    # columns cross a page boundary
    S = 3
    vupd = {"zk": rng.standard_normal((3, S) + pool["zk"].shape[2:]).astype(np.float32),
            "zv": rng.standard_normal((3, S) + pool["zv"].shape[2:]).astype(np.float32),
            "pos": (cur[:, None] + np.arange(S)).astype(np.int32)}
    vcur = np.array([cur[0], 2 * ps - 1, 0])
    mask = np.array([[True, True, False], [True, True, True], [True, False, False]])
    want = JKC.apply_verify_writes(
        want, {"prefix": ({"self": {k: jnp.asarray(v) for k, v in vupd.items()}},),
               "blocks": None, "suffix": ()},
        jnp.asarray(vcur, jnp.int32), jnp.asarray(mask), pages=(jnp.asarray(ptab), ps))
    KC.apply_verify_writes(caches, [{"self": {k: _t(v) for k, v in vupd.items()}}],
                           _t(vcur), _t(mask), pages=(_t(ptab), ps))
    _assert_pool_equal(caches[0]["self"], want["prefix"][0]["self"])
    wipe = np.array([0, 3, 11], np.int32)
    want = JT.wipe_pages(want, jnp.asarray(wipe))
    T.wipe_pages(caches, _t(wipe))
    _assert_pool_equal(caches[0]["self"], want["prefix"][0]["self"])
    assert (caches[0]["self"]["pos"][0] == -1).all()


@pytest.mark.parametrize("seed,ps", [(0, 4), (1, 4), (2, 8), (3, 8)])
def test_paged_writes_past_the_table_match_jax(seed, ps):
    """Decode and verify writes through the page table at positions past
    it, as JAX makes them: the page index clipped to the table's last page,
    the offset pos % page_size, the null page never written, of the rows
    hitting one page in a column only the first, and a verify's columns in
    ascending order (the later wins).  Seeded pools, ragged tables (unmapped
    slot pages, rows 2 and 3 sharing their last page), positions inside,
    at the end of and past the table; the pools must come out equal."""
    rng = np.random.default_rng(seed)
    B, n_sp, n_pages, S = 4, 3, 14, 2 * ps + 3
    ptab = np.zeros((B, n_sp), np.int32)
    pages = rng.permutation(np.arange(1, n_pages))
    ptab[0] = pages[:3]
    ptab[1, :2] = pages[3:5]                     # its last slot page unmapped
    ptab[2] = pages[5:8]
    ptab[3, :2], ptab[3, 2] = pages[8:10], ptab[2, 2]
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pool = {"k": f(n_pages, ps, 2, 8), "v": f(n_pages, ps, 2, 8),
            "pos": rng.integers(-1, 40, (n_pages, ps)).astype(np.int32)}
    end = n_sp * ps
    # row 2 reaches the shared page two columns into a verify, row 3 is
    # past the table from its first: a later column of row 2 must beat an
    # earlier one of row 3 at one offset
    cur = np.array([rng.integers(0, end), end - 1, end - ps - 2, end + ps + 1])
    act = np.array([True, True, bool(rng.integers(0, 2)), True])
    upd = {k: f(B, *v.shape[2:]) for k, v in pool.items() if k != "pos"}
    upd["pos"] = cur.astype(np.int32)
    vupd = {k: f(B, S, *v.shape[2:]) for k, v in pool.items() if k != "pos"}
    vupd["pos"] = (cur[:, None] + np.arange(S)).astype(np.int32)
    vmask = np.arange(S)[None] < np.array([[rng.integers(1, S + 1)], [rng.integers(1, S + 1)],
                                           [S], [S]])
    tree = lambda d: {"prefix": ({"self": {k: jnp.asarray(v) for k, v in d.items()}},),
                      "blocks": None, "suffix": ()}
    jp = (jnp.asarray(ptab), ps)
    want = JKC.apply_decode_writes(tree(pool), tree(upd), jnp.asarray(cur, jnp.int32),
                                   jnp.asarray(act), pages=jp)
    caches = caches_from_jax_tree(tree(pool))
    tp = (_t(ptab), ps)
    KC.apply_decode_writes(caches, [{"self": {k: _t(v) for k, v in upd.items()}}], _t(cur),
                           _t(act), pages=tp)
    _assert_pool_equal(caches[0]["self"], want["prefix"][0]["self"])
    want = JKC.apply_verify_writes(want, tree(vupd), jnp.asarray(cur, jnp.int32),
                                   jnp.asarray(vmask), pages=jp)
    KC.apply_verify_writes(caches, [{"self": {k: _t(v) for k, v in vupd.items()}}], _t(cur),
                           _t(vmask), pages=tp)
    _assert_pool_equal(caches[0]["self"], want["prefix"][0]["self"])


def caches_from_jax_tree(tree):
    return [{"self": {k: _t(np.array(v)).to(torch.int64 if k == "pos" else None)
                      for k, v in tree["prefix"][0]["self"].items()}}]


def _assert_pool_equal(got, want):
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


# -- K4 / K7 plain versions against the Pallas kernels ------------------------

K4_CASES = {
    # name: (page_size, k_norm, window)
    "ps4": (4, False, None),
    "ps8_knorm": (8, True, None),
    "ps4_knorm_window": (4, True, 6),
}


def _q(rng, B, G, rows, dh):
    return rng.standard_normal((B, G, rows, dh)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_plain_matches_pallas_interpret(case):
    ps, knorm, window = K4_CASES[case]
    seed = zlib.crc32(case.encode())
    ptab, pool, cur = _pool(seed, ps)
    rng = np.random.default_rng(seed)
    B, G, dh, s, qpk = 3, 2, 16, 2, 2
    rk, rv = pool["zk"].shape[-1], pool["zv"].shape[-1]
    q = _q(rng, B, G, s * qpk, dh)
    r_k = (rng.standard_normal((G, rk, s * dh)) / np.sqrt(rk)).astype(np.float32)
    k_norm = (0.3 * rng.standard_normal(dh)).astype(np.float32) if knorm else None
    entry = {"zk": rng.standard_normal((B, G, rk)).astype(np.float32),
             "zv": rng.standard_normal((B, G, rv)).astype(np.float32)}
    pos_view = np.asarray(jops._paged_pos_view(jnp.asarray(pool["pos"]), jnp.asarray(ptab)))
    bias, cos, sin = (np.asarray(a) for a in jops._paged_tables(
        jnp.asarray(pos_view), jnp.asarray(cur, jnp.int32), window, dh, THETA, ps))
    scale = dh ** -0.5
    want = np.asarray(jax_k4(
        jnp.asarray(ptab), jnp.asarray(q), jnp.asarray(pool["zk"]), jnp.asarray(pool["zv"]),
        jnp.asarray(r_k), jops._self_tile(jnp.asarray(entry["zk"]), ps),
        jops._self_tile(jnp.asarray(entry["zv"]), ps), jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(bias), scale=scale, interpret=True,
        k_norm=None if k_norm is None else jnp.asarray(k_norm)))
    S = pos_view.shape[1]
    got = K.latent_decode_attention_paged(
        _t(ptab), _t(q), _t(pool["zk"]), _t(pool["zv"]), _t(r_k), _t(cos[:, :S]),
        _t(sin[:, :S]), _t(bias[:, :S]), scale=scale,
        k_norm=None if k_norm is None else _t(k_norm), self_zk=_t(entry["zk"]),
        self_zv=_t(entry["zv"]), self_cos=_t(cos[:, S]), self_sin=_t(sin[:, S]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # K4 is K1 on the gathered view
    ring = K.latent_decode_attention(
        _t(q), K.gather_pages(_t(pool["zk"]), _t(ptab)),
        K.gather_pages(_t(pool["zv"]), _t(ptab)), _t(r_k), _t(cos[:, :S]),
        _t(sin[:, :S]), _t(bias[:, :S]), scale=scale,
        k_norm=None if k_norm is None else _t(k_norm), self_zk=_t(entry["zk"]),
        self_zv=_t(entry["zv"]), self_cos=_t(cos[:, S]), self_sin=_t(sin[:, S]))
    np.testing.assert_array_equal(ring.numpy(), got.numpy())


def test_k4_dead_row_is_exact_zero():
    """Without a self column, the all-null row has no valid column: 0."""
    ptab, pool, cur = _pool(5, 4)
    rng = np.random.default_rng(5)
    pos_view = K.gather_pages(_t(pool["pos"]).long(), _t(ptab))
    bias = ops.decode_bias(pos_view, _t(cur), None)
    cos, sin = ops.rope_tables_for(pos_view, 16, THETA)
    out = K.latent_decode_attention_paged(
        _t(ptab), _t(_q(rng, 3, 2, 4, 16)), _t(pool["zk"]), _t(pool["zv"]),
        _t(rng.standard_normal((2, 8, 32)).astype(np.float32)), cos, sin, bias,
        scale=0.25).numpy()
    assert (out[2] == 0).all() and np.isfinite(out).all() and (out[0] != 0).any()


K7_CASES = {
    # name: (page_size, nq, k_norm, window, drop row 1's last feed column)
    "ps4_nq4_one_self_tile": (4, 4, True, None, False),
    "ps4_nq5_two_self_tiles": (4, 5, False, None, True),
    "ps8_nq3_window": (8, 3, True, 6, False),
}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_plain_matches_pallas_interpret(case):
    ps, nq, knorm, window, drop = K7_CASES[case]
    seed = zlib.crc32(case.encode())
    ptab, pool, cur = _pool(seed, ps)
    rng = np.random.default_rng(seed)
    B, G, dh, s, qpk = 3, 2, 16, 2, 2
    rk, rv = pool["zk"].shape[-1], pool["zv"].shape[-1]
    q = _q(rng, B, G, nq * s * qpk, dh)
    r_k = (rng.standard_normal((G, rk, s * dh)) / np.sqrt(rk)).astype(np.float32)
    k_norm = (0.3 * rng.standard_normal(dh)).astype(np.float32) if knorm else None
    entries = {"zk": rng.standard_normal((B, nq, G, rk)).astype(np.float32),
               "zv": rng.standard_normal((B, nq, G, rv)).astype(np.float32)}
    pos_q = (cur[:, None] + np.arange(nq)).astype(np.int32)
    feed = np.ones((B, nq), bool)
    feed[2] = False                      # row 2: all-null table, nothing fed
    if drop:
        feed[1, -1] = False
    n_st, L, bias, cos, sin = jops._mq_paged_setup(
        jnp.asarray(pool["pos"]), jnp.asarray(ptab), jnp.asarray(pos_q),
        jnp.asarray(feed), window, dh, THETA)
    bias, cos, sin = np.asarray(bias), np.asarray(cos), np.asarray(sin)
    assert n_st == -(-nq // ps)
    scale = dh ** -0.5
    want = np.asarray(jax_k7(
        jnp.asarray(ptab), jnp.asarray(q), jnp.asarray(pool["zk"]), jnp.asarray(pool["zv"]),
        jnp.asarray(r_k), jops._self_tiles_mq(jnp.asarray(entries["zk"]), ps, n_st),
        jops._self_tiles_mq(jnp.asarray(entries["zv"]), ps, n_st), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(bias), scale=scale, interpret=True,
        k_norm=None if k_norm is None else jnp.asarray(k_norm)))
    got = K.latent_decode_attention_mq_paged(
        _t(ptab), _t(q), _t(pool["zk"]), _t(pool["zv"]), _t(r_k), _t(cos[:, :L]),
        _t(sin[:, :L]), _t(bias[:, :, :L + nq]), scale=scale,
        k_norm=None if k_norm is None else _t(k_norm), self_zk=_t(entries["zk"]),
        self_zv=_t(entries["zv"]), self_cos=_t(cos[:, L:L + nq]),
        self_sin=_t(sin[:, L:L + nq])).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[2] == 0).all()           # a dead row is exact 0 on both sides
    assert (want[2] == 0).all()


def test_paged_wrappers_count_nothing_on_cpu_and_raise_elsewhere():
    ptab, pool, cur = _pool(1, 4)
    rng = np.random.default_rng(1)
    pos_view = K.gather_pages(_t(pool["pos"]).long(), _t(ptab))
    cos, sin = ops.rope_tables_for(pos_view, 16, THETA)
    args = [_t(ptab), _t(_q(rng, 3, 2, 8, 16)), _t(pool["zk"]), _t(pool["zv"]),
            _t(rng.standard_normal((2, 8, 32)).astype(np.float32)), cos, sin]
    single = ops.decode_bias(pos_view, _t(cur), None)
    multi = single[:, None].expand(3, 2, -1).contiguous()
    for fn, bias in ((K.latent_decode_attention_paged, single),
                     (K.latent_decode_attention_mq_paged, multi)):
        before = fn.launches
        assert torch.isfinite(fn(*args, bias, scale=0.25)).all()
        assert fn.launches == before
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*[t.to("meta") for t in args], bias.to("meta"), scale=0.25)


# -- ops glue -------------------------------------------------------------------

@pytest.mark.parametrize("ps", [4, 8])
def test_paged_ops_match_jax(ps):
    """ops.latent_decode_paged / latent_decode_mq_paged (tables from the
    gathered positions, self entries as operands) against the JAX ops,
    which append padded self tiles."""
    ptab, pool, cur = _pool(20 + ps, ps)
    rng = np.random.default_rng(ps)
    B, H, G, dh, s = 3, 8, 2, 16, 2
    rk, rv = pool["zk"].shape[-1], pool["zv"].shape[-1]
    r_k = (rng.standard_normal((G, rk, s * dh)) / np.sqrt(rk)).astype(np.float32)
    k_norm = (0.3 * rng.standard_normal(dh)).astype(np.float32)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    ppool = {k: _t(v).to(torch.int64) if k == "pos" else _t(v) for k, v in pool.items()}
    kw = dict(theta=THETA, window=None, scale=dh ** -0.5, norm_eps=1e-6)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    entry = {"zk": rng.standard_normal((B, G, rk)).astype(np.float32),
             "zv": rng.standard_normal((B, G, rv)).astype(np.float32)}
    want = jops.latent_decode_paged(
        jnp.asarray(q), jpool, jnp.asarray(ptab), jnp.asarray(r_k),
        jnp.asarray(cur, jnp.int32), self_entry={k: jnp.asarray(v) for k, v in entry.items()},
        k_norm=jnp.asarray(k_norm), interpret=True, **kw)
    got = ops.latent_decode_paged(
        _t(q), ppool, _t(ptab), _t(r_k), _t(cur),
        self_entry={k: _t(v) for k, v in entry.items()}, k_norm=_t(k_norm), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nq = 3
    qm = rng.standard_normal((B, nq, H, dh)).astype(np.float32)
    entries = {"zk": rng.standard_normal((B, nq, G, rk)).astype(np.float32),
               "zv": rng.standard_normal((B, nq, G, rv)).astype(np.float32)}
    feed = np.array([[True, True, False], [True, True, True], [True, False, False]])
    want = jops.latent_decode_mq_paged(
        jnp.asarray(qm), jpool, jnp.asarray(ptab), jnp.asarray(r_k),
        jnp.asarray(cur, jnp.int32), jnp.asarray(feed),
        {k: jnp.asarray(v) for k, v in entries.items()}, k_norm=jnp.asarray(k_norm),
        interpret=True, **kw)
    got = ops.latent_decode_mq_paged(
        _t(qm), ppool, _t(ptab), _t(r_k), _t(cur), _t(feed),
        {k: _t(v) for k, v in entries.items()}, k_norm=_t(k_norm), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- decode_step / verify_step over pools ---------------------------------------

PS, MAX_LEN, N_PAGES = 4, 32, 21


def _model(bits, backend, seed=3):
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


def _filled_pool(cfg, params):
    """Prefill two prompts (11 and 6 tokens) and scatter their written
    pages into a JAX pool through a ragged table (both rows share their
    first physical page: the prompts share their first 4 tokens)."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    toks[1, :PS] = toks[0, :PS]
    lens = np.array([11, 6])
    prefill = jax.jit(JT.prefill, static_argnums=(0, 4))
    _, new = prefill(cfg, params, jnp.asarray(toks, jnp.int32),
                     jnp.asarray(lens, jnp.int32), MAX_LEN)
    ptab = np.zeros((2, MAX_LEN // PS), np.int32)
    ptab[0, :4] = [9, 2, 14, 5]
    ptab[1, :3] = [9, 17, 3]
    rows, cols, phys = [0, 0, 0, 1, 1], [0, 1, 2, 1, 2], [9, 2, 14, 17, 3]
    pool = JT.init_decode_cache(cfg, 2, MAX_LEN, pages=(N_PAGES, PS))
    pool = jax_merge_paged(pool, new, jnp.asarray(rows), jnp.asarray(cols),
                           jnp.asarray(phys), PS)
    return pool, ptab, lens


STEP_CASES = {
    # name: (cache_quant_bits, jax backend)
    "float_einsum": (None, "einsum"),
    "float_kernel": (None, "pallas"),
    "int8_einsum": (8, "einsum"),
    "int8_kernel": (8, "pallas"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_paged_steps_match_jax(case):
    """One decode step and one S = 4 verify step with a partial commit over
    the same pool: logits, and the pool after the writes."""
    bits, backend = STEP_CASES[case]
    cfg, params, pcfg, pp = _model(bits, backend)
    jpool, ptab, lens = _filled_pool(cfg, params)
    pool = caches_from_jax(pcfg, jax.tree.map(np.asarray, jpool), device="cpu")
    back = caches_to_jax(pcfg, pool)                      # the bridge round trip
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jpool)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jpages, pages = (jnp.asarray(ptab), PS), (_t(ptab), PS)
    jit = types.SimpleNamespace(
        decode=jax.jit(lambda p, c, t, cur, a, pt: JT.decode_step(
            cfg, p, c, t, cur, a, pages=(pt, PS))),
        verify=jax.jit(lambda p, c, t, cur, m, pt: JT.verify_step(
            cfg, p, c, t, cur, m, pages=(pt, PS))),
        commit=jax.jit(lambda c, u, cur, m, pt: JT.commit_verify_writes(
            c, u, cur, m, pages=(pt, PS))))
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, 2)
    act = np.array([True, True])
    want, jpool = jit.decode(params, jpool, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(lens, jnp.int32), jnp.asarray(act), jpages[0])
    got, pool = T.decode_step(pcfg, pp, pool, _t(tok), _t(lens), _t(act), pages=pages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    cur = lens + 1
    fed = rng.integers(0, cfg.vocab_size, (2, 4))
    mask = np.array([[True, True, True, True], [True, True, False, False]])
    want, jupd = jit.verify(params, jpool, jnp.asarray(fed, jnp.int32),
                            jnp.asarray(cur, jnp.int32), jnp.asarray(mask), jpages[0])
    got, upd = T.verify_step(pcfg, pp, pool, _t(fed), _t(cur), _t(mask), pages=pages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    keep = np.array([[True, True, False, False], [True, False, False, False]])
    jpool = jit.commit(jpool, jupd, jnp.asarray(cur, jnp.int32), jnp.asarray(keep),
                       jpages[0])
    T.commit_verify_writes(pool, upd, _t(cur), _t(keep), pages=pages)
    for a, b in zip(jax.tree.leaves(caches_to_jax(pcfg, pool)), jax.tree.leaves(jpool)):
        if a.dtype == np.int32 or a.dtype == np.int8:
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [None, 8])
def test_paged_decode_equals_ring_decode(bits):
    """The same content on a ring and in a pool: a decode step and a
    verify step give the same logits on both layouts."""
    cfg, params, pcfg, pp = _model(bits, "pallas")
    jpool, ptab, lens = _filled_pool(cfg, params)
    pool = caches_from_jax(pcfg, jax.tree.map(np.asarray, jpool), device="cpu")
    ring = [{"self": KC.paged_view(c["self"], _t(ptab))} for c in pool]
    rng = np.random.default_rng(6)
    tok = _t(rng.integers(0, cfg.vocab_size, 2))
    a, _ = T.decode_step(pcfg, pp, pool, tok, _t(lens), pages=(_t(ptab), PS))
    b, _ = T.decode_step(pcfg, pp, ring, tok, _t(lens))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    for c, r in zip(pool, ring):
        for k, v in KC.paged_view(c["self"], _t(ptab)).items():
            np.testing.assert_array_equal(v.numpy(), r["self"][k].numpy())
    fed = _t(rng.integers(0, cfg.vocab_size, (2, 4)))
    mask = torch.ones(2, 4, dtype=torch.bool)
    a, _ = T.verify_step(pcfg, pp, pool, fed, _t(lens) + 1, mask, pages=(_t(ptab), PS))
    b, _ = T.verify_step(pcfg, pp, ring, fed, _t(lens) + 1, mask)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
