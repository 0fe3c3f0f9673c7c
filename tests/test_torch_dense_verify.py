"""The dense verify cores of the port (``kernels/dense_decode.py``:
``dense_decode_attention_mq`` / ``_paged``, K5's and K7's dense cores, one
kernel of their own since the dense cache stopped riding K5 / K7 at an
identity R_k) on the CPU, where the wrappers run their plain versions:

* against the JAX package's ``ops.dense_decode_mq`` / ``dense_decode_mq_paged``
  (the Pallas K5 / K7 in interpret mode, behind an identity R_k and
  identity rotation tables), through the port's ``ops.dense_decode_mq*``
  and through the plain versions called directly, on a wrapped ring, a
  partly filled row, an empty row whose query 0 sees only self column 0,
  and a full row, with a feed mask that leaves candidates unfed, with and
  without a window; and on a ragged pool with unmapped slot pages on the
  null page 0; at dh 64 / 80 / 128 / 256, q_per_kv 1 / 2 / 4 / 8 / 16 and
  nq 1 / 2 / 4 / 5 / 9 / 16.  Tolerance atol = rtol = 1e-5 (float32, TF32 off; the
  summation orders differ);
* against the port's old route, K5's / K7's plain versions at an identity
  R_k and identity tables (cos 1, sin 0), within 1e-6 (the same float32
  function, summed in another order; the identity rebuild is exact).

Query 0 of the empty row returns its self value exactly in every version,
and a row masked everywhere (the empty row with candidate 0 unfed) exact 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import kernels
from repro_torch.kernels import dense_decode as D
from repro_torch.kernels import latent_decode as K
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
OLD_ROUTE = dict(atol=1e-6, rtol=1e-6)
B, S, HKV, PS = 4, 24, 2, 4

# (dh, q_per_kv, nq, window)
CASES = [(64, 1, 1, None), (128, 4, 4, None), (128, 8, 5, 6), (64, 4, 5, 6),
         (128, 1, 4, 6), (64, 8, 1, None), (128, 4, 9, 6), (64, 1, 16, None),
         (256, 2, 4, 6), (80, 4, 4, 6), (80, 16, 2, None), (128, 16, 4, 6)]


def _case(dh, qpk, nq, seed):
    """A dense ring of S = 24 slots: row 0 wrapped (positions 36..59, cur
    60), row 1 holding positions 0..9, row 2 empty (cur 0: its query 0
    sees only self column 0), row 3 full (positions 0..23, cur 24); row 0's
    last candidate and row 3's candidates past the first unfed.  Returns
    numpy leaves, cur, the feed mask, q (B, nq, H, dh) and the self entries
    {"k", "v"} (B, nq, Hkv, dh)."""
    rng = np.random.default_rng(seed)
    pos = np.full((B, S), -1, np.int32)
    pos[0] = 36 + (np.arange(S) - 36) % S
    pos[1, :10] = np.arange(10)
    pos[3] = np.arange(S)
    cache = {"k": rng.standard_normal((B, S, HKV, dh)).astype(np.float32),
             "v": rng.standard_normal((B, S, HKV, dh)).astype(np.float32),
             "pos": pos}
    cur = np.array([60, 10, 0, 24], np.int32)
    feed = np.ones((B, nq), bool)
    feed[0, -1] = nq == 1
    feed[3, 1:] = False
    q = rng.standard_normal((B, nq, HKV * qpk, dh)).astype(np.float32)
    entries = {k: rng.standard_normal((B, nq, HKV, dh)).astype(np.float32)
               for k in ("k", "v")}
    return cache, cur, feed, q, entries


def _pool(cache):
    """The ring's slot pages at shuffled physical pages; pages without a
    valid position stay on the null page 0 (positions -1).  Returns
    (pool leaves, ptab (B, S / PS) int32)."""
    n_sp = S // PS
    ptab = np.zeros((B, n_sp), np.int32)
    order = iter(np.random.default_rng(11).permutation(np.arange(1, B * n_sp + 1)))
    pool = {k: np.zeros((B * n_sp + 1, PS) + v.shape[2:], v.dtype)
            for k, v in cache.items()}
    pool["pos"][:] = -1
    for b in range(B):
        for j in range(n_sp):
            if (cache["pos"][b, j * PS:(j + 1) * PS] >= 0).any():
                ptab[b, j] = next(order)
                for k in pool:
                    pool[k][ptab[b, j]] = cache[k][b, j * PS:(j + 1) * PS]
    return pool, ptab


def _t(d):
    return {k: torch.from_numpy(v).long() if k == "pos" else torch.from_numpy(v)
            for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _operands(pos, cur, feed, q, window):
    """The kernel's operands from slot-major positions: the verify bias
    over [ring | nq self columns] and the (query, head) grouped queries."""
    nq = feed.shape[1]
    cur_t = torch.from_numpy(cur).long()
    pos_q = cur_t[:, None] + torch.arange(nq)
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, torch.from_numpy(feed),
                           window, pos.shape[1])
    return bias, ops.group_queries_mq(torch.from_numpy(q), HKV), pos_q


@pytest.mark.parametrize("layout", ["ring", "pool"])
@pytest.mark.parametrize("dh,qpk,nq,window", CASES)
def test_dense_verify_matches_jax_dense_cores(layout, dh, qpk, nq, window):
    """``ops.dense_decode_mq*`` and the plain versions called directly
    against the JAX dense verify cores (Pallas K5 / K7 in interpret mode)."""
    cache, cur, feed, q, entries = _case(dh, qpk, nq, 100 * dh + 10 * qpk + nq)
    kw = dict(window=window, scale=dh ** -0.5)
    sk, sv = torch.from_numpy(entries["k"]), torch.from_numpy(entries["v"])
    args = (jnp.asarray(q), None, jnp.asarray(cur), jnp.asarray(feed), _j(entries))
    if layout == "ring":
        want = jops.dense_decode_mq(args[0], _j(cache), *args[2:], interpret=True,
                                    block_s=8, **kw)
        got = ops.dense_decode_mq(torch.from_numpy(q), _t(cache), torch.from_numpy(cur),
                                  torch.from_numpy(feed), _t(entries), **kw)
        bias, qg, _ = _operands(_t(cache)["pos"], cur, feed, q, window)
        direct = D.dense_decode_attention_mq_plain(
            qg, torch.from_numpy(cache["k"]), torch.from_numpy(cache["v"]), bias,
            scale=dh ** -0.5, self_k=sk, self_v=sv)
    else:
        pool, ptab = _pool(cache)
        tab = torch.from_numpy(ptab)
        want = jops.dense_decode_mq_paged(args[0], _j(pool), jnp.asarray(ptab), *args[2:],
                                          interpret=True, **kw)
        got = ops.dense_decode_mq_paged(torch.from_numpy(q), _t(pool), tab,
                                        torch.from_numpy(cur), torch.from_numpy(feed),
                                        _t(entries), **kw)
        bias, qg, _ = _operands(K.gather_pages(_t(pool)["pos"], tab), cur, feed, q, window)
        direct = D.dense_decode_attention_mq_paged_plain(
            tab, qg, torch.from_numpy(pool["k"]), torch.from_numpy(pool["v"]), bias,
            scale=dh ** -0.5, self_k=sk, self_v=sv)
    want = np.asarray(want)
    # a query its window leaves no column (row 3's queries past the 5th: the
    # window is past the ring and its unfed candidates) is masked everywhere:
    # the port returns exact 0, the Pallas kernel an average of the columns it
    # visits; the engine discards such unfed candidates
    live = (bias.numpy() > ops.NEG_INF * 0.5).any(axis=-1)                 # (B, nq)
    np.testing.assert_allclose(got.numpy()[live], want[live], **TOL)
    ungrouped = ops.ungroup_outputs_mq(direct, nq).numpy()
    np.testing.assert_allclose(ungrouped[live], want[live], **TOL)
    assert (got.numpy()[~live] == 0).all() and (ungrouped[~live] == 0).all()
    # row 2's query 0 sees only self column 0: every head returns its kv head's value
    self_v = np.repeat(entries["v"][2, 0], qpk, axis=0)
    assert np.array_equal(got[2, 0].numpy(), self_v)
    assert np.array_equal(want[2, 0], self_v)


@pytest.mark.parametrize("layout", ["ring", "pool"])
@pytest.mark.parametrize("dh,qpk,nq,window", CASES)
def test_dense_verify_plain_matches_old_identity_route(layout, dh, qpk, nq, window):
    """The plain versions against K5's / K7's plain versions at an identity
    R_k with identity rotation tables, the route the dense cache's verify
    took before it had a kernel of its own."""
    cache, cur, feed, q, entries = _case(dh, qpk, nq, 7 * dh + 3 * qpk + nq)
    sk, sv = torch.from_numpy(entries["k"]), torch.from_numpy(entries["v"])
    eye = torch.eye(dh).expand(HKV, dh, dh).contiguous()
    t = _t(cache)
    kw = dict(scale=dh ** -0.5)
    if layout == "ring":
        pos, lead, ring = t["pos"], (), (t["k"], t["v"])
        plain, old = D.dense_decode_attention_mq_plain, K.latent_decode_attention_mq_plain
    else:
        pool, ptab = _pool(cache)
        p, tab = _t(pool), torch.from_numpy(ptab)
        pos, lead, ring = K.gather_pages(p["pos"], tab), (tab,), (p["k"], p["v"])
        plain = D.dense_decode_attention_mq_paged_plain
        old = K.latent_decode_attention_mq_paged_plain
    bias, qg, pos_q = _operands(pos, cur, feed, q, window)
    cos, sin = ops.rotation_tables(pos, dh, None)
    self_cos, self_sin = ops.rotation_tables(pos_q, dh, None)
    got = plain(*lead, qg, *ring, bias, self_k=sk, self_v=sv, **kw)
    want = old(*lead, qg, *ring, eye, cos, sin, bias, self_zk=sk, self_zv=sv,
               self_cos=self_cos, self_sin=self_sin, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **OLD_ROUTE)
    assert torch.equal(got[2, :, :qpk], sv[2, 0][:, None].expand(HKV, qpk, dh))


@pytest.mark.parametrize("layout", ["ring", "pool"])
def test_dense_verify_row_masked_everywhere_is_zero(layout):
    """Row 2 with candidate 0 unfed: its query 0 sees no column (empty ring,
    self column 0 unfed, later self columns causally masked) and returns
    exact 0 in the wrapper, as in K5's / K7's plain versions; its query 1
    sees self column 1 only and returns that value exactly."""
    cache, cur, feed, q, entries = _case(128, 4, 4, 5)
    feed[2, 0] = False
    kw = dict(window=None, scale=128 ** -0.5)
    if layout == "ring":
        got = ops.dense_decode_mq(torch.from_numpy(q), _t(cache), torch.from_numpy(cur),
                                  torch.from_numpy(feed), _t(entries), **kw)
    else:
        pool, ptab = _pool(cache)
        got = ops.dense_decode_mq_paged(torch.from_numpy(q), _t(pool), torch.from_numpy(ptab),
                                        torch.from_numpy(cur), torch.from_numpy(feed),
                                        _t(entries), **kw)
    assert (got[2, 0] == 0).all()
    assert np.array_equal(got[2, 1].numpy(), np.repeat(entries["v"][2, 1], 4, axis=0))
    assert torch.isfinite(got).all()


def test_dense_verify_counts_no_launch_on_cpu():
    """A CPU tensor runs the plain version: neither the new wrappers nor
    K5 / K7 count a launch."""
    kernels.reset_launch_counts()
    cache, cur, feed, q, entries = _case(64, 4, 4, 3)
    pool, ptab = _pool(cache)
    kw = dict(window=None, scale=0.125)
    ops.dense_decode_mq(torch.from_numpy(q), _t(cache), torch.from_numpy(cur),
                        torch.from_numpy(feed), _t(entries), **kw)
    ops.dense_decode_mq_paged(torch.from_numpy(q), _t(pool), torch.from_numpy(ptab),
                              torch.from_numpy(cur), torch.from_numpy(feed), _t(entries),
                              **kw)
    assert D.dense_decode_attention_mq.launches == 0
    assert D.dense_decode_attention_mq_paged.launches == 0
    assert all(k.launches == 0 for k in kernels.KERNELS)


@pytest.mark.parametrize("B_,Hkv,rows,nq,S_", [(8, 8, 16, 4, 4096), (1, 8, 64, 8, 4096),
                                               (8, 8, 40, 5, 300), (2, 2, 1, 1, 0),
                                               (1, 1, 8, 8, 131072), (8, 8, 64, 16, 4096)])
def test_dense_verify_plan_fits_the_kernel(B_, Hkv, rows, nq, S_):
    """The verify kernel's chunk plan (the same for the ring and the pool):
    whole 32-column tiles, at most 512 columns a block (448 past 4 queries,
    so two bf16 blocks share an SM), chunks that cover the ring and the nq
    self columns, and about two blocks per SM of a 132-SM card where the
    ring is long enough."""
    chunk_len, n_chunks = D.verify_plan(B_, Hkv, rows, nq, S_, 132)
    assert chunk_len % 32 == 0 and 32 <= chunk_len <= (512 if nq <= 4 else 448)
    s_ext = S_ + nq
    assert n_chunks == -(-s_ext // chunk_len) and (n_chunks - 1) * chunk_len < s_ext
    blocks = B_ * Hkv * -(-rows // 16) * n_chunks
    if s_ext >= 4 * 512:
        assert blocks >= 2 * 132 * 0.75
