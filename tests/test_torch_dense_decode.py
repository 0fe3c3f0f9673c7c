"""The dense decode cores of the port (``kernels/dense_decode.py``: K1's and
K4's dense cores, one kernel of their own since the dense cache stopped
riding K1 / K4 at an identity R_k) on the CPU, where the wrappers run
their plain versions:

* against the JAX package's ``ops.dense_decode`` / ``dense_decode_paged``
  (the Pallas K1 / K4 in interpret mode, behind an identity R_k and
  identity rotation tables), through the port's ``ops.dense_decode*`` and
  through the plain versions called directly, on a wrapped ring, a
  partly filled row, an empty row that sees only its self column, and a
  window; and on a ragged pool with unmapped slot pages on the null page
  0; at dh 64 / 80 / 128 / 256 and q_per_kv 1 / 2 / 4 / 8 / 16.  Tolerance atol =
  rtol = 1e-5 (float32, TF32 off; the summation orders differ);
* against the port's old route, K1's / K4's plain versions at an identity
  R_k and identity tables (cos 1, sin 0), within 1e-6 (the same float32
  function, summed in another order; the identity rebuild is exact).

An empty row returns its self value exactly in every version.
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

# (dh, q_per_kv, window)
CASES = [(64, 1, None), (128, 4, None), (128, 8, 6), (64, 4, 6), (128, 1, 6),
         (64, 8, None), (256, 2, 6), (80, 4, None), (80, 16, 6), (128, 16, None)]


def _case(dh, qpk, seed):
    """A dense ring of S = 24 slots: row 0 wrapped (positions 36..59, cur
    60), row 1 holding positions 0..9, row 2 empty (cur 0: only its self
    column), row 3 full (positions 0..23, cur 24).  Returns numpy leaves,
    cur, q (B, H, dh) and the self entry {"k", "v"} (B, Hkv, dh)."""
    rng = np.random.default_rng(seed)
    pos = np.full((B, S), -1, np.int32)
    pos[0] = 36 + (np.arange(S) - 36) % S
    pos[1, :10] = np.arange(10)
    pos[3] = np.arange(S)
    cache = {"k": rng.standard_normal((B, S, HKV, dh)).astype(np.float32),
             "v": rng.standard_normal((B, S, HKV, dh)).astype(np.float32),
             "pos": pos}
    cur = np.array([60, 10, 0, 24], np.int32)
    q = rng.standard_normal((B, HKV * qpk, dh)).astype(np.float32)
    entry = {k: rng.standard_normal((B, HKV, dh)).astype(np.float32) for k in ("k", "v")}
    return cache, cur, q, entry


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


@pytest.mark.parametrize("layout", ["ring", "pool"])
@pytest.mark.parametrize("dh,qpk,window", CASES)
def test_dense_decode_matches_jax_dense_cores(layout, dh, qpk, window):
    """``ops.dense_decode*`` and the plain versions called directly against
    the JAX dense cores (Pallas K1 / K4 in interpret mode)."""
    cache, cur, q, entry = _case(dh, qpk, 100 * dh + qpk)
    kw = dict(window=window, scale=dh ** -0.5)
    if layout == "ring":
        want = jops.dense_decode(jnp.asarray(q), _j(cache), jnp.asarray(cur),
                                 self_entry=_j(entry), interpret=True, block_s=8, **kw)
        got = ops.dense_decode(torch.from_numpy(q), _t(cache), torch.from_numpy(cur),
                               self_entry=_t(entry), **kw)
        bias = ops.decode_bias(_t(cache)["pos"], torch.from_numpy(cur), window)
        direct = D.dense_decode_attention_plain(
            ops.group_queries(torch.from_numpy(q), HKV), torch.from_numpy(cache["k"]),
            torch.from_numpy(cache["v"]), bias, scale=dh ** -0.5,
            self_k=torch.from_numpy(entry["k"]), self_v=torch.from_numpy(entry["v"]))
    else:
        pool, ptab = _pool(cache)
        want = jops.dense_decode_paged(jnp.asarray(q), _j(pool), jnp.asarray(ptab),
                                       jnp.asarray(cur), self_entry=_j(entry),
                                       interpret=True, **kw)
        tab = torch.from_numpy(ptab)
        got = ops.dense_decode_paged(torch.from_numpy(q), _t(pool), tab,
                                     torch.from_numpy(cur), self_entry=_t(entry), **kw)
        bias = ops.decode_bias(K.gather_pages(_t(pool)["pos"], tab),
                               torch.from_numpy(cur), window)
        direct = D.dense_decode_attention_paged_plain(
            tab, ops.group_queries(torch.from_numpy(q), HKV), torch.from_numpy(pool["k"]),
            torch.from_numpy(pool["v"]), bias, scale=dh ** -0.5,
            self_k=torch.from_numpy(entry["k"]), self_v=torch.from_numpy(entry["v"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ops.ungroup_outputs(direct).numpy(), np.asarray(want), **TOL)
    # row 2 sees only its self column: every head returns its kv head's value
    self_v = np.repeat(entry["v"][2], qpk, axis=0)
    assert np.array_equal(got[2].numpy(), self_v)
    assert np.array_equal(np.asarray(want)[2], self_v)


@pytest.mark.parametrize("layout", ["ring", "pool"])
@pytest.mark.parametrize("dh,qpk,window", CASES)
def test_dense_decode_plain_matches_old_identity_route(layout, dh, qpk, window):
    """The plain versions against K1's / K4's plain versions at an identity
    R_k with identity rotation tables, the route the dense cache took
    before it had a kernel of its own."""
    cache, cur, q, entry = _case(dh, qpk, 7 * dh + qpk)
    t = _t(cache)
    cur_t = torch.from_numpy(cur)
    qg = ops.group_queries(torch.from_numpy(q), HKV)
    sk, sv = torch.from_numpy(entry["k"]), torch.from_numpy(entry["v"])
    eye = torch.eye(dh).expand(HKV, dh, dh).contiguous()
    self_cos, self_sin = ops.rotation_tables(cur_t, dh, None)
    kw = dict(scale=dh ** -0.5)
    old_kw = dict(kw, self_zk=sk, self_zv=sv, self_cos=self_cos, self_sin=self_sin)
    if layout == "ring":
        bias = ops.decode_bias(t["pos"], cur_t, window)
        cos, sin = ops.rotation_tables(t["pos"], dh, None)
        got = D.dense_decode_attention_plain(qg, t["k"], t["v"], bias, self_k=sk,
                                             self_v=sv, **kw)
        old = K.latent_decode_attention_plain(qg, t["k"], t["v"], eye, cos, sin, bias,
                                              **old_kw)
    else:
        pool, ptab = _pool(cache)
        p, tab = _t(pool), torch.from_numpy(ptab)
        pos = K.gather_pages(p["pos"], tab)
        bias = ops.decode_bias(pos, cur_t, window)
        cos, sin = ops.rotation_tables(pos, dh, None)
        got = D.dense_decode_attention_paged_plain(tab, qg, p["k"], p["v"], bias,
                                                   self_k=sk, self_v=sv, **kw)
        old = K.latent_decode_attention_paged_plain(tab, qg, p["k"], p["v"], eye, cos,
                                                    sin, bias, **old_kw)
    np.testing.assert_allclose(got.numpy(), old.numpy(), **OLD_ROUTE)
    assert torch.equal(got[2], sv[2][:, None].expand(HKV, qpk, dh))


def test_dense_decode_without_self_column_masks_to_zero():
    """No self entry: the empty row is masked everywhere and returns exact
    0 (as K1's plain version and the kernel do); the others match the old
    route."""
    cache, cur, q, _ = _case(128, 4, 5)
    t = _t(cache)
    cur_t = torch.from_numpy(cur)
    qg = ops.group_queries(torch.from_numpy(q), HKV)
    bias = ops.decode_bias(t["pos"], cur_t, None)
    got = D.dense_decode_attention(qg, t["k"], t["v"], bias, scale=128 ** -0.5)
    cos, sin = ops.rotation_tables(t["pos"], 128, None)
    old = K.latent_decode_attention_plain(qg, t["k"], t["v"],
                                          torch.eye(128).expand(HKV, 128, 128), cos, sin,
                                          bias, scale=128 ** -0.5)
    assert (got[2] == 0).all()
    np.testing.assert_allclose(got.numpy(), old.numpy(), **OLD_ROUTE)


def test_dense_decode_counts_no_launch_on_cpu():
    """A CPU tensor runs the plain version: neither the new wrappers nor
    K1 / K4 count a launch."""
    kernels.reset_launch_counts()
    cache, cur, q, entry = _case(64, 4, 3)
    pool, ptab = _pool(cache)
    kw = dict(window=None, scale=0.125)
    ops.dense_decode(torch.from_numpy(q), _t(cache), torch.from_numpy(cur),
                     self_entry=_t(entry), **kw)
    ops.dense_decode_paged(torch.from_numpy(q), _t(pool), torch.from_numpy(ptab),
                           torch.from_numpy(cur), self_entry=_t(entry), **kw)
    assert D.dense_decode_attention.launches == 0
    assert D.dense_decode_attention_paged.launches == 0
    assert all(k.launches == 0 for k in kernels.KERNELS)


@pytest.mark.parametrize("B,Hkv,s_ext", [(8, 8, 4097), (1, 8, 4097), (1, 1, 131072),
                                         (8, 8, 1), (3, 2, 201)])
def test_dense_decode_chunk_plan_fits_the_kernel(B, Hkv, s_ext):
    """The kernel's chunk plan (the same for the ring and the pool): whole
    32-column tiles, at most 512 columns a block, chunks that cover the
    ring plus the self column, and about 8 blocks per SM of a 132-SM card
    where the ring is long enough."""
    chunk_len, n_chunks = D.chunk_plan(B, Hkv, s_ext, 132)
    assert chunk_len % 32 == 0 and 32 <= chunk_len <= 512
    assert n_chunks == -(-s_ext // chunk_len) and (n_chunks - 1) * chunk_len < s_ext
    if s_ext >= 32 * 8 * 132 // (B * Hkv):
        assert 8 * 132 * 0.75 <= B * Hkv * n_chunks <= 8 * 132 * 1.5
