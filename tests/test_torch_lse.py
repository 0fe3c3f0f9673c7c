"""The decode kernels' softmax state (``return_lse``) and the sequence-
sharded decode it serves, against the JAX package.

Part one: every plain version's (o, m, l) — K1, K3, K4, K5, K6, K7 and the
dense decode / verify cores — against the Pallas kernels in interpret mode
with ``return_lse=True`` (JAX's dense cores are K1 / K5 at an identity
R_k).  Rows that see no column are compared on o alone where the Pallas
multi-query kernel leaves its running state undefined.

Part two: the ops wrappers on a sequence-sharded cache (ring columns, or
each pool page's offsets, split over 2 and 4 "model" ranks) merged by
log-sum-exp, against JAX's unsharded wrappers.  The ranks are threads of
this process around a mesh whose all-reduce is a barrier and a reduction
over the stacked parts, so the wrappers' own sharded branch runs: the self
columns on the last rank only, rows that see nothing on a rank (l = 0).
Float32, 1e-5.
"""

import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.latent_decode import (latent_decode_attention as jax_k1,
                                         latent_decode_attention_mq as jax_k5,
                                         latent_decode_attention_mq_paged as jax_k7,
                                         latent_decode_attention_paged as jax_k4)
from repro.kernels.latent_decode_q import (latent_decode_attention_mq_quant as jax_k6,
                                           latent_decode_attention_quant as jax_k3)
from repro.quant import quantize as jquant
from repro_torch.kernels import dense_decode as KD
from repro_torch.kernels import latent_decode as K
from repro_torch.kernels import latent_decode_q as KQ
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
THETA = 1e4
B, S, G, s, qpk, dh, rk, rv = 3, 16, 2, 2, 2, 16, 8, 12
H = G * s * qpk                      # query heads; Hkv = G * s for the dense cache


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _ring_pos():
    """Row 0 fills columns 8-15 only (ranks holding columns 0-7 see
    nothing of it), row 1 the whole ring, row 2 columns 0-5."""
    pos = np.full((B, S), -1, np.int64)
    pos[0, 8:] = np.arange(8)
    pos[1] = np.arange(S) + 4
    pos[2, :6] = np.arange(6)
    return pos, np.array([8, 20, 6])


def _tables(pos):
    half = dh // 2
    freq = THETA ** (-np.arange(half, dtype=np.float32) / half)
    ang = np.maximum(pos, 0)[..., None].astype(np.float32) * freq
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _m_l(m, l):
    """JAX's (B, G, rows, 1) state as (B, G, rows)."""
    return np.asarray(m)[..., 0], np.asarray(l)[..., 0]


def _assert_lse(got, want, live=None):
    """(o, m, l) against JAX's; ``live`` (B, G, rows) bool limits m and l
    to rows that see a column."""
    o, m, l = (x.numpy() for x in got)
    wo, (wm, wl) = np.asarray(want[0]), _m_l(*want[1:])
    np.testing.assert_allclose(o, wo, **TOL)
    if live is None:
        live = np.ones(m.shape, bool)
    np.testing.assert_allclose(m[live], wm[live], **TOL)
    np.testing.assert_allclose(l[live], wl[live], **TOL)
    assert (l[~live] == 0).all() and (m[~live] == NEG_INF).all()


# -- part one: the plain versions' (o, m, l) ----------------------------------

def _k1_operands(name, dead_row=None, quant=False):
    rng = _rng(name)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos, cur = _ring_pos()
    cos, sin = _tables(pos)
    bias = np.where((pos >= 0) & (pos <= cur[:, None]), 0.0, NEG_INF).astype(np.float32)
    if dead_row is not None:
        bias[dead_row] = NEG_INF
    a = dict(q=f(B, G, s * qpk, dh), zk=f(B, S, G, rk), zv=f(B, S, G, rv),
             r_k=f(G, rk, s * dh) / np.sqrt(rk), cos=cos, sin=sin, bias=bias,
             k_norm=0.3 * f(dh))
    if quant:
        for k in ("zk", "zv"):
            qv, sc = jquant(_j(a.pop(k)), 8)
            a[k + "_q"], a[k + "_s"] = np.asarray(qv), np.asarray(sc)[..., 0]
    return a


@pytest.mark.parametrize("dead_row", [None, 2])
def test_k1_plain_lse_matches_pallas(dead_row):
    a = _k1_operands(f"k1{dead_row}", dead_row)
    order = ("q", "zk", "zv", "r_k", "cos", "sin", "bias")
    scale = dh ** -0.5
    want = jax_k1(*[_j(a[k]) for k in order], scale=scale, block_s=8, interpret=True,
                  k_norm=_j(a["k_norm"]), return_lse=True)
    got = K.latent_decode_attention(*[_t(a[k]) for k in order], scale=scale,
                                    k_norm=_t(a["k_norm"]), return_lse=True)
    live = np.broadcast_to((a["bias"].max(-1) > NEG_INF / 2)[:, None, None],
                           got[1].shape)
    _assert_lse(got, want, live)
    # the outputs are those without return_lse, bit for bit
    o = K.latent_decode_attention(*[_t(a[k]) for k in order], scale=scale,
                                  k_norm=_t(a["k_norm"]))
    assert torch.equal(o, got[0])


def test_k3_plain_lse_matches_pallas():
    a = _k1_operands("k3", quant=True)
    order = ("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin", "bias")
    scale = dh ** -0.5
    want = jax_k3(*[_j(a[k]) for k in order], scale=scale, block_s=8, interpret=True,
                  k_norm=_j(a["k_norm"]), return_lse=True)
    got = KQ.latent_decode_attention_quant(*[_t(a[k]) for k in order], scale=scale,
                                           k_norm=_t(a["k_norm"]), return_lse=True)
    _assert_lse(got, want)


def _mq_operands(name, nq=3, quant=False):
    """K5 / K6 operands with the nq self columns appended to the ring, as
    the Pallas kernels take them (the plain versions take them too)."""
    rng = _rng(name)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos, cur = _ring_pos()
    pos_q = cur[:, None] + np.arange(nq)
    feed = np.ones((B, nq), bool)
    feed[0, -1] = False
    pos_ext = np.concatenate([pos, pos_q], axis=1)
    cos, sin = _tables(pos_ext)
    bias = np.array(jops.verify_bias(_j(pos_ext), _j(pos_q), _j(feed), None, S))
    a = dict(q=f(B, G, nq * s * qpk, dh), zk=f(B, S + nq, G, rk), zv=f(B, S + nq, G, rv),
             r_k=f(G, rk, s * dh) / np.sqrt(rk), cos=cos, sin=sin, bias=bias,
             k_norm=0.3 * f(dh))
    if quant:
        for k in ("zk", "zv"):
            qv, sc = jquant(_j(a.pop(k)), 8)
            a[k + "_q"], a[k + "_s"] = np.asarray(qv), np.asarray(sc)[..., 0]
    return a


def _mq_live(bias, nq):
    """(B, G, nq * Hg) rows that see a column: the Pallas kernel's state is
    defined there only."""
    live = bias.max(-1) > NEG_INF / 2                       # (B, nq)
    return np.broadcast_to(np.repeat(live, s * qpk, axis=1)[:, None], (B, G, nq * s * qpk))


@pytest.mark.parametrize("quant", [False, True])
def test_k5_k6_plain_lse_matches_pallas(quant):
    a = _mq_operands(f"k5{quant}", quant=quant)
    order = (("q", "zk_q", "zk_s", "zv_q", "zv_s", "r_k", "cos", "sin", "bias") if quant
             else ("q", "zk", "zv", "r_k", "cos", "sin", "bias"))
    jk, tk = (jax_k6, KQ.latent_decode_attention_mq_quant) if quant else (
        jax_k5, K.latent_decode_attention_mq)
    scale = dh ** -0.5
    want = jk(*[_j(a[k]) for k in order], scale=scale, block_s=8, interpret=True,
              k_norm=_j(a["k_norm"]), return_lse=True)
    got = tk(*[_t(a[k]) for k in order], scale=scale, k_norm=_t(a["k_norm"]),
             return_lse=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    live = _mq_live(a["bias"], 3)
    wm, wl = _m_l(*want[1:])
    np.testing.assert_allclose(got[1].numpy()[live], wm[live], **TOL)
    np.testing.assert_allclose(got[2].numpy()[live], wl[live], **TOL)


def _pool(name, ps=4, n_pages=12, n_sp=5):
    """A ragged pool: row 0 2.5 pages, row 1 four (sharing row 0's first),
    row 2 none."""
    rng = _rng(name)
    ptab = np.zeros((B, n_sp), np.int32)
    ptab[0, :3] = [7, 3, 10]
    ptab[1, :4] = [7, 5, 1, 9]
    pos = np.full((n_pages, ps), -1, np.int32)
    cur = np.array([2 * ps + ps // 2, 4 * ps - 1, 0])
    for b in range(B):
        for j in range(n_sp):
            if ptab[b, j]:
                t = j * ps + np.arange(ps)
                pos[ptab[b, j]] = np.where(t < cur[b], t, -1)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return ptab, {"zk": f(n_pages, ps, G, rk), "zv": f(n_pages, ps, G, rv), "pos": pos}, cur


def test_k4_plain_lse_matches_pallas():
    ptab, pool, cur = _pool("k4")
    rng = _rng("k4q")
    ps = pool["pos"].shape[1]
    q = rng.standard_normal((B, G, s * qpk, dh)).astype(np.float32)
    r_k = (rng.standard_normal((G, rk, s * dh)) / np.sqrt(rk)).astype(np.float32)
    entry = {k: rng.standard_normal((B, G, r)).astype(np.float32)
             for k, r in (("zk", rk), ("zv", rv))}
    pos_view = np.asarray(jops._paged_pos_view(_j(pool["pos"]), _j(ptab)))
    bias, cos, sin = (np.asarray(x) for x in jops._paged_tables(
        _j(pos_view), _j(cur.astype(np.int32)), None, dh, THETA, ps))
    scale = dh ** -0.5
    want = jax_k4(_j(ptab), _j(q), _j(pool["zk"]), _j(pool["zv"]), _j(r_k),
                  jops._self_tile(_j(entry["zk"]), ps), jops._self_tile(_j(entry["zv"]), ps),
                  _j(cos), _j(sin), _j(bias), scale=scale, interpret=True, return_lse=True)
    L = pos_view.shape[1]
    got = K.latent_decode_attention_paged(
        _t(ptab), _t(q), _t(pool["zk"]), _t(pool["zv"]), _t(r_k), _t(cos[:, :L]),
        _t(sin[:, :L]), _t(bias[:, :L]), scale=scale, self_zk=_t(entry["zk"]),
        self_zv=_t(entry["zv"]), self_cos=_t(cos[:, L]), self_sin=_t(sin[:, L]),
        return_lse=True)
    _assert_lse(got, want)


def test_k7_plain_lse_matches_pallas():
    ptab, pool, cur = _pool("k7")
    rng = _rng("k7q")
    ps, nq = pool["pos"].shape[1], 3
    q = rng.standard_normal((B, G, nq * s * qpk, dh)).astype(np.float32)
    r_k = (rng.standard_normal((G, rk, s * dh)) / np.sqrt(rk)).astype(np.float32)
    ents = {k: rng.standard_normal((B, nq, G, r)).astype(np.float32)
            for k, r in (("zk", rk), ("zv", rv))}
    pos_q = (cur[:, None] + np.arange(nq)).astype(np.int32)
    feed = np.ones((B, nq), bool)
    feed[1, -1] = False
    n_st, L, bias, cos, sin = jops._mq_paged_setup(_j(pool["pos"]), _j(ptab), _j(pos_q),
                                                   _j(feed), None, dh, THETA)
    bias, cos, sin = np.asarray(bias), np.asarray(cos), np.asarray(sin)
    scale = dh ** -0.5
    want = jax_k7(_j(ptab), _j(q), _j(pool["zk"]), _j(pool["zv"]), _j(r_k),
                  jops._self_tiles_mq(_j(ents["zk"]), ps, n_st),
                  jops._self_tiles_mq(_j(ents["zv"]), ps, n_st), _j(cos), _j(sin),
                  _j(bias), scale=scale, interpret=True, return_lse=True)
    got = K.latent_decode_attention_mq_paged(
        _t(ptab), _t(q), _t(pool["zk"]), _t(pool["zv"]), _t(r_k), _t(cos[:, :L]),
        _t(sin[:, :L]), _t(bias[:, :, :L + nq]), scale=scale, self_zk=_t(ents["zk"]),
        self_zv=_t(ents["zv"]), self_cos=_t(cos[:, L:L + nq]),
        self_sin=_t(sin[:, L:L + nq]), return_lse=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    live = _mq_live(bias[:, :, :L + nq], nq)
    wm, wl = _m_l(*want[1:])
    np.testing.assert_allclose(got[1].numpy()[live], wm[live], **TOL)
    np.testing.assert_allclose(got[2].numpy()[live], wl[live], **TOL)


def _dense_ring(name, nq=None):
    rng = _rng(name)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos, cur = _ring_pos()
    Hkv = G * s
    cache = {"k": f(B, S, Hkv, dh), "v": f(B, S, Hkv, dh), "pos": pos}
    if nq is None:
        return cache, cur, f(B, Hkv, qpk, dh), {"k": f(B, Hkv, dh), "v": f(B, Hkv, dh)}
    return cache, cur, f(B, Hkv, nq * qpk, dh), {"k": f(B, nq, Hkv, dh),
                                                 "v": f(B, nq, Hkv, dh)}


def test_dense_decode_plain_lse_matches_pallas():
    """JAX's dense core is K1 at an identity R_k over the appended ring."""
    cache, cur, qg, entry = _dense_ring("dense")
    jc = {k: _j(v.astype(np.int32) if k == "pos" else v) for k, v in cache.items()}
    arrs, pos = jops._extend_ring(jc, {k: _j(v) for k, v in entry.items()},
                                  _j(cur.astype(np.int32)))
    want = jops._dense_ring_core(_j(qg), arrs, pos, _j(cur.astype(np.int32)), window=None,
                                 scale=dh ** -0.5, block_s=8, interpret=True, with_lse=True)
    got = KD.dense_decode_attention(
        _t(qg), _t(cache["k"]), _t(cache["v"]),
        ops.decode_bias(_t(cache["pos"]), _t(cur), None), scale=dh ** -0.5,
        self_k=_t(entry["k"]), self_v=_t(entry["v"]), return_lse=True)
    _assert_lse(got, want)


def test_dense_verify_plain_lse_matches_pallas():
    nq = 3
    cache, cur, qg, ents = _dense_ring("dense_mq", nq)
    pos_q = cur[:, None] + np.arange(nq)
    feed = np.ones((B, nq), bool)
    feed[2, 1:] = False
    jc = {k: _j(v.astype(np.int32) if k == "pos" else v) for k, v in cache.items()}
    arrs, pos_ext = jops._extend_ring_mq(jc, {k: _j(v) for k, v in ents.items()},
                                         _j(pos_q.astype(np.int32)))
    want = jops._dense_ring_core_mq(_j(qg), arrs, pos_ext, _j(pos_q.astype(np.int32)),
                                    _j(feed), window=None, scale=dh ** -0.5, block_s=8,
                                    interpret=True, with_lse=True)
    bias = ops.verify_bias(torch.cat([_t(cache["pos"]), _t(pos_q)], dim=1), _t(pos_q),
                           _t(feed), None, S)
    got = KD.dense_decode_attention_mq(_t(qg), _t(cache["k"]), _t(cache["v"]), bias,
                                       scale=dh ** -0.5, self_k=_t(ents["k"]),
                                       self_v=_t(ents["v"]), return_lse=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    live = np.broadcast_to(np.repeat(bias.numpy().max(-1) > NEG_INF / 2, qpk, axis=1)[:, None],
                           got[1].shape)
    wm, wl = _m_l(*want[1:])
    np.testing.assert_allclose(got[1].numpy()[live], wm[live], **TOL)
    np.testing.assert_allclose(got[2].numpy()[live], wl[live], **TOL)


# -- part two: sequence-sharded wrappers, merged ---------------------------------

class _Hub:
    """The shared half of an in-process "model" axis: each rank's tensor is
    put in its slot; after a barrier every rank reduces the stacked parts
    in the same order."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.parts = [None] * n

    def reduce(self, i, t, op):
        self.parts[i] = t
        self.barrier.wait()
        x = torch.stack(self.parts)
        out = x.amax(dim=0) if op == "max" else x.sum(dim=0)
        self.barrier.wait()
        return out


class _ThreadMesh:
    """A (1, n) mesh whose ranks are threads (see ``launch.mesh.Mesh``)."""

    def __init__(self, hub, i):
        self.shape = {"data": 1, "model": hub.n}
        self.size = hub.n
        self.index = {"data": 0, "model": i}
        self.hub = hub

    def axis_index(self, axis):
        return self.index[axis]

    def axis_size(self, axis):
        return self.shape[axis]

    def all_reduce(self, t, axis, op="sum"):
        return self.hub.reduce(self.index["model"], t, op)


def _sharded(fn, n):
    """fn(mesh, rank) on n thread ranks; every rank's result must agree
    bit for bit.  Returns rank 0's."""
    hub, out, errs = _Hub(n), [None] * n, []

    def run(i):
        try:
            out[i] = fn(_ThreadMesh(hub, i), i)
        except BaseException as e:   # re-raised below, after the join
            errs.append(e)
            hub.barrier.abort()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errs:
        raise errs[0]
    for o in out[1:]:
        assert torch.equal(o, out[0])
    return out[0]


def _cols(d, i, n, dim=1):
    """Rank i's slice of dim 1 of every leaf of ``d`` (numpy) as tensors."""
    w = next(iter(d.values())).shape[dim] // n
    return {k: _t(v[:, i * w:(i + 1) * w]) for k, v in d.items()}


def _ring_case(name, quant=False, window=None):
    rng = _rng(name)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    pos, cur = _ring_pos()
    cache = {"zk": f(B, S, G, rk), "zv": f(B, S, G, rv), "pos": pos}
    entry = {"zk": f(B, G, rk), "zv": f(B, G, rv)}
    if quant:
        for d in (cache, entry):
            for k in ("zk", "zv"):
                qv, sc = jquant(_j(d.pop(k)), 8)
                d[k + "_q"], d[k + "_s"] = np.asarray(qv), np.asarray(sc)[..., 0]
    return cache, entry, cur, f(B, H, dh), f(G, rk, s * dh) / np.sqrt(rk), 0.3 * f(dh)


def _jtree(d):
    return {k: _j(v.astype(np.int32) if k == "pos" else v) for k, v in d.items()}


@pytest.mark.parametrize("case", ["latent", "int8", "latent_window"])
def test_sharded_ring_decode_matches_unsharded_jax(case):
    cache, entry, cur, q, r_k, kn = _ring_case(case, quant=case == "int8",
                                               window=None)
    window = 6 if case == "latent_window" else None
    kw = dict(theta=THETA, window=window, scale=dh ** -0.5, norm_eps=1e-6)
    want = np.asarray(jops.latent_decode(
        _j(q), _jtree(cache), _j(r_k), _j(cur.astype(np.int32)), interpret=True,
        self_entry=_jtree(entry), k_norm=_j(kn), **kw))
    for n in (2, 4):
        got = _sharded(lambda mesh, i: ops.latent_decode(
            _t(q), _cols(cache, i, n), _t(r_k), _t(cur), self_entry=_cols(entry, 0, 1),
            k_norm=_t(kn), mesh=mesh, **kw), n)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"{case} n={n}")
    # the self column scores once: on every rank it would weigh n times
    solo = ops.latent_decode(_t(q), {k: _t(v) for k, v in cache.items()}, _t(r_k), _t(cur),
                             self_entry={k: _t(v) for k, v in entry.items()}, k_norm=_t(kn),
                             **kw)
    np.testing.assert_allclose(solo.numpy(), want, **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_sharded_ring_verify_matches_unsharded_jax(quant):
    nq = 3
    cache, _, cur, _, r_k, kn = _ring_case(f"mq{quant}", quant=quant)
    rng = _rng(f"mqq{quant}")
    q = rng.standard_normal((B, nq, H, dh)).astype(np.float32)
    ents = {"zk": rng.standard_normal((B, nq, G, rk)).astype(np.float32),
            "zv": rng.standard_normal((B, nq, G, rv)).astype(np.float32)}
    if quant:
        for k in ("zk", "zv"):
            qv, sc = jquant(_j(ents.pop(k)), 8)
            ents[k + "_q"], ents[k + "_s"] = np.asarray(qv), np.asarray(sc)[..., 0]
    feed = np.ones((B, nq), bool)
    feed[0, -1] = False
    kw = dict(theta=THETA, window=None, scale=dh ** -0.5, norm_eps=1e-6)
    want = np.asarray(jops.latent_decode_mq(
        _j(q), _jtree(cache), _j(r_k), _j(cur.astype(np.int32)), _j(feed),
        {k: _j(v) for k, v in ents.items()}, interpret=True, k_norm=_j(kn), **kw))
    for n in (2, 4):
        got = _sharded(lambda mesh, i: ops.latent_decode_mq(
            _t(q), _cols(cache, i, n), _t(r_k), _t(cur), _t(feed),
            {k: _t(v) for k, v in ents.items()}, k_norm=_t(kn), mesh=mesh, **kw), n)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"n={n}")


def _pool_shard(pool, i, n):
    """Rank i's slice of every page's offsets."""
    return _cols(pool, i, n)


@pytest.mark.parametrize("nq", [None, 3])
def test_sharded_pool_matches_unsharded_jax(nq):
    """K4 / K7 over page offsets split 2 and 4 ways (page size 4): the page
    table stays global."""
    ptab, pool, cur = _pool(f"pool{nq}")
    rng = _rng(f"poolq{nq}")
    r_k = (rng.standard_normal((G, rk, s * dh)) / np.sqrt(rk)).astype(np.float32)
    kw = dict(theta=THETA, window=None, scale=dh ** -0.5, norm_eps=1e-6)
    if nq is None:
        q = rng.standard_normal((B, H, dh)).astype(np.float32)
        entry = {k: rng.standard_normal((B, G, r)).astype(np.float32)
                 for k, r in (("zk", rk), ("zv", rv))}
        want = np.asarray(jops.latent_decode_paged(
            _j(q), _jtree(pool), _j(ptab), _j(r_k), _j(cur.astype(np.int32)),
            interpret=True, self_entry={k: _j(v) for k, v in entry.items()}, **kw))
        run = lambda mesh, i, n: ops.latent_decode_paged(
            _t(q), _pool_shard(pool, i, n), _t(ptab), _t(r_k), _t(cur),
            self_entry={k: _t(v) for k, v in entry.items()}, mesh=mesh, **kw)
    else:
        q = rng.standard_normal((B, nq, H, dh)).astype(np.float32)
        ents = {k: rng.standard_normal((B, nq, G, r)).astype(np.float32)
                for k, r in (("zk", rk), ("zv", rv))}
        feed = np.ones((B, nq), bool)
        feed[1, -1] = False
        want = np.asarray(jops.latent_decode_mq_paged(
            _j(q), _jtree(pool), _j(ptab), _j(r_k), _j(cur.astype(np.int32)), _j(feed),
            {k: _j(v) for k, v in ents.items()}, interpret=True, **kw))
        run = lambda mesh, i, n: ops.latent_decode_mq_paged(
            _t(q), _pool_shard(pool, i, n), _t(ptab), _t(r_k), _t(cur), _t(feed),
            {k: _t(v) for k, v in ents.items()}, mesh=mesh, **kw)
    for n in (2, 4):
        got = _sharded(lambda mesh, i: run(mesh, i, n), n)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"nq={nq} n={n}")


@pytest.mark.parametrize("case", ["decode", "verify", "paged_decode", "paged_verify"])
def test_sharded_dense_matches_unsharded_jax(case):
    nq = 3 if "verify" in case else None
    rng = _rng(f"dense_{case}")
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    Hkv = G * s
    kw = dict(window=None, scale=dh ** -0.5)
    if "paged" in case:
        ptab, pool, cur = _pool(case)
        cache = {"k": f(*pool["pos"].shape, Hkv, dh), "v": f(*pool["pos"].shape, Hkv, dh),
                 "pos": pool["pos"]}
    else:
        pos, cur = _ring_pos()
        cache = {"k": f(B, S, Hkv, dh), "v": f(B, S, Hkv, dh), "pos": pos}
    if nq is None:
        q = f(B, H, dh)
        entry = {"k": f(B, Hkv, dh), "v": f(B, Hkv, dh)}
        jargs = dict(self_entry={k: _j(v) for k, v in entry.items()})
        targs = dict(self_entry={k: _t(v) for k, v in entry.items()})
        lead, tail = (), ()
    else:
        q = f(B, nq, H, dh)
        ents = {"k": f(B, nq, Hkv, dh), "v": f(B, nq, Hkv, dh)}
        feed = np.ones((B, nq), bool)
        feed[0, -1] = False
        jargs, targs = {}, {}
        lead = (_j(feed), {k: _j(v) for k, v in ents.items()})
        tail = (_t(feed), {k: _t(v) for k, v in ents.items()})
    jcur, tcur = _j(cur.astype(np.int32)), _t(cur)
    if case == "decode":
        want = jops.dense_decode(_j(q), _jtree(cache), jcur, interpret=True, **jargs, **kw)
        run = lambda mesh, i, n: ops.dense_decode(_t(q), _cols(cache, i, n), tcur,
                                                  mesh=mesh, **targs, **kw)
    elif case == "verify":
        want = jops.dense_decode_mq(_j(q), _jtree(cache), jcur, *lead, interpret=True, **kw)
        run = lambda mesh, i, n: ops.dense_decode_mq(_t(q), _cols(cache, i, n), tcur, *tail,
                                                     mesh=mesh, **kw)
    elif case == "paged_decode":
        want = jops.dense_decode_paged(_j(q), _jtree(cache), _j(ptab), jcur, interpret=True,
                                       **jargs, **kw)
        run = lambda mesh, i, n: ops.dense_decode_paged(
            _t(q), _cols(cache, i, n), _t(ptab), tcur, mesh=mesh, **targs, **kw)
    else:
        want = jops.dense_decode_mq_paged(_j(q), _jtree(cache), _j(ptab), jcur, *lead,
                                          interpret=True, **kw)
        run = lambda mesh, i, n: ops.dense_decode_mq_paged(
            _t(q), _cols(cache, i, n), _t(ptab), tcur, *tail, mesh=mesh, **kw)
    for n in (2, 4):
        got = _sharded(lambda mesh, i: run(mesh, i, n), n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{case} n={n}")


def test_merge_stacked_drops_ranks_that_see_nothing():
    """A part with l = 0 (m = NEG_INF) weighs nothing; a row no part sees
    is exact 0; two live parts merge to the joint softmax."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 6)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    want = torch.softmax(logits, -1) @ v
    parts = []
    for sl in (slice(0, 4), slice(4, 6)):
        m = logits[:, sl].amax(-1)
        e = torch.exp(logits[:, sl] - m[:, None])
        parts.append((e @ v[sl] / e.sum(-1, keepdim=True), m, e.sum(-1)))
    dead = (torch.zeros(2, 3), torch.full((2,), NEG_INF), torch.zeros(2))
    for ps in (parts, parts + [dead]):
        o, m, l = (torch.stack(x) for x in zip(*ps))
        np.testing.assert_allclose(ops.merge_stacked(o, m, l).numpy(), want.numpy(), **TOL)
    o, m, l = (torch.stack(x) for x in zip(dead, dead))
    assert (ops.merge_stacked(o, m, l) == 0).all()
