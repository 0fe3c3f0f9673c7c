"""The einsum readers on a sequence-sharded cache, merged by log-sum-exp,
against the JAX package's unsharded readers; the recurrent state's gather
and write-back; the leaf slicer that follows ``CACHE_RULES``.

Each reader runs once per "model" shard in this process (ring columns, or
a cross source's positions, split over 2 and 4 shards): MLA's absorbed
decode and verify, the cross readers (dense and latent), and the einsum
backend's dense and latent decode and verify.  A first pass records every
shard's (o, m, l) where the reader merges (``ops.merge_einsum``); a
second pass hands each shard the parts merged by ``ops.merge_stacked``,
so the reader's own sharded branch runs: the self and verify-window
columns on the last shard only, and shards whose columns are all masked
(l = 0).  Float32, 1e-5 against JAX on the same numpy-seeded inputs.
"""

import contextlib
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import kv_cache as JKC
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.weights import init_params, params_to_jax
from repro_torch.serving.engine import _merge_slot
from repro_torch.sharding import place as SP
from repro_torch.sharding import rules as R

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

TOL = dict(atol=1e-5, rtol=1e-5)
# the JAX readers compiled whole (one compile each, not one an op); the
# config (and a window) static
J = {name: jax.jit(getattr(JKC, name), static_argnums=(3,))
     for name in ("decode_attn_mla", "verify_attn_mla", "decode_cross_dense",
                  "decode_cross_latent")}
J.update({name: jax.jit(getattr(JKC, name), static_argnums=(3, 5))
          for name in ("decode_attn_dense", "decode_attn_latent")})
J.update({name: jax.jit(getattr(JKC, name), static_argnums=(3, 6))
          for name in ("verify_attn_dense", "verify_attn_latent")})
J.update({name: jax.jit(getattr(JL, name), static_argnums=(2,))
          for name in ("mamba_mixer", "rglru_mixer")})
B, S_RING, NQ = 3, 16, 3
NEG_INF = -1e30


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


class _Shard:
    """Shard i of a (1, n) mesh in this process: its coordinates, and an
    all-gather over "model" that reads every shard's leaf from ``peers``
    (a list of dicts, one a shard)."""

    def __init__(self, i, n, peers=None):
        self.shape = {"data": 1, "model": n}
        self.size = n
        self.index = {"data": 0, "model": i}
        self.peers = peers

    def axis_index(self, axis):
        return self.index[axis]

    def axis_size(self, axis):
        return self.shape[axis]

    def all_gather(self, t, axis, dim=0):
        i = self.index["model"]
        name = next(k for k, v in self.peers[i].items() if v is t)
        return torch.cat([p[name] for p in self.peers], dim=dim)


@contextlib.contextmanager
def _merge_as(fn):
    real = ops.merge_einsum
    ops.merge_einsum = fn
    try:
        yield
    finally:
        ops.merge_einsum = real


def _stacked(fn, n):
    """fn(shard mesh, i) on n shards in turn, merged by ``ops.merge_stacked``:
    the first pass records each shard's (o, m, l) at every merge, the
    second returns the stacked merge there.  Every shard's result must
    agree bit for bit.  Returns (shard 0's result, the recorded parts)."""
    parts = [[] for _ in range(n)]
    for i in range(n):
        with _merge_as(lambda o, m, l, mesh, i=i: parts[i].append((o, m, l)) or o):
            fn(_Shard(i, n), i)
    merged = [ops.merge_stacked(*(torch.stack([parts[i][k][j].float() for i in range(n)])
                                  for j in range(3))).to(parts[0][k][0].dtype)
              for k in range(len(parts[0]))]
    outs = []
    for i in range(n):
        it = iter(merged)
        with _merge_as(lambda o, m, l, mesh: next(it)):
            outs.append(fn(_Shard(i, n), i))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0], parts


def _model(arch, cache="dense", **kw):
    """(port cfg, JAX cfg, port params, JAX params): the float32 smoke
    config, one seeded init read by both (``scan_layers=False``: JAX's
    layers in ``"prefix"``)."""
    extra = {"recalkv_ratio": 0.5} if cache == "latent" else {}
    pcfg = dataclasses.replace(get_config(arch, smoke=True, **extra), dtype=torch.float32,
                               scan_layers=False, attn_backend="einsum", **kw)
    jcfg = dataclasses.replace(jget(arch, smoke=True, **extra), dtype=jnp.float32,
                               scan_layers=False, attn_backend="einsum", **kw)
    pp = init_params(pcfg, torch.Generator().manual_seed(1), device="cpu")
    jp = params_to_jax(pcfg, pp)
    return pcfg, jcfg, pp, jp


def _ring_pos():
    """Row 0 fills columns 8-15 only (the shards holding columns 0-7 see
    nothing of it), row 1 the whole ring (wrapped), row 2 columns 0-5."""
    pos = np.full((B, S_RING), -1, np.int64)
    pos[0, 8:] = np.arange(8)
    pos[1] = np.arange(S_RING) + 4
    pos[2, :6] = np.arange(6)
    return pos, np.array([8, 20, 6])


def _ring(cfg, kind, name):
    """A filled self ring of ``cfg``'s layout (numpy) and its positions."""
    rng = _rng(name)
    empty = KC.init_self_cache(cfg, kind, B, S_RING, "cpu")
    pos, cur = _ring_pos()
    ring = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in empty.items() if k != "pos"}
    ring["pos"] = pos
    return ring, cur


def _cols(d, i, n):
    w = next(iter(d.values())).shape[1] // n
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, i * w:(i + 1) * w]))
            for k, v in d.items()}


def _jtree(d):
    return {k: jnp.asarray(v.astype(np.int32) if k == "pos" else v) for k, v in d.items()}


def _x(cfg, name, nq=1):
    return _rng(name).standard_normal((B, nq, cfg.d_model)).astype(np.float32)


def _feed():
    """Verify candidates: row 0 all fed, row 1 the first two, row 2 one."""
    return np.array([[True, True, True], [True, True, False], [True, False, False]])


def _assert_dead_shard(parts, n):
    """Row 0's columns sit in the last half of the ring: shard 0 sees none
    of them (and no self column), so it has m = NEG_INF and l = 0."""
    _, m, l = parts[0][0]
    assert (l[0] == 0).all() and (m[0] == NEG_INF).all()
    assert (parts[n - 1][0][2][0] > 0).all()


# -- MLA's absorbed decode and verify ------------------------------------------

@pytest.fixture(scope="module")
def mla():
    return _model("deepseek-v3-671b")


@pytest.mark.parametrize("n", [2, 4])
def test_mla_decode_merged_matches_unsharded_jax(mla, n):
    pcfg, jcfg, pp, jp = mla
    ring, cur = _ring(pcfg, "attn_dense", "mla")
    x = _x(pcfg, "mla_x")
    want, _ = J["decode_attn_mla"](jp["prefix"][0]["attn"], jnp.asarray(x), _jtree(ring),
                                  jcfg, jnp.asarray(cur, jnp.int32))
    got, parts = _stacked(lambda mesh, i: KC.decode_attn_mla(
        pp["layers"][0]["attn"], torch.from_numpy(x), _cols(ring, i, n), pcfg,
        torch.from_numpy(cur), mesh=mesh)[0], n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # merged in c_kv space: r_kv floats a head, before the value columns
    assert parts[0][0][0].shape == (B, pcfg.num_heads, pcfg.mla.kv_lora_rank)
    _assert_dead_shard(parts, n)


@pytest.mark.parametrize("n", [2, 4])
def test_mla_verify_merged_matches_unsharded_jax(mla, n):
    pcfg, jcfg, pp, jp = mla
    ring, cur = _ring(pcfg, "attn_dense", "mla_v")
    x, feed = _x(pcfg, "mla_vx", NQ), _feed()
    want, _ = J["verify_attn_mla"](jp["prefix"][0]["attn"], jnp.asarray(x), _jtree(ring),
                                  jcfg, jnp.asarray(cur, jnp.int32), jnp.asarray(feed))
    got, _ = _stacked(lambda mesh, i: KC.verify_attn_mla(
        pp["layers"][0]["attn"], torch.from_numpy(x), _cols(ring, i, n), pcfg,
        torch.from_numpy(cur), torch.from_numpy(feed), mesh=mesh)[0], n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the einsum backend's readers ---------------------------------------------

@pytest.fixture(scope="module", params=["dense", "latent"])
def qwen(request):
    return request.param, _model("qwen3-4b", request.param)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("n", [2, 4])
def test_einsum_decode_merged_matches_unsharded_jax(qwen, n, window):
    cache, (pcfg, jcfg, pp, jp) = qwen
    ring, cur = _ring(pcfg, "attn", f"dec{cache}")
    x = _x(pcfg, f"dec{cache}x")
    jr = J["decode_attn_dense" if cache == "dense" else "decode_attn_latent"]
    pr = KC.decode_attn_dense if cache == "dense" else KC.decode_attn_latent
    want, _ = jr(jp["prefix"][0]["attn"], jnp.asarray(x), _jtree(ring), jcfg,
                 jnp.asarray(cur, jnp.int32), window)
    got, parts = _stacked(lambda mesh, i: pr(
        pp["layers"][0]["attn"], torch.from_numpy(x), _cols(ring, i, n), pcfg,
        torch.from_numpy(cur), window, mesh=mesh)[0], n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_dead_shard(parts, n)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("n", [2, 4])
def test_einsum_verify_merged_matches_unsharded_jax(qwen, n, window):
    cache, (pcfg, jcfg, pp, jp) = qwen
    ring, cur = _ring(pcfg, "attn", f"ver{cache}")
    x, feed = _x(pcfg, f"ver{cache}x", NQ), _feed()
    jr = J["verify_attn_dense" if cache == "dense" else "verify_attn_latent"]
    pr = KC.verify_attn_dense if cache == "dense" else KC.verify_attn_latent
    want, _ = jr(jp["prefix"][0]["attn"], jnp.asarray(x), _jtree(ring), jcfg,
                 jnp.asarray(cur, jnp.int32), jnp.asarray(feed), window)
    got, parts = _stacked(lambda mesh, i: pr(
        pp["layers"][0]["attn"], torch.from_numpy(x), _cols(ring, i, n), pcfg,
        torch.from_numpy(cur), torch.from_numpy(feed), window, mesh=mesh)[0], n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the verify window's columns score on the last shard only
    o, m, l = parts[0][0]
    assert (l[0] == 0).all() and (m[0] == NEG_INF).all()


# -- the cross readers ---------------------------------------------------------

@pytest.mark.parametrize("cache", ["dense", "latent"])
@pytest.mark.parametrize("n", [2, 4])
def test_cross_readers_merged_match_unsharded_jax(cache, n):
    pcfg, jcfg, pp, jp = _model("whisper-small", cache)
    layer = next(i for i, k in enumerate(pcfg.expanded_layers()) if k == "attn_cross")
    rng = _rng(f"cross{cache}")
    src = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
           for k, v in KC.init_cross_cache(pcfg, B, "cpu").items()}
    x = _x(pcfg, f"cross{cache}x", 2)
    jr = J["decode_cross_dense" if cache == "dense" else "decode_cross_latent"]
    pr = KC.decode_cross_dense if cache == "dense" else KC.decode_cross_latent
    want, _ = jr(jp["prefix"][layer]["cross"], jnp.asarray(x), _jtree(src), jcfg)
    got, parts = _stacked(lambda mesh, i: pr(
        pp["layers"][layer]["cross"], torch.from_numpy(x), _cols(src, i, n), pcfg,
        mesh=mesh), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert all(len(p) == 1 for p in parts)          # one merge a call, every shard live
    # a source held whole on every rank (a length "model" does not divide) is not merged
    odd = dataclasses.replace(pcfg, cross_source_len=pcfg.cross_source_len + 1)
    src = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
           for k, v in KC.init_cross_cache(odd, B, "cpu").items()}
    want, _ = jr(jp["prefix"][layer]["cross"], jnp.asarray(x), _jtree(src), jcfg)
    solo = pr(pp["layers"][layer]["cross"], torch.from_numpy(x),
              {k: torch.from_numpy(v) for k, v in src.items()}, odd, mesh=_Shard(0, n))
    np.testing.assert_allclose(solo.numpy(), np.asarray(want), **TOL)


# -- the recurrent state: gathered at read, this rank's channels written -------

@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
@pytest.mark.parametrize("n", [2, 4])
def test_recurrent_state_gather_and_write_back_match_jax(arch, n):
    pcfg, jcfg, pp, jp = _model(arch)
    kind = pcfg.expanded_layers()[0]
    rng = _rng(arch)
    full = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in KC.init_state_cache(pcfg, kind, B, "cpu").items()}
    x = _x(pcfg, f"{arch}x")
    mixer = J["mamba_mixer" if kind == "mamba" else "rglru_mixer"]
    want_y, want_state = mixer(jp["prefix"][0]["mixer"], jnp.asarray(x), jcfg,
                               {k: jnp.asarray(v) for k, v in full.items()})
    pmixer = L.mamba_mixer if kind == "mamba" else L.rglru_mixer
    t = {k: torch.from_numpy(v) for k, v in full.items()}
    meshes = [_Shard(i, n) for i in range(n)]
    shards = [{k: KC.model_slice(v, k, m).clone() for k, v in t.items()} for m in meshes]
    for m in meshes:
        m.peers = shards
    active = torch.tensor([True, False, True])
    news = []
    for i, m in enumerate(meshes):      # every shard reads before any writes
        assert shards[i]["conv"].shape[2] == t["conv"].shape[2] // n     # channels, dim 2
        y, new = pmixer(pp["layers"][0]["mixer"], torch.from_numpy(x), pcfg,
                        KC.read_state(pcfg, kind, shards[i], m))
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        news.append(new)
    for i, m in enumerate(meshes):
        KC.apply_decode_writes([{"state": shards[i]}], [{"state": news[i]}],
                               torch.zeros(B, dtype=torch.int64), active, mesh=m)
    for name, d in (("h", 1), ("conv", 2)):
        got = torch.cat([s[name] for s in shards], dim=d).numpy()
        exp = np.where(active.numpy().reshape((B,) + (1,) * (got.ndim - 1)),
                       np.asarray(want_state[name]), full[name])
        np.testing.assert_allclose(got, exp, **TOL, err_msg=name)


# -- the leaf slicer: every leaf's "model" slice by its spec -------------------

@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b", "whisper-small"])
def test_prefill_merge_slices_each_leaf_by_its_spec(arch):
    """The prefill merge keeps, of each full leaf, this rank's slice along
    the dim ``cache_specs`` split over "model": a ring's positions and a
    cross source's (dim 1), ``h``'s channels (dim 1), ``conv``'s (dim 2)."""
    cfg = get_config(arch, smoke=True)
    full = T.init_decode_cache(cfg, 4, 32, "cpu")
    rng = _rng(f"slice{arch}")
    new = [{part: {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))).to(v.dtype)
                   for k, v in leaves.items()} for part, leaves in layer.items()}
           for layer in full]
    meta = T.init_decode_cache(cfg, 4, 32, "meta")
    specs = R.cache_specs(meta, _Shard(0, 2))
    for i in range(2):
        mesh = _Shard(i, 2)
        local = SP.local_cache(meta, mesh, "cpu")
        slots, rows = torch.tensor([1, 3]), torch.tensor([2, 0])
        _merge_slot(local, new, slots, rows=rows, mesh=mesh)
        for layer, lnew, lspec in zip(local, new, specs):
            for part, leaves in layer.items():
                for name, leaf in leaves.items():
                    want = SP.shard(lnew[part][name][rows], lspec[part][name], mesh)
                    assert torch.equal(leaf[slots], want), (arch, part, name)
    kinds = {name for layer in specs for part in layer.values() for name in part}
    assert {"h", "conv"} <= kinds or "k" in kinds
