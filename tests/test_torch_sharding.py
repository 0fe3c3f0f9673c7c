"""The port's sharding specs (``repro_torch.sharding.rules``) against the
JAX package's (``repro.sharding.rules``), for every registered arch at
FULL shapes — JAX through ``jax.eval_shape``, the port on the meta device,
so no weights are made — on ("data", "model") meshes of (16, 16), (2, 4),
(1, 4) and (4, 1): params with head grains, the ring, int8 and paged
caches, and the engine's carry; the AdamW state (float32 and bf16
moments, the residual) and model inputs, also on the ("pod", "data",
"model") mesh (2, 16, 16) the memory report reads."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as TT
from repro_torch.models import weights as W
from repro_torch.sharding import rules as TR

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

MESHES = [(16, 16), (2, 4), (1, 4), (4, 1)]
KEY = jax.ShapeDtypeStruct((2,), jnp.uint32)


def _jmesh(shape):
    return AbstractMesh(shape, ("data", "model"))


def _tmesh(shape):
    return dict(zip(("data", "model"), shape))


def _path_str(path) -> str:
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)


def _jax_flat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return [(_path_str(path), tuple(spec)) for path, spec in flat]


def _configs(arch, **kw):
    return jconfigs.get_config(arch, **kw), tconfigs.get_config(arch, **kw)


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    jcfg = jconfigs.get_config(arch)
    return jax.eval_shape(functools.partial(JT.init_params, jcfg), KEY)


@functools.lru_cache(maxsize=None)
def _port_meta_params(arch):
    return W.init_params(tconfigs.get_config(arch), torch.Generator(), device="meta")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_specs_equal_jax_for_full_configs(arch):
    jcfg, tcfg = _configs(arch)
    shapes, params = _jax_param_shapes(arch), _port_meta_params(arch)
    for shape in MESHES:
        want = _jax_flat(JR.param_specs(shapes, _jmesh(shape),
                                        grains=JR.head_grains(jcfg)))
        got = TR.param_specs_jax_order(tcfg, params, _tmesh(shape),
                                       grains=TR.head_grains(tcfg))
        assert got == want, (arch, shape)
    # the per-layer tree takes each JAX leaf's spec, a stacked leaf's
    # without its period dim
    mesh = _tmesh((2, 4))
    tree = TR.param_specs(tcfg, params, mesh, grains=TR.head_grains(tcfg))
    flat = dict(TR.param_specs_jax_order(tcfg, params, mesh, grains=TR.head_grains(tcfg)))
    by_id = {}
    for path, tensors, stacked in W.leaves_in_jax_order(tcfg, params):
        for t in tensors:
            by_id[id(t)] = flat[path][1:] if stacked and flat[path] else flat[path]

    def walk(p, s):
        if isinstance(p, dict):
            assert set(p) == set(s)
            for k in p:
                walk(p[k], s[k])
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, s, strict=True):
                walk(a, b)
        else:
            assert s == by_id[id(p)] and len(s) in (0, p.dim()), s
    walk(params, tree)


def _jax_cache_layers(jcfg, tree):
    """The JAX cache spec tree as the port's per-layer list (prefix, then
    the scanned blocks period by period, then the suffix); a stacked
    leaf's spec loses its period dim, a recurrent layer's one-level dict
    becomes ``{"state": ...}``."""
    def conv(block, stacked):
        if not isinstance(next(iter(block.values())), dict):
            block = {"state": block}
        return {part: {k: (tuple(v)[1:] if stacked and tuple(v) else tuple(v))
                       for k, v in leaves.items()} for part, leaves in block.items()}
    layers = [conv(b, False) for b in tree.get("prefix") or ()]
    blocks = tree.get("blocks") or ()
    if blocks:
        n_per = jcfg.num_periods
        for _ in range(n_per):
            layers += [conv(b, True) for b in blocks]
    layers += [conv(b, False) for b in tree.get("suffix") or ()]
    return layers


CACHE_CASES = {
    "ring": ({}, None),
    "latent": ({"recalkv_ratio": 0.5}, None),
    "int8": ({"recalkv_ratio": 0.5, "cache_quant_bits": 8}, None),
    "paged": ({"recalkv_ratio": 0.5}, (129, 16)),
}


def _cache_cases():
    """(arch, case) pairs the arch has: ReCalKV where it applies, the pool
    only for full-length self-attention stacks."""
    out = []
    for arch in jconfigs.ARCHS:
        kinds = set(tconfigs.get_config(arch).expanded_layers())
        for case, (kw, pages) in sorted(CACHE_CASES.items()):
            if "recalkv_ratio" in kw and not jconfigs.RECALKV_APPLICABLE[arch]:
                continue
            if pages is not None and kinds & {"mamba", "rglru", "cross", "attn_cross", "local"}:
                continue
            out.append((arch, case))
    return out


@pytest.mark.parametrize("arch,case", _cache_cases())
def test_cache_specs_equal_jax_for_full_configs(arch, case):
    kw, pages = CACHE_CASES[case]
    kw = dict(kw)
    bits = kw.pop("cache_quant_bits", None)
    jcfg, tcfg = _configs(arch, **kw)
    if bits is not None:
        jcfg = dataclasses.replace(jcfg, cache_quant_bits=bits)
        tcfg = dataclasses.replace(tcfg, cache_quant_bits=bits)
    B, L = 128, 32768
    jtree = jax.eval_shape(functools.partial(JT.init_decode_cache, jcfg, B, L,
                                             pages=pages))
    caches = TT.init_decode_cache(tcfg, B, L, device="meta", pages=pages)
    for shape in MESHES:
        want = _jax_cache_layers(jcfg, jax.tree.map(
            lambda s: s, JR.cache_specs(jtree, _jmesh(shape)),
            is_leaf=lambda x: isinstance(x, P)))
        got = TR.cache_specs(caches, _tmesh(shape))
        assert got == want, (arch, case, shape)


def test_carry_and_stacked_specs_equal_jax():
    B, W_, L = 8, 4, 64
    carry = {"tok": np.zeros(B, np.int64), "keys": np.zeros((B, 2), np.uint32),
             "buf": np.zeros((B, W_), np.int32), "hist": np.zeros((B, L), np.int32),
             "ptab": np.zeros((B, L // 16), np.int32), "temp": np.zeros(B, np.float32),
             "odd": np.zeros((3, 2), np.int32)}
    for shape in MESHES + [(3, 1)]:
        want = {k: tuple(v) for k, v in JR.carry_specs(carry, _jmesh(shape)).items()}
        assert TR.carry_specs(carry, _tmesh(shape)) == want, shape
        for n in (8, 6):
            assert TR.slot_stacked_spec(n, _tmesh(shape)) == tuple(
                JR.slot_stacked_spec(n, _jmesh(shape))), (shape, n)
        for n in (8, 6):
            assert TR.kernel_batch_axes(_tmesh(shape), n) == JR.kernel_batch_axes(
                _jmesh(shape), n)
        assert TR.kernel_seq_shards(_tmesh(shape)) == JR.kernel_seq_shards(_jmesh(shape))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_head_grains_equal_jax(arch):
    jcfg, tcfg = _configs(arch)
    assert TR.head_grains(tcfg) == JR.head_grains(jcfg)


POD = (2, 16, 16)


def _any_mesh(shape):
    """(JAX AbstractMesh, the port's axis sizes) of a 2- or 3-axis shape."""
    names = ("pod", "data", "model")[-len(shape):]
    return AbstractMesh(shape, names), dict(zip(names, shape))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_opt_specs_equal_jax_for_full_configs(arch):
    """``opt_specs`` of the AdamW state at FULL shapes (float32 and bf16
    moments, a float32 residual, the step) against JAX's, leaf for leaf in
    JAX's order: a moment takes the param rules over its own dtype, so a
    bf16 moment can fall under the FSDP threshold its param is over."""
    from repro.optim import adamw as JA
    from repro_torch.sharding.place import spec_by_id
    jcfg, tcfg = _configs(arch)
    shapes, params = _jax_param_shapes(arch), _port_meta_params(arch)
    for mdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jst = jax.eval_shape(functools.partial(JA.init_state, cfg=JA.AdamWConfig(
            moment_dtype=mdt)), shapes)
        jst["residual"] = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                                       shapes)
        tst = {k: W.map_tree(params, lambda t, dt=dt: torch.empty(t.shape, dtype=dt,
                                                                  device="meta"))
               for k, dt in (("mu", tdt), ("nu", tdt), ("residual", torch.float32))}
        tst["step"] = torch.empty((), dtype=torch.int32, device="meta")
        for shape in MESHES + [POD]:
            jm, tm = _any_mesh(shape)
            want = JR.opt_specs(jst, None, jm)
            got = TR.opt_specs(tcfg, tst, tm)
            assert got["step"] == tuple(want["step"]) == ()
            for k in ("mu", "nu", "residual"):
                by_id = spec_by_id(tst[k], got[k])
                flat = [(path, (None,) + by_id[id(ts[0])] if stacked and by_id[id(ts[0])]
                         else by_id[id(ts[0])])
                        for path, ts, stacked in W.leaves_in_jax_order(tcfg, tst[k])]
                assert flat == _jax_flat(want[k]), (arch, k, mdt, shape)


def test_batch_specs_equal_jax():
    """``batch_specs`` against JAX's on inputs whose leading dim the batch
    axes divide, do not divide, and a 0-d leaf, on every mesh and the pod
    mesh."""
    for B in (256, 32, 6, 3, 1):
        leaves = {"tokens": (B, 64), "labels": (B, 64), "lengths": (B,),
                  "source": (B, 10, 8), "scalar": ()}
        jb = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in leaves.items()}
        tb = {k: torch.empty(v, dtype=torch.int32, device="meta") for k, v in leaves.items()}
        for shape in MESHES + [POD, (3, 1)]:
            jm, tm = _any_mesh(shape)
            want = {k: tuple(v) for k, v in JR.batch_specs(jb, jm).items()}
            assert TR.batch_specs(tb, tm) == want, (B, shape)

