"""The port's sharding specs (``repro_torch.sharding.rules``) against the
JAX package's (``repro.sharding.rules``), for every registered arch at
FULL shapes — JAX through ``jax.eval_shape``, the port on the meta device,
so no weights are made — on ("data", "model") meshes of (16, 16), (2, 4),
(1, 4) and (4, 1): params with head grains, the ring, int8 and paged
caches, and the engine's carry."""

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
