"""Rule-based sharding specs for the port's trees (port of
``repro.sharding.rules``).

A spec is a plain tuple with one entry per dim: a mesh axis name, a tuple
of axis names, or None (replicated) — the meaning of a JAX
``PartitionSpec``; ``()`` is fully replicated.  A mesh is anything with a
``shape`` mapping axis name -> size (``launch.mesh.Mesh``, or a dict).

Each rule is an ordered preference list of (mesh axis, dim) assignments;
an assignment applies only if the dim divides by the axis size (and, for
the FSDP axis "data", only if the leaf is big enough to be worth
gathering).  Whatever does not fit stays replicated:

  * "model" shards attention heads, FFN width, MoE experts and vocab;
  * "data" (FSDP) shards a second dim of large parameters;
  * decode caches shard the slot dim over the batch axes and the
    SEQUENCE dim over "model" (ring positions, or a pool page's offsets),
    so a decode step is sequence-parallel flash decoding: each "model"
    rank scores its slice and the partial softmaxes merge by log-sum-exp
    (``kernels.ops``).

The param rules read the JAX package's layout of the tree
(``models.weights.leaves_in_jax_order``): with ``scan_layers`` a scanned
block's leaf is stacked over its periods, and the FSDP threshold reads the
stacked leaf's bytes, so the port's per-layer leaf gets the stacked
leaf's spec without its leading period dim — the specs the JAX package
gives, leaf for leaf.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import weights as W

Spec = tuple

# (axis, dim) preference lists; dim indexes the logical tensor (a stacked
# block leaf's leading period dim is skipped).
_OUT = (("model", -1), ("data", 0))      # y = x @ W: shard W's output dim
_IN = (("model", 0), ("data", -1))       # shard W's input (contraction) dim

PARAM_RULES: dict[str, tuple] = {
    "embed": (("model", 0), ("data", 1)),
    "lm_head": (("model", 1), ("data", 0)),
    "wq": _OUT, "wk": _OUT, "wv": _OUT,
    "wo": _IN,
    "wq_a": _OUT, "wq_b": _OUT, "wkv_a": _OUT, "wkv_b": _OUT,
    # ReCalKV latent factors: small, replicated (the cache shards on S)
    "l_k": (), "r_k": (), "l_v": (),
    "wo_fused": (("model", 0), ("data", 2)),
    "wi": (("model", -1), ("data", 0)),
    "wg": (("model", -1), ("data", 0)),
    "in_proj": _OUT, "x_proj": _IN, "dt_proj": _OUT, "out_proj": _IN,
    "conv_w": (("model", -1),),
    "A_log": (("model", 0),),
    "in_main": _OUT, "in_gate": _OUT, "w_a": _IN, "w_x": _IN,
    # router: tiny, and its output feeds a global top-k -> replicated
    "router": (),
}

# 3-D MoE expert weights: experts over "model", FSDP over dim 1.
MOE_RULES = {
    "wi": (("model", 0), ("data", 1)),
    "wg": (("model", 0), ("data", 1)),
    "wo": (("model", 0), ("data", 1)),
}

# Ring leaves are (slots, max_len, ...) and pool leaves (n_pages,
# page_size, ...): the same specs shard the ring slot x sequence and the
# pool page-major x page offset.
CACHE_RULES: dict[str, tuple] = {
    "k": (("batch", 0), ("model", 1)),
    "v": (("batch", 0), ("model", 1)),
    "zk": (("batch", 0), ("model", 1)),
    "zv": (("batch", 0), ("model", 1)),
    "pos": (("batch", 0), ("model", 1)),
    "ckv": (("batch", 0), ("model", 1)),
    "krope": (("batch", 0), ("model", 1)),
    "h": (("batch", 0), ("model", 1)),
    "conv": (("batch", 0), ("model", 2)),
}

FSDP_THRESHOLD_BYTES = 1 << 24          # 16 MiB (after TP) turns FSDP on
ZERO3_THRESHOLD_BYTES = 1 << 28         # 256 MiB: FSDP spans pods too


def axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a mesh, or of a plain mapping."""
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def batch_axes(mesh) -> tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _batch_entry(mesh):
    names = batch_axes(mesh)
    return names if len(names) > 1 else names[0]


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    import numpy as np
    return np.dtype(dtype).itemsize


def _resolve(prefs, shape, dtype, mesh, offset: int) -> Spec:
    """Apply a preference list with the divisibility and size checks."""
    sizes = axis_sizes(mesh)
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    size = math.prod(shape) * _itemsize(dtype)
    for axis, dim in prefs:
        d = dim + offset if dim >= 0 else ndim + dim
        if not (offset <= d < ndim) or spec[d] is not None:
            continue
        if axis == "batch":
            names = batch_axes(mesh)
            n = math.prod(sizes[a] for a in names)
            if names and shape[d] % n == 0:
                spec[d] = _batch_entry(mesh)
                size //= n
            continue
        if axis not in sizes:
            continue
        n = sizes[axis]
        if axis == "data":
            if size < FSDP_THRESHOLD_BYTES:
                continue
            if size >= ZERO3_THRESHOLD_BYTES and "pod" in sizes:
                np_ = n * sizes["pod"]
                if shape[d] % np_ == 0:
                    spec[d] = ("data", "pod")
                    size //= np_
                    continue
        if shape[d] % n != 0:
            continue
        spec[d] = axis
        size //= n
    return tuple(spec)


def head_grains(cfg) -> dict[str, int]:
    """"model" sharding grain per attention projection: a tile narrower
    than a head (or than MLA's latent ‖ rope slice) would split a head's
    rotation pairs across ranks, so such a leaf keeps its output dim
    whole."""
    mla = getattr(cfg, "mla", None)
    if mla is not None:
        return {"wq_b": mla.qk_nope_dim + mla.qk_rope_dim,
                "wkv_a": mla.kv_lora_rank + mla.qk_rope_dim,
                "wkv_b": mla.qk_nope_dim + mla.v_head_dim}
    return dict.fromkeys(("wq", "wk", "wv"), cfg.d_head)


def _spec_for(names: list[str], shape, dtype, mesh, rules, grains=None) -> Spec:
    name = names[-1]
    offset = 1 if (names and names[0] == "blocks") else 0
    if rules is CACHE_RULES:
        prefs = rules.get(name, (("batch", 0),))
    elif name in MOE_RULES and len(shape) - offset == 3 and "mlp" in names:
        prefs = MOE_RULES[name]
    else:
        prefs = rules.get(name, ())
    if len(shape) - offset < 1 or not prefs:
        return ()
    sizes = axis_sizes(mesh)
    grain = grains.get(name) if grains else None
    if grain and "model" in sizes and shape[-1] % (sizes["model"] * grain):
        prefs = tuple(p for p in prefs if p != ("model", -1))
    return _resolve(prefs, shape, dtype, mesh, offset)


def param_specs_jax_order(cfg, params, mesh, grains=None) -> list[tuple[str, Spec]]:
    """(JAX path, spec) of every leaf of the JAX package's tree for
    ``cfg``'s layout, in its flat order: the specs
    ``repro.sharding.rules.param_specs`` gives (a stacked leaf's spec
    has its leading period dim)."""
    out = []
    for path, tensors, stacked in W.leaves_in_jax_order(cfg, params):
        shape = tuple(tensors[0].shape)
        if stacked:
            shape = (len(tensors),) + shape
        out.append((path, _spec_for(path.split("/"), shape, tensors[0].dtype,
                                    mesh, PARAM_RULES, grains)))
    return out


def param_specs(cfg, params, mesh, grains=None):
    """Spec tree in the port's params layout (``params`` may hold meta
    tensors): each per-layer leaf takes its JAX leaf's spec, a stacked
    leaf's without the period dim.  ``grains`` (:func:`head_grains`)
    keeps attention projections head-whole under "model"."""
    by_id = {}
    for (path, tensors, stacked), (_, spec) in zip(
            W.leaves_in_jax_order(cfg, params),
            param_specs_jax_order(cfg, params, mesh, grains)):
        for t in tensors:
            by_id[id(t)] = spec[1:] if stacked and spec else spec
    return W.map_tree(params, lambda t: by_id[id(t)])


def opt_specs(cfg, opt_state: dict, mesh) -> dict:
    """Spec tree for the AdamW state (port of the JAX ``opt_specs``): each
    of "mu", "nu" and "residual" by the param rules over its own leaves
    (no head grains, as the JAX training launcher shards), so a moment
    takes its param's spec wherever its dtype keeps the leaf on the same
    side of the FSDP threshold; "step" and any other scalar replicated.
    ``opt_state`` may hold meta tensors."""
    return {k: param_specs(cfg, v, mesh) if k in W.OPT_TREES else ()
            for k, v in opt_state.items()}


def batch_specs(batch, mesh):
    """Spec tree for model inputs (port of the JAX ``batch_specs``): dim 0
    over the batch axes ("pod", "data") where their product divides it,
    else the leaf replicated; a 0-d leaf replicated.  ``batch`` is a nest
    of dicts whose leaves have a ``shape`` (tensors, numpy arrays)."""
    names = batch_axes(mesh)
    n = math.prod(axis_sizes(mesh)[a] for a in names)

    def one(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        if names and shape[0] % n == 0:
            return (_batch_entry(mesh),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return W.map_tree(batch, one)


def cache_specs(caches: list, mesh) -> list:
    """Spec tree for the decode caches (a list of per-layer dicts of
    parts): sequence-sharded rings and pools.  A cache rule has no size
    check, so a per-layer leaf's spec is the stacked leaf's without its
    period dim."""
    return [{part: {name: _spec_for([name], tuple(leaf.shape), leaf.dtype, mesh,
                                    CACHE_RULES)
                    for name, leaf in leaves.items()}
             for part, leaves in layer.items()} for layer in caches]


def cache_model_dim(name: str, shape, dtype, mesh) -> int | None:
    """The dim of a cache leaf ``name`` of FULL shape ``shape`` that
    :func:`cache_specs` splits over "model" (a ring's or cross source's
    positions, a pool page's offsets, a recurrent state's channels), or
    None where it keeps the leaf whole there."""
    spec = _spec_for([name], tuple(shape), dtype, mesh, CACHE_RULES)
    for d, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return d
    return None


def carry_specs(carry: dict, mesh) -> dict:
    """Specs of the engine's per-slot carry (``Engine._st``): dim 0 is the
    slot dim, over the batch axes when it divides; the rest whole."""
    return {k: (() if len(v.shape) < 1 else
                _resolve((("batch", 0),), tuple(v.shape), v.dtype, mesh, 0))
            for k, v in carry.items()}


def slot_stacked_spec(n_slots: int, mesh, lead_dims: int = 1) -> Spec:
    """Spec of a window's stacked per-slot outputs (steps, B): ``lead_dims``
    replicated dims, then the slot dim over the batch axes."""
    names = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n = math.prod(sizes[a] for a in names)
    if not names or n_slots % n:
        return ()
    return (None,) * lead_dims + (_batch_entry(mesh),)


# -- the decode kernels' per-rank operands ----------------------------------
#
# A kernel is opaque to any partitioner, so on a mesh each rank calls it on
# its slice and the partial softmaxes merge by hand (``kernels.ops``).
# These give the per-rank layout of its operands, consistent with
# CACHE_RULES: ring leaves split (slot, sequence), slot-major operands the
# slot dim only, pool leaves keep every page (the page table holds global
# page ids) and split the in-page offset.

def kernel_seq_shards(mesh) -> int:
    """How many ways the kernel ring's sequence dim shards ("model")."""
    if mesh is None:
        return 1
    return axis_sizes(mesh).get("model", 1)


def kernel_batch_axes(mesh, n: int):
    """Slot-dim axes of a kernel call: the batch axes when their product
    divides ``n``, else None (slots replicated)."""
    names = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in names)
    if not names or total <= 1 or n % total:
        return None
    return names if len(names) > 1 else names[0]


def kernel_slot_spec(ndim: int, batch) -> Spec:
    """(B, ...) slot-major operand: slot dim over ``batch``, rest whole."""
    return (batch,) + (None,) * (ndim - 1)


def kernel_ring_spec(ndim: int, batch) -> Spec:
    """(B, L, ...) ring leaf: slot over ``batch``, sequence over "model"."""
    return (batch, "model") + (None,) * (ndim - 2)


def kernel_pool_spec(ndim: int) -> Spec:
    """(n_pages, page_size, ...) pool leaf: every page, in-page offset over
    "model"."""
    return (None, "model") + (None,) * (ndim - 2)


def kernel_repl_spec(ndim: int) -> Spec:
    """Fully replicated operand (factors, norms, scalars)."""
    return (None,) * ndim
