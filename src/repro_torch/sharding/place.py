"""Placing trees on a mesh by their specs, and gathering them back.

``shard`` keeps this rank's slice of each leaf (``rules`` specs; a dim
over one axis is split in that axis's order), ``gather`` rebuilds the full
leaf with one all-gather per sharded dim.  ``MeshParams`` holds a model's
params at rest as this rank's shards and gathers a layer's leaves (or a
top-level leaf) each time the model reads them, so the products after it
are the single-device products; the gathered copies are dropped with the
reference.  In a training step (``MeshParams.step(train=GradReduce(...))``)
the gathers carry a gradient (:class:`GatherShard`): each leaf is gathered
once a step, and its backward sums the upstream gradient over the axes
whose ranks saw different rows and keeps this rank's slice.
``local_cache`` builds the decode caches as this rank's shards of
``rules.cache_specs`` (a pool keeps every page on every data
rank), and ``step_mesh`` the mesh view the engine's steps read them by.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.sharding import rules as R


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` (a contiguous copy, so the
    full tensor can be freed)."""
    out = t
    for d, entry in enumerate(spec):
        for axis in _axes(entry):
            n = mesh.axis_size(axis)
            if n == 1:
                continue
            size = out.shape[d] // n
            out = out.narrow(d, mesh.axis_index(axis) * size, size)
    return out.contiguous() if out is not t else t


def gather(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from this rank's shard ``t``: one all-gather over each
    axis a dim is split on (the inverse of :func:`shard`)."""
    out = t
    for d in reversed(range(len(spec))):
        for axis in reversed(_axes(spec[d])):
            out = mesh.all_gather(out, axis, dim=d)
    return out


class GradReduce:
    """How a training step's weight gathers (:class:`GatherShard`) turn
    their upstream gradient into this rank's shard gradient: summed over
    ``axes`` (the axes whose ranks ran different rows: "data", or none
    where every data rank ran the whole batch), in float32.  While
    ``defer`` is set (every microbatch but the last) a backward only adds
    the gradient to its leaf's float32 sum and returns none; the last
    microbatch reduces the sum once, so a step moves each leaf's gradient
    over the mesh once whatever the microbatch count."""

    def __init__(self, axes):
        self.axes = tuple(axes)
        self.defer = False


class GatherShard(torch.autograd.Function):
    """:func:`gather` under autograd.  Forward: the full leaf from this
    rank's shard.  Backward: the upstream gradient summed over the
    ``GradReduce``'s axes in float32, this rank's slice of it (the
    inverse of the gather), in the shard's dtype.  The "model" ranks of one
    data lane run the same rows, so their gradients are equal and are
    sliced, not summed.  Nothing is saved for the backward, so one
    gathered leaf may serve several microbatches' graphs."""

    @staticmethod
    def forward(ctx, t, spec, mesh, red):
        ctx.spec, ctx.mesh, ctx.red, ctx.pending = spec, mesh, red, None
        return gather(t, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.pending is None:
            total = g.to(torch.float32, copy=True)
        else:
            total = ctx.pending.add_(g)
        if ctx.red.defer:
            ctx.pending = total
            return None, None, None, None
        ctx.pending = None
        for axis in ctx.red.axes:
            total = ctx.mesh.all_reduce(total, axis)
        return shard(total, ctx.spec, ctx.mesh).to(g.dtype), None, None, None


def spec_by_id(tree, specs) -> dict:
    """{id(leaf): spec} over a tree and its spec tree."""
    out = {}
    _map2(tree, specs, lambda t, s: out.__setitem__(id(t), s))
    return out


def full_shape(shape, spec, mesh) -> tuple:
    """The full leaf's shape from a shard's ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in _axes(entry):
            out[d] *= mesh.axis_size(axis)
    return tuple(out)


def _map2(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _map2(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(v, s, fn) for v, s in zip(tree, specs, strict=True))
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    return _map2(tree, specs, lambda t, s: shard(t, s, mesh))


def gather_tree(tree, specs, mesh):
    return _map2(tree, specs, lambda t, s: gather(t, s, mesh))


def tree_bytes(tree) -> int:
    total = 0

    def add(t, _):
        nonlocal total
        total += t.numel() * t.element_size()
    _map2(tree, tree, add)
    return total


class _Layers:
    """``params["layers"]`` of a :class:`MeshParams`: item i < ``n`` is
    layer i's tree, gathered on access."""

    def __init__(self, owner: "MeshParams", n: int):
        self._owner, self._n = owner, n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if not 0 <= i < self._n:
            raise IndexError(i)
        o = self._owner
        memo = getattr(o._tls, "memo", None)
        if getattr(o._tls, "train", None) is None or memo is None:
            return o.gathered(o.local["layers"][i], o.specs["layers"][i])
        key = ("layers", i)      # a training step keeps every layer it read
        if key not in memo:
            memo[key] = o.gathered(o.local["layers"][i], o.specs["layers"][i])
        return memo[key]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class MeshParams:
    """A model's params at rest as this rank's shards (``local``, by
    ``specs``), read like the params dict: a top-level leaf, or a layer
    of ``["layers"]``, is gathered whole over the mesh when it is read.
    Within :meth:`step` a top-level leaf is gathered once, at its first
    read, and kept to the block's end: a step reads the tied embedding
    twice (the lookup and the logits).  ``gathered_bytes`` counts the
    bytes the gathers rebuilt.  A training step (``step(train=...)``)
    gathers through :class:`GatherShard` and keeps every leaf it read,
    layers too, to the step's end: its microbatches share one gather of
    each leaf, and a block recomputed under remat reads the kept copy."""

    def __init__(self, cfg, params: dict, mesh, grains=None):
        self.mesh = mesh
        self.specs = R.param_specs(cfg, params, mesh, grains=grains)
        self.local = shard_tree(params, self.specs, mesh)
        self.gathered_bytes = 0
        self._lock = threading.Lock()     # the admission worker reads too
        self._tls = threading.local()     # this thread's step memo

    def first_layers(self, k: int) -> "LayerPrefix":
        """The first ``k`` layers and the top-level leaves, read over the
        same shards (the layer draft's params)."""
        return LayerPrefix(self, k)

    def gathered(self, tree, specs):
        red = getattr(self._tls, "train", None)
        if red is None:
            out = gather_tree(tree, specs, self.mesh)
        else:
            out = _map2(tree, specs, lambda t, s: GatherShard.apply(t, s, self.mesh, red))
        with self._lock:
            self.gathered_bytes += tree_bytes(out)
        return out

    @contextlib.contextmanager
    def step(self, train: GradReduce | None = None):
        """One step's reads on this thread: each top-level leaf gathered
        once (nested blocks share the outer one's).  With ``train`` the
        gathers carry gradients reduced as it says, and layers are kept
        too (class docstring)."""
        outer = getattr(self._tls, "memo", None)
        if outer is None:
            self._tls.memo = {}
            self._tls.train = train
        try:
            yield
        finally:
            if outer is None:
                self._tls.memo = None
                self._tls.train = None

    def __getitem__(self, key):
        if key == "layers":
            return _Layers(self, len(self.local["layers"]))
        memo = getattr(self._tls, "memo", None)
        if memo is not None and key in memo:
            return memo[key]
        out = self.gathered(self.local[key], self.specs[key])
        if memo is not None:
            memo[key] = out
        return out

    def __contains__(self, key) -> bool:
        return key in self.local


def local_cache(full_meta: list, mesh, device, pool: bool = False) -> list:
    """Empty decode caches as this rank's shards: ``full_meta`` are the
    full caches on the meta device (``transformer.init_decode_cache``),
    each leaf made at its slice's shape, ``pos`` -1 and the rest 0 as
    there.  A ``pool``'s leaves keep their page dim whole, whatever the
    spec says of it: the page table holds global page ids, so every data
    rank keeps every page (JAX's kernel call keeps it whole too; at rest
    JAX splits it over "data" where the count divides)."""
    specs = R.cache_specs(full_meta, mesh)

    def local_shape(shape, spec):
        out = list(shape)
        for d, entry in enumerate(spec):
            if pool and d == 0:
                continue
            for axis in _axes(entry):
                out[d] //= mesh.axis_size(axis)
        return tuple(out)

    return [{part: {name: torch.full(local_shape(leaf.shape, specs[i][part][name]),
                                     -1 if name == "pos" else 0, dtype=leaf.dtype,
                                     device=device)
                    for name, leaf in leaves.items()}
             for part, leaves in layer.items()}
            for i, layer in enumerate(full_meta)]


def step_mesh(mesh, full_meta: list, n_slots: int):
    """The view of ``mesh`` the engine's steps read caches of FULL shapes
    ``full_meta`` (``n_slots`` slot rows, or a pool) by: without "data"
    where ``n_slots`` does not split over it (every data rank then holds
    and steps every slot, and no step gathers over "data"), and reading
    whole (:meth:`launch.mesh.Mesh.layer`) each layer whose self ring or
    pool ``rules.cache_specs`` keeps whole over "model" (a ring length or
    page size the "model" ranks do not divide).  Decided per layer: one
    model's rings may differ in length (gemma3's window and global)."""
    view = mesh if n_slots % mesh.axis_size("data") == 0 else mesh.without("data")
    if mesh.axis_size("model") == 1:
        return view
    whole = [i for i, layer in enumerate(full_meta) if "self" in layer
             and R.cache_model_dim("pos", layer["self"]["pos"].shape,
                                   layer["self"]["pos"].dtype, mesh) is None]
    return view.with_whole_layers(whole)


class LayerPrefix:
    """A :class:`MeshParams` read as its first ``k`` layers and its
    top-level leaves, no copy: the layer draft's params.  Its reads
    gather through the owner, so their bytes count in the owner's
    ``gathered_bytes``."""

    def __init__(self, owner: MeshParams, k: int):
        self._owner, self._k = owner, k

    def __getitem__(self, key):
        if key == "layers":
            return _Layers(self._owner, self._k)
        return self._owner[key]

    def __contains__(self, key) -> bool:
        return key in self._owner
