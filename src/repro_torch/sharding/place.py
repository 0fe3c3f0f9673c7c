"""Placing trees on a mesh by their specs, and gathering them back.

``shard`` keeps this rank's slice of each leaf (``rules`` specs; a dim
over one axis is split in that axis's order), ``gather`` rebuilds the full
leaf with one all-gather per sharded dim.  ``MeshParams`` holds a model's
params at rest as this rank's shards and gathers a layer's leaves (or a
top-level leaf) each time the model reads them, so the products after it
are the single-device products; the gathered copies are dropped with the
reference.  ``local_cache`` builds the decode caches as this rank's
shards of ``rules.cache_specs``.
"""

from __future__ import annotations

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
    """``params["layers"]`` of a :class:`MeshParams`: item i is layer i's
    tree, gathered on access."""

    def __init__(self, owner: "MeshParams"):
        self._owner = owner

    def __len__(self) -> int:
        return len(self._owner.local["layers"])

    def __getitem__(self, i):
        o = self._owner
        return o.gathered(o.local["layers"][i], o.specs["layers"][i])

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class MeshParams:
    """A model's params at rest as this rank's shards (``local``, by
    ``specs``), read like the params dict: a top-level leaf, or a layer
    of ``["layers"]``, is gathered whole over the mesh when it is read.
    ``gathered_bytes`` counts the bytes the gathers rebuilt."""

    def __init__(self, cfg, params: dict, mesh, grains=None):
        self.mesh = mesh
        self.specs = R.param_specs(cfg, params, mesh, grains=grains)
        self.local = shard_tree(params, self.specs, mesh)
        self.gathered_bytes = 0

    def gathered(self, tree, specs):
        out = gather_tree(tree, specs, self.mesh)
        self.gathered_bytes += tree_bytes(out)
        return out

    def __getitem__(self, key):
        if key == "layers":
            return _Layers(self)
        return self.gathered(self.local[key], self.specs[key])

    def __contains__(self, key) -> bool:
        return key in self.local


def local_cache(full_meta: list, mesh, device) -> list:
    """Empty decode caches as this rank's shards: ``full_meta`` are the
    full caches on the meta device (``transformer.init_decode_cache``),
    each leaf made at its slice's shape, ``pos`` -1 and the rest 0 as
    there."""
    specs = R.cache_specs(full_meta, mesh)

    def local_shape(shape, spec):
        out = list(shape)
        for d, entry in enumerate(spec):
            for axis in _axes(entry):
                out[d] //= mesh.axis_size(axis)
        return tuple(out)

    return [{part: {name: torch.full(local_shape(leaf.shape, specs[i][part][name]),
                                     -1 if name == "pos" else 0, dtype=leaf.dtype,
                                     device=device)
                    for name, leaf in leaves.items()}
             for part, leaves in layer.items()}
            for i, layer in enumerate(full_meta)]
