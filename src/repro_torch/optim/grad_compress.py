"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Quantizing each leaf to int8 with one float32 scale cuts a data-parallel
all-reduce's traffic 4x against float32; the residual carried in the
train state keeps the compression unbiased over steps.  On one card
``with_error_feedback`` simulates what arrives on the other side of such
a reduction; ``compressed_psum`` is the reduction itself over an axis of
a ``launch.mesh.Mesh``.  As in the JAX package the training step does not
call it: it reduces full-precision gradients and applies the error
feedback to the result (``runtime.train_loop``).

Leaves are the JAX package's (``weights.leaves_in_jax_order`` of the model
config): a scanned block's leaf is one leaf over all its periods, so
its scale is the amax of the whole stack.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import leaves_in_jax_order, map_tree

def quantize_leaf(g: torch.Tensor):
    """Symmetric per-leaf int8 quantization.  Returns (q, scale)."""
    return _quantize(g.float(), _scale(g.float().abs().max()))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / 127.0, min=1e-30)


def _quantize(g32: torch.Tensor, scale: torch.Tensor):
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, axis: str, mesh):
    """Quantized all-reduce of every leaf of ``grads`` over ``axis`` of
    ``mesh``, in the JAX package's steps and order: each leaf quantized
    to int8 on its own scale, the scales max-reduced, the int8 values
    widened to int32 and summed (no overflow below 2^23 ranks), then
    ``q32 * scale / n`` in float32, cast back to the leaf's dtype.  What
    crosses the mesh is int32 (+ one float32 scale) a leaf.  Every rank
    returns the same tree; on an axis of size 1 each leaf is its own
    round trip through int8."""
    n = mesh.axis_size(axis)

    def one(g):
        q, scale = quantize_leaf(g)
        scale = mesh.all_reduce(scale, axis, op="max")
        q32 = mesh.all_reduce(q.to(torch.int32), axis)
        return (q32.float() * scale / float(n)).to(g.dtype)

    return map_tree(grads, one)


def with_error_feedback(grads, residual=None, *, model: ModelConfig, mesh=None):
    """Add the carried residual, quantize per (JAX) leaf, carry the new
    residual.  Returns (decompressed grads in their dtype, new float32
    residual), trees in the grads' layout; ``residual`` None starts from
    zeros.  ``model`` as for ``adamw.apply_updates``.  With a ``mesh``
    the trees are this rank's shards of the global gradient and residual:
    each leaf's amax is max-reduced over "data" and "model" (a leaf
    replicated over an axis has the same amax on its ranks), so every
    shard quantizes on its whole leaf's scale, as one device does."""
    if residual is None:
        residual = map_tree(grads, lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                         device=g.device))
    pairs = [list(zip(gs, rs, strict=True)) for (_, gs, _), (_, rs, _) in zip(
        leaves_in_jax_order(model, grads), leaves_in_jax_order(model, residual),
        strict=True)]
    # two passes over g + r (the first for each leaf's amax), so no more
    # than one float32 copy of a leaf part is alive at a time
    amax = torch.stack([torch.stack([(g.float() + r).abs().max() for g, r in leaf]).max()
                        for leaf in pairs])
    if mesh is not None:
        for axis in ("data", "model"):
            amax = mesh.all_reduce(amax, axis, op="max")
    new_g, new_r = {}, {}
    for leaf, a in zip(pairs, amax, strict=True):
        scale = _scale(a)
        for g, r in leaf:
            x = g.float() + r
            deq = dequantize_leaf(*_quantize(x, scale))
            new_g[id(g)] = deq.to(g.dtype)
            new_r[id(r)] = x - deq
    return (map_tree(grads, lambda g: new_g[id(g)]),
            map_tree(residual, lambda r: new_r[id(r)]))
