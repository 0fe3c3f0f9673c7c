"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Quantizing each leaf to int8 with one float32 scale cuts a data-parallel
all-reduce's traffic 4x against float32; the residual carried in the
train state keeps the compression unbiased over steps.  On one card
``with_error_feedback`` simulates what arrives on the other side of such
a reduction.  ``compressed_psum``, the reduction itself across devices,
needs a mesh, which the port does not have yet.

Leaves are the JAX package's (``weights.leaves_in_jax_order`` of the model
config): a scanned block's leaf is one leaf over all its periods, so
its scale is the amax of the whole stack.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import leaves_in_jax_order, map_tree

PSUM_NOT_PORTED = ("compressed_psum needs a device mesh, which the port does not "
                   "have yet (ROADMAP.md, Queue 1 item 5); with_error_feedback "
                   "simulates the compressed reduction on one card")


def quantize_leaf(g: torch.Tensor):
    """Symmetric per-leaf int8 quantization.  Returns (q, scale)."""
    return _quantize(g.float(), _scale(g.float().abs().max()))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / 127.0, min=1e-30)


def _quantize(g32: torch.Tensor, scale: torch.Tensor):
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, axis_name: str):
    """Quantized all-reduce over a mesh axis: not ported (no mesh yet)."""
    raise NotImplementedError(PSUM_NOT_PORTED)


def with_error_feedback(grads, residual=None, *, model: ModelConfig):
    """Add the carried residual, quantize per (JAX) leaf, carry the new
    residual.  Returns (decompressed grads in their dtype, new float32
    residual), trees in the grads' layout; ``residual`` None starts from
    zeros.  ``model`` as for ``adamw.apply_updates``."""
    if residual is None:
        residual = map_tree(grads, lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                         device=g.device))
    new_g, new_r = {}, {}
    for (_, gs, _), (_, rs, _) in zip(leaves_in_jax_order(model, grads),
                                      leaves_in_jax_order(model, residual), strict=True):
        g32 = [g.float() + r for g, r in zip(gs, rs, strict=True)]
        scale = _scale(torch.stack([x.abs().max() for x in g32]).max())
        for g, r, x in zip(gs, rs, g32, strict=True):
            deq = dequantize_leaf(*_quantize(x, scale))
            new_g[id(g)] = deq.to(g.dtype)
            new_r[id(r)] = x - deq
    return (map_tree(grads, lambda g: new_g[id(g)]),
            map_tree(residual, lambda r: new_r[id(r)]))
