"""Per-token symmetric integer quantization of cache latents (port of
``repro.quant.int_quant``; the paper's Table 4, ReCalKV x per-token
quantization).  ``torch.round`` rounds half to even, as ``jnp.round``."""

from __future__ import annotations

import torch

_QMAX = {8: 127, 4: 7, 3: 3}


def quantize(x: torch.Tensor, bits: int = 8):
    """Symmetric per-token (last-axis) quantization.

    Returns (q int8, scale float32 of shape (..., 1)).  4- and 3-bit
    values live in [-7, 7] / [-3, 3] inside int8 storage."""
    if bits not in _QMAX:
        raise ValueError(bits)
    qmax = _QMAX[bits]
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / qmax, min=1e-30)
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize round trip (quality evaluation path)."""
    q, s = quantize(x, bits)
    return dequantize(q, s, x.dtype)
