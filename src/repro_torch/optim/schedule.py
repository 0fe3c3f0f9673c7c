"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM's schedule)
(port of ``repro.optim.schedule``).

Each returns a multiplicative scale in [0, 1] applied to the peak LR, as a
float32 tensor of the step (on the CPU), computed in float32 as the JAX
package traces it: the constants enter as float32, and ``cos(pi * frac)``
is the C library's float32 ``cosf``, which is what XLA's CPU backend
calls (PyTorch's CPU kernel rounds about 2% of arguments one ulp apart
from it).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import torch

_LIBM = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_LIBM.cosf.restype = ctypes.c_float
_LIBM.cosf.argtypes = [ctypes.c_float]


def _cos32(x: torch.Tensor) -> torch.Tensor:
    """float32 cos of a (small) float32 tensor through libm's ``cosf``."""
    return torch.tensor([_LIBM.cosf(v) for v in x.flatten().tolist()],
                        dtype=torch.float32).view(x.shape)


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).detach().to("cpu", torch.float32)


def cosine(step, *, warmup: int, total: int, min_scale: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = step / max(warmup, 1)
    frac = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = min_scale + (1 - min_scale) * 0.5 * (1 + _cos32(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, warmup: int, total: int, decay_frac: float = 0.1,
        min_scale: float = 0.01) -> torch.Tensor:
    """Warmup -> stable plateau -> sharp decay (arXiv:2404.06395)."""
    step = _f32(step)
    decay_start = total * (1 - decay_frac)
    warm = step / max(warmup, 1)
    decay = 1.0 - (1 - min_scale) * (step - decay_start) / max(total - decay_start, 1)
    scale = torch.where(step < warmup, warm,
                        torch.where(step < decay_start, torch.ones_like(step), decay))
    return scale.clamp(min_scale, 1.0)


SCHEDULES = {"cosine": cosine, "wsd": wsd}
