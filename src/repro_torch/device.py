"""Device resolution shared by every entry point of the port, and the
float32 precision scope of the compression code."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a usable GPU raises:
    the port never carries on silently on the CPU — a caller that wants
    the plain CPU path asks for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products and convolutions in full float32 (TF32
    off) for the duration, whatever the caller's global flags; restored
    after.  The compression code runs inside it: whitening through a
    Cholesky factor is where TF32's ten-bit mantissa would show."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
