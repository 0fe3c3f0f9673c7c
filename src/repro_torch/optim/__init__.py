"""Optimizer side of the port (port of ``repro.optim``): AdamW with
optional bf16 moments, int8 gradient compression with error feedback, and
the cosine / WSD schedules."""

from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.optim.grad_compress import (compressed_psum, dequantize_leaf,
                                             quantize_leaf, with_error_feedback)
from repro_torch.optim.schedule import SCHEDULES, cosine, wsd

__all__ = [
    "AdamWConfig", "SCHEDULES", "apply_updates", "compressed_psum", "cosine",
    "dequantize_leaf", "init_state", "quantize_leaf", "with_error_feedback",
    "wsd",
]
