"""Model side of the port: config, weights, layers, ring cache, stack."""

from repro_torch.models.config import ModelConfig, ReCalKVRuntime, check_supported
from repro_torch.models.transformer import (decode_loop, decode_step,
                                            init_decode_cache, prefill)
from repro_torch.models.weights import init_params, params_from_jax

__all__ = ["ModelConfig", "ReCalKVRuntime", "check_supported", "decode_loop",
           "decode_step", "init_decode_cache", "init_params",
           "params_from_jax", "prefill"]
