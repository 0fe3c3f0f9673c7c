"""Hand-written Hopper kernels for the attention hot spots ReCalKV touches.

  latent_decode    K1: ReCalKV flash decode over the latent ring (keys
                   rebuilt in-kernel, never written to device memory);
                   K5: the same for nq verify queries in one pass
  latent_decode_q  K3 / K6: K1 / K5 over the int8 latent ring
  flash_prefill    K2: causal / sliding-window flash prefill, latent values

Each module holds the CUDA wrappers, their plain PyTorch versions and a
launch counter per wrapper; ``ops`` adapts model tensors to them and
``build`` compiles the sources in ``csrc/`` at first use.
"""

from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.kernels.latent_decode import (latent_decode_attention,
                                               latent_decode_attention_mq)
from repro_torch.kernels.latent_decode_q import (
    latent_decode_attention_mq_quant, latent_decode_attention_quant)

KERNELS = (latent_decode_attention, flash_prefill_attention,
           latent_decode_attention_quant, latent_decode_attention_mq,
           latent_decode_attention_mq_quant)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "flash_prefill_attention", "latent_decode_attention",
           "latent_decode_attention_mq", "latent_decode_attention_mq_quant",
           "latent_decode_attention_quant", "reset_launch_counts"]
