"""Hand-written Hopper kernels for the attention hot spots ReCalKV touches.

  latent_decode    K1: ReCalKV flash decode over the latent ring (keys
                   rebuilt in-kernel, never written to device memory)
  flash_prefill    K2: causal / sliding-window flash prefill, latent values

Each module holds the CUDA wrapper, its plain PyTorch version and a launch
counter; ``ops`` adapts model tensors to them and ``build`` compiles the
sources in ``csrc/`` at first use.
"""

from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.kernels.latent_decode import latent_decode_attention

KERNELS = (latent_decode_attention, flash_prefill_attention)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "flash_prefill_attention", "latent_decode_attention",
           "reset_launch_counts"]
