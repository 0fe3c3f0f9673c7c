"""Hand-written Hopper kernels for the attention hot spots ReCalKV touches.

  latent_decode    K1: ReCalKV flash decode over the latent ring (keys
                   rebuilt in-kernel, never written to device memory);
                   K5: the same for nq verify queries in one pass;
                   K4 / K7: K1 / K5 over the paged pool, through a page
                   table
  latent_decode_q  K3 / K6: K1 / K5 over the int8 latent ring
  flash_prefill    K2: causal / sliding-window flash prefill, latent values
  dense_decode     the dense cores of K1 / K4 (decode) and K5 / K7
                   (multi-query verify) over the dense KV cache, on the
                   ring and through a page table
  stage_install    continuous batching's in-window install: a staged
                   cache row copied into a freed slot, predicated on the
                   device (glue, not a TPU kernel)

bf16 K1 and K3-K7 run the tensor-core body of ``csrc/latent_decode_tc.cu``;
their float32 calls run the CUDA-core template of ``csrc/latent_decode.cu``;
K2 is ``csrc/flash_prefill.cu`` (bf16 on ``wgmma``, float32 on CUDA
cores); the dense decode cores are ``csrc/dense_decode.cu`` up to 8 query
rows a kv head (one CUDA-core body for bf16 and float32; 1-7 served) and
``csrc/dense_verify.cu``'s one-tile body at 8-16, the dense verify cores
``csrc/dense_verify.cu`` (bf16 on ``mma.sync`` up to 16 rows and on
``wgmma`` in 64-row groups past them, float32 on CUDA cores); the
install's row copy
``csrc/stage_install.cu``.  Each module holds the CUDA
wrappers, their plain PyTorch versions and a launch counter per wrapper
(the decode wrappers' launches with ``return_lse`` counted apart too);
``ops`` adapts model tensors to them and ``build`` compiles the sources in
``csrc/`` at first use.
"""

from repro_torch.kernels.dense_decode import (
    dense_decode_attention, dense_decode_attention_mq,
    dense_decode_attention_mq_paged, dense_decode_attention_paged)
from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.kernels.latent_decode import (
    latent_decode_attention, latent_decode_attention_mq,
    latent_decode_attention_mq_paged, latent_decode_attention_paged)
from repro_torch.kernels.latent_decode_q import (
    latent_decode_attention_mq_quant, latent_decode_attention_quant)
from repro_torch.kernels.stage_install import stage_install_rows

KERNELS = (latent_decode_attention, flash_prefill_attention,
           latent_decode_attention_quant, latent_decode_attention_paged,
           latent_decode_attention_mq, latent_decode_attention_mq_quant,
           latent_decode_attention_mq_paged, dense_decode_attention,
           dense_decode_attention_paged, dense_decode_attention_mq,
           dense_decode_attention_mq_paged, stage_install_rows)
# the decode wrappers that can return their softmax state (``return_lse``,
# the mesh path's): each also counts those launches in ``.lse_launches``
LSE_KERNELS = (latent_decode_attention, latent_decode_attention_quant,
               latent_decode_attention_paged, latent_decode_attention_mq,
               latent_decode_attention_mq_quant, latent_decode_attention_mq_paged,
               dense_decode_attention, dense_decode_attention_paged,
               dense_decode_attention_mq, dense_decode_attention_mq_paged)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in LSE_KERNELS:
        k.lse_launches = 0


__all__ = ["KERNELS", "LSE_KERNELS", "dense_decode_attention", "dense_decode_attention_mq",
           "dense_decode_attention_mq_paged", "dense_decode_attention_paged",
           "flash_prefill_attention", "latent_decode_attention",
           "latent_decode_attention_mq", "latent_decode_attention_mq_paged",
           "latent_decode_attention_mq_quant", "latent_decode_attention_paged",
           "latent_decode_attention_quant", "reset_launch_counts", "stage_install_rows"]
