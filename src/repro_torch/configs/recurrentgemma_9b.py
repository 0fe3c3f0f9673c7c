"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention in a (recurrent, recurrent, attn)
pattern.  [arXiv:2402.19427; unverified]

38 layers = 12 periods of (rglru, rglru, local) + 2 trailing rglru blocks
(the suffix).  kv=1 (MQA) makes HSR grouping degenerate (one head, one
group of 1): those layers get plain truncated and calibrated SVD, and
OCMF applies in full.  The RG-LRU layers are attention-free and keep
their recurrent state.  The port's copy of
``repro.configs.recurrentgemma_9b``.
"""

from repro_torch.models.config import ModelConfig, RGLRUConfig

FULL = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    sliding_window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    layer_pattern=("rglru", "rglru", "local"),
    sliding_window=16,
    rglru=RGLRUConfig(lru_width=64, conv_width=4),
    embed_scale=True,
    attn_chunk=16,
)
