"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk-norm, explicit head_dim=128.  [hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    qk_norm=True,
    rope_theta=1000000.0,
    attn_chunk=16,
)
