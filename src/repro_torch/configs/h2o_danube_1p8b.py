"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

Every layer slides (window 4096), so the KV ring is bounded and the arch
qualifies for long_500k.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab_size=32000,
    layer_pattern=("local",),
    sliding_window=4096,
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    layer_pattern=("local",),
    sliding_window=16,
    tie_embeddings=False,
    attn_chunk=16,
)
