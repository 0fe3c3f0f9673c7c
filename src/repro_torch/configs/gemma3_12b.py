"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Local layers slide over a 1024 window (theta 10k); every 6th layer is
global (theta 1M).  Qualifies for long_500k: only the 8 global layers hold
an unbounded cache.  Per-layer Fisher allocation naturally compresses the
global layers hardest (their caches dominate bytes).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=1024,
    rope_theta=10000.0,
    rope_theta_global=1000000.0,
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke",
    family="dense",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=16,
    rope_theta=10000.0,
    rope_theta_global=1000000.0,
    qk_norm=True,
    embed_scale=True,
    attn_chunk=16,
)
