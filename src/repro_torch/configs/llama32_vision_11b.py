"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th block.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend is a stub: the caller passes precomputed patch
embeddings (B, 1600, d_model) as ``source``; the ``cross`` blocks attend
to them.  ReCalKV applies to self-attention (RoPE'd, reconstructed keys)
and to cross-attention (no RoPE, absorbed keys).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=("attn", "attn", "attn", "cross", "attn"),  # 8 cross / 40
    cross_source_len=1600,
    rope_theta=500000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    layer_pattern=("attn", "attn", "attn", "cross", "attn"),
    cross_source_len=16,
    rope_theta=500000.0,
    tie_embeddings=False,
    attn_chunk=16,
)
