"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8, qk-norm.  [hf:Qwen/Qwen3-30B-A3B; hf]

GQA kv=4 -> a single HSR group of 4 per layer; ReCalKV fully applies (the
MoE change is FFN-only).  The port's copy of ``repro.configs.qwen3_moe_235b``.
"""

from repro_torch.models.config import MoEConfig, ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab_size=151936,
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab_size=257,
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=64),
    qk_norm=True,
    tie_embeddings=False,
    attn_chunk=16,
)
