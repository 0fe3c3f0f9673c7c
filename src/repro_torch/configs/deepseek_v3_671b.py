"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(dense)=18432
vocab=129280, MoE 256 experts top-8 + 1 shared (d_expert=2048), MLA
(kv_lora=512, rope=64), first 3 layers dense.  [arXiv:2412.19437; hf]

ReCalKV does not apply: MLA is the trained-from-scratch latent KV cache
the paper positions itself against, and it is served as it is: the
decode and verify readers score in the c_kv latent space (absorbed MLA,
``kv_cache.decode_attn_mla``).  MTP (multi-token prediction) is not
modeled.  The port's copy of ``repro.configs.deepseek_v3_671b``.
"""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_head=128,
    d_ff=18432,                       # dense-FFN width (first 3 layers)
    vocab_size=129280,
    prefix_pattern=("attn_dense",) * 3,
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  first_k_dense=3),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_rope_dim=64,
                  qk_nope_dim=128, v_head_dim=128),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    prefix_pattern=("attn_dense",),
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                  first_k_dense=1),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                  qk_nope_dim=8, v_head_dim=16),
    tie_embeddings=False,
    attn_chunk=16,
)
