"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753, WSD schedule (arch = llama-like MHA).  [arXiv:2404.06395; hf]

MHA is the paper's own main setting (LLaMA-2): 36 kv heads -> 9 HSR groups
of 4.  Its WSD learning-rate schedule is the training CLI's default for
this arch (``optim.schedule.wsd``).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10000.0,
    attn_seq_shard=True,   # 36 heads % 16 != 0: sequence-parallel K/V
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    num_layers=3,
    d_model=72,
    num_heads=4,
    num_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    attn_chunk=16,
)
