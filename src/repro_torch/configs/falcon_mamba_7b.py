"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, Mamba-1 architecture.  [arXiv:2410.05355; unverified]

ReCalKV does not apply: there is no KV cache; the recurrent state (B,
d_inner, d_state) is already O(1) in sequence length.  Served with the
chunked selective scan in plain PyTorch (the JAX package computes it
outside any Pallas kernel).  head/d_ff fields are placeholders (no
attention, no separate FFN).  The port's copy of
``repro.configs.falcon_mamba_7b``.
"""

from repro_torch.models.config import MambaConfig, ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,
    num_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab_size=65024,
    layer_pattern=("mamba",),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_head=16,
    d_ff=0,
    vocab_size=257,
    layer_pattern=("mamba",),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
    attn_chunk=16,
)
