"""whisper-small [audio] — 12L enc + 12L dec, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865, enc-dec with conv frontend (STUB).
[arXiv:2212.04356; unverified]

The conv/mel frontend is a stub: the caller passes precomputed frame
embeddings (B, 1500, d_model) as ``source``.  Decoder blocks are self-attn
+ cross-attn (``attn_cross``); ReCalKV compresses both (cross keys carry
no RoPE, so they are absorbed into the query).  As in the JAX package the
backbone uses SwiGLU and RoPE in place of GELU and learned positions.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern=("attn_cross",),
    attn_seq_shard=True,
    encoder_decoder=True,
    num_encoder_layers=12,
    cross_source_len=1500,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=257,
    layer_pattern=("attn_cross",),
    encoder_decoder=True,
    num_encoder_layers=2,
    cross_source_len=16,
    attn_chunk=16,
)
