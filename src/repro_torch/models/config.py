"""Model configuration (port of ``repro.models.config``).

The dataclasses carry every field of the JAX configuration so that a
``model_config`` dict written by the JAX package loads unchanged
(:meth:`ModelConfig.from_dict`).  The port's model functions implement the
subset the serving main path needs — dense FFN ``attn`` blocks with a
float ReCalKV latent ring — and :func:`check_supported` names anything
else as not ported.

``attn_backend`` takes ``"einsum"`` (plain PyTorch reference) or
``"kernel"`` (the hand-written CUDA kernels through ``kernels.ops``); the
JAX name ``"pallas"`` maps to ``"kernel"``.  ``dtype`` is a
``torch.dtype``; :meth:`to_dict` writes it by name as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

BLOCK_KINDS = ("attn", "attn_dense", "local", "cross", "attn_cross", "mamba", "rglru")
ATTN_BACKENDS = ("einsum", "kernel")
_BACKEND_ALIASES = {"pallas": "kernel"}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ReCalKVRuntime:
    """Runtime shape info for a latent (compressed) KV cache.

    ``rank_k``/``rank_v`` are the uniform ranks; ``ranks_by_layer`` holds
    per-layer (rank_k, rank_v) when Fisher allocation varied them ((0, 0)
    for attention-free layers)."""

    rank_k: int
    rank_v: int
    group_size: int = 4
    ranks_by_layer: tuple[tuple[int, int], ...] | None = None

    def num_groups(self, num_kv_heads: int) -> int:
        return num_kv_heads // self.slots(num_kv_heads)

    def slots(self, num_kv_heads: int) -> int:
        """kv heads per latent group (``s``)."""
        return max(1, min(self.group_size, num_kv_heads))

    def ranks_for(self, layer_idx: int | None) -> tuple[int, int]:
        if layer_idx is not None and self.ranks_by_layer is not None:
            rk, rv = self.ranks_by_layer[layer_idx]
            if rk:
                return rk, rv
        return self.rank_k, self.rank_v


_NESTED_CONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "mamba": MambaConfig,
                   "rglru": RGLRUConfig}
_DTYPES_BY_NAME = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                   "float32": torch.float32}
_NAMES_BY_DTYPE = {v: k for k, v in _DTYPES_BY_NAME.items()}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[str, ...] = ("attn",)
    prefix_pattern: tuple[str, ...] = ()
    sliding_window: int | None = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_global: float | None = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    rglru: RGLRUConfig | None = None
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    cross_source_len: int = 0
    recalkv: ReCalKVRuntime | None = None
    attn_seq_shard: bool = False
    scan_layers: bool = True
    remat: bool = True
    attn_chunk: int = 512        # query-chunked einsum attention block
    attn_backend: str = "einsum"  # "einsum" reference | "kernel" CUDA kernels
    attn_block: int = 256
    cache_quant_bits: int | None = None
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        for k in self.layer_pattern + self.prefix_pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(
                f"attn_backend must be one of {ATTN_BACKENDS}, "
                f"got {self.attn_backend!r}")
        if self.cache_quant_bits is not None and self.recalkv is None:
            raise ValueError("cache_quant_bits requires a recalkv (latent) cache")
        if self.num_layers - len(self.prefix_pattern) < 0:
            raise ValueError("prefix longer than the model")

    # ---- layer layout -----------------------------------------------------

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.prefix_pattern)) // self.period

    @property
    def suffix_pattern(self) -> tuple[str, ...]:
        rem = (self.num_layers - len(self.prefix_pattern)) % self.period
        return self.layer_pattern[:rem]

    def expanded_layers(self) -> tuple[str, ...]:
        """Per-layer block kinds for the whole stack, in order."""
        return (self.prefix_pattern + self.layer_pattern * self.num_periods
                + self.suffix_pattern)

    def window_for(self, kind: str) -> int | None:
        if kind == "local":
            if self.sliding_window is None:
                raise ValueError("'local' blocks need cfg.sliding_window")
            return self.sliding_window
        return None

    def cache_len(self, kind: str, seq_len: int) -> int:
        w = self.window_for(kind)
        return seq_len if w is None else min(w, seq_len)

    # ---- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-serializable form with the JAX package's field names and
        values (dtype by name)."""
        d = dataclasses.asdict(self)
        d["dtype"] = _NAMES_BY_DTYPE[self.dtype]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        d = dict(d)
        d["dtype"] = _DTYPES_BY_NAME[d["dtype"]]
        backend = d.get("attn_backend", "einsum")
        d["attn_backend"] = _BACKEND_ALIASES.get(backend, backend)
        for key, sub in _NESTED_CONFIGS.items():
            if d.get(key) is not None:
                d[key] = sub(**d[key])
        if d.get("recalkv") is not None:
            rt = dict(d["recalkv"])
            if rt.get("ranks_by_layer") is not None:
                rt["ranks_by_layer"] = tuple(
                    (int(rk), int(rv)) for rk, rv in rt["ranks_by_layer"])
            d["recalkv"] = ReCalKVRuntime(**rt)
        for key in ("layer_pattern", "prefix_pattern"):
            d[key] = tuple(d[key])
        return cls(**d)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configurations the port's model
    functions do not cover yet (see ROADMAP.md, Queue 1)."""
    missing = []
    if cfg.recalkv is None:
        missing.append("dense (uncompressed) KV cache")
    if cfg.cache_quant_bits is not None:
        missing.append(f"int{cfg.cache_quant_bits} latent cache")
    for name in ("moe", "mla", "mamba", "rglru"):
        if getattr(cfg, name) is not None:
            missing.append(name)
    if cfg.encoder_decoder:
        missing.append("encoder-decoder")
    kinds = sorted(set(cfg.expanded_layers()) - {"attn"})
    if kinds:
        missing.append(f"block kinds {kinds}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")
